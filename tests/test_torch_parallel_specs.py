"""The port's sharding rules (``repro_torch.parallel.sharding``), logical
axes and input stand-ins against the JAX package's, on shape-only meshes.

Exact: a spec is a tuple of axis names, so the port's must equal the
reference's entry for entry (a single-name entry and a one-name tuple
compare equal, as do an empty tuple and None, and trailing unsharded dims
are not written); axes, shapes
and dtypes likewise.  Counterparts of tests/test_sharding.py, plus the
port's shard arithmetic (``fit_spec``, ``shard_count``) and the no-mesh
behaviour of ``maybe_shard``.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.compat import abstract_mesh
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs, runnable_cells
from repro.models import param_logical_axes as jparam_logical_axes
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_config, input_specs
from repro_torch.models import init_params, param_logical_axes
from repro_torch.models.model import meta_params
from repro_torch.optim.adamw import tree_leaves_with_path
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import AbstractMesh, P

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_archs(include_extras=True)
CELLS = [(a, s) for a in ARCHS for s in runnable_cells(a)]


def _entry(e):
    if e is None or e == ():
        return None
    return tuple(e) if isinstance(e, tuple) else (e,)


def _spec(spec) -> tuple:
    """A spec as a tuple of entries, each None or a tuple of names, with
    trailing Nones dropped."""
    out = [_entry(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat(tree, path="", leaf=lambda x: isinstance(x, (P, JP))):
    """(path, leaf) in the reference's order (dict keys sorted, sequences
    in order)."""
    if leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}[{k!r}]", leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{path}[{i}]", leaf)]
    return [(path, tree)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_param_pspecs_equal_the_references(arch, mesh):
    want = _flat(jsharding.param_pspecs(jget_config(arch), abstract_mesh(*MESHES[mesh])))
    got = _flat(sharding.param_pspecs(get_config(arch), AbstractMesh(*MESHES[mesh])))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want, strict=True):
        assert _spec(g) == _spec(w), (arch, path, g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_axes_equal_the_references(arch):
    def is_axes(x):
        return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)

    want = _flat(jparam_logical_axes(jget_config(arch)), leaf=is_axes)
    got = _flat(param_logical_axes(get_config(arch)), leaf=is_axes)
    assert got == want


def test_param_shapes_come_from_the_defs_without_a_draw():
    """``meta_params`` (what ``param_pspecs`` walks) has ``init_params``'s
    tree, shapes and dtypes, and holds no memory."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("jamba-v0.1-52b")
    drawn = tree_leaves_with_path(init_params(cfg, torch.Generator().manual_seed(0),
                                              device="cpu"))
    meta = tree_leaves_with_path(meta_params(cfg))
    assert [(p, t.shape, t.dtype) for p, t in drawn] == \
        [(p, t.shape, t.dtype) for p, t in meta]
    assert all(t.device.type == "meta" for _, t in meta)


def test_fsdp_fallback_shards_big_dims():
    """starcoder2 (24 heads): the embed dim picks up ("data", "model")."""
    args = (("embed", "heads", "hd"), (3072, 24, 128))
    got = sharding.spec_for(*args, AbstractMesh(*MESHES["pod"]), "fsdp")
    want = jsharding.spec_for(*args, abstract_mesh(*MESHES["pod"]), "fsdp")
    assert _spec(got) == _spec(want) == ((("data", "model")),)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("kw", [{}, {"strategy": "zero3"}, {"batch": 2}, {"batch": 1},
                                {"strategy": "zero3", "batch": 64}, {"rank": 3}])
def test_batch_pspec_equals_the_references(mesh, kw):
    got = sharding.batch_pspec(AbstractMesh(*MESHES[mesh]), **kw)
    want = jsharding.batch_pspec(abstract_mesh(*MESHES[mesh]), **kw)
    assert _spec(got) == _spec(want)


@pytest.mark.parametrize("arch,shape", [
    ("granite-8b", "decode_32k"),       # kv=8 not divisible -> seq over model
    ("gemma-7b", "decode_32k"),         # kv=16 divisible -> kv over model
    ("jamba-v0.1-52b", "long_500k"),    # batch 1 -> seq over data+model
    ("xlstm-1.3b", "long_500k"),        # recurrent states shard inner dims
    ("reservoir_lm", "long_500k"),      # the reservoir's (s_prev, s_last)
])
def test_cache_pspecs_equal_the_references(arch, shape):
    jcache = jinput_specs(jget_config(arch), shape)["cache"]
    want = jsharding.cache_pspecs(jget_config(arch), abstract_mesh(*MESHES["pod"]), jcache)
    cache = input_specs(get_config(arch), shape)["cache"]
    got = sharding.cache_pspecs(get_config(arch), AbstractMesh(*MESHES["pod"]), cache)
    assert _spec(got["pos"]) == _spec(want["pos"]) == ()
    g, w = _flat(got["units"]), _flat(want["units"])
    assert len(g) == len(w)
    for (path, a), (_, b) in zip(g, w):
        assert _spec(a) == _spec(b), (path, a, b)


def test_data_pspecs_equal_the_references():
    for arch, shape in [("llama-3.2-vision-11b", "train_4k"), ("granite-8b", "prefill_32k"),
                        ("gemma-7b", "decode_32k")]:
        got = sharding.data_pspecs(get_config(arch), AbstractMesh(*MESHES["multipod"]),
                                   input_specs(get_config(arch), shape))
        want = jsharding.data_pspecs(jget_config(arch), abstract_mesh(*MESHES["multipod"]),
                                     jinput_specs(jget_config(arch), shape))
        assert sorted(got) == sorted(want)
        for k in got:
            if k == "cache":
                assert [_spec(s) for _, s in _flat(got[k]["units"])] == \
                    [_spec(s) for _, s in _flat(want[k]["units"])]
            else:
                assert _spec(got[k]) == _spec(want[k]), (arch, k)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_references(arch, shape):
    """Every runnable cell's stand-ins: the same keys, shapes and dtypes
    (the decode cache leaf for leaf), as ``meta`` tensors."""
    want = jinput_specs(jget_config(arch), shape)
    got = input_specs(get_config(arch), shape)
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "cache":
            g = [t for entry in got[k]["units"] for t in entry]
            w = jax.tree_util.tree_leaves(want[k]["units"])
            assert got[k]["pos"] == 0 and want[k]["pos"].shape == ()
        else:
            g, w = [got[k]], [want[k]]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), (k, a.shape, b.shape)
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), (k, a.dtype, b.dtype)


def test_fit_spec_and_shard_counts():
    mesh = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert sharding.fit_spec(mesh, (16, 3), ("pod", "data")) == P(("pod", "data"))
    # the running product must divide: pod (2) then data (2·4 ∤ 4): pod alone
    assert sharding.fit_spec(mesh, (4,), ("pod", "data")) == P(("pod",))
    # as batch_axes skips an axis that does not divide and goes on
    assert sharding.fit_spec(mesh, (12,), ("data", "model")) == P(("data",))
    assert sharding.fit_spec(mesh, (3,), ("pod", "data")) == P(None)
    assert sharding.fit_spec(AbstractMesh((4,), ("data",)), (8,), ("pod", "data")) == \
        P(("data",))
    assert [sharding.shard_count(e, mesh) for e in P(("pod", "data"), "model", None)] == \
        [8, 2, 1]
    assert sharding.spec_leaves({"b": P("data"), "a": (P(), None, P(None, "model"))}) == \
        [P(), P(None, "model"), P("data")]


def test_maybe_shard_is_a_no_op_without_a_mesh_and_only_then():
    x = torch.arange(8.0)
    assert sharding.maybe_shard(x, ("pod", "data")) is x
    assert sharding.active_mesh() is None
    mesh = AbstractMesh((2,), ("data",))
    with sharding.use_mesh(mesh):
        assert sharding.active_mesh() is mesh
        with pytest.raises(TypeError, match="DeviceMesh"):
            sharding.maybe_shard(x, ("pod", "data"))   # a shape-only mesh holds no rank
    assert sharding.active_mesh() is None
