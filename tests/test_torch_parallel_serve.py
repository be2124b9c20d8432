"""The port's sharded serving (``runtime.steps.serve_prefill`` /
``serve_decode`` under a mesh, ``parallel.sharding.Plan``) on gloo
ranks on the CPU, against the JAX package's unsharded serving steps.

One spawn a mesh ((1, 2), (2, 1), (2, 2), (1, 4);
``torch_parallel_serve_ranks.serve_rank``) serves every arch of ARCHS at
its smoke config: the reference's numpy params carried across by
``convert.lm_params_from_reference`` and cut by ``tree_shard``, each rank
its rows of the prompts (batch 2; on (2, 1) batch 1 as well for
BATCH_ONE, where the batch cannot shard and the attention caches'
sequence goes over "data"), a prefill of PROMPT tokens then DECODES decode
steps of the given tokens.
In (1, 4) the smoke configs' 2 kv heads do not divide "model", so the
attention caches are cut along the sequence over "model".  The spawn's
results are shared by the tests of its mesh.

* Each rank's logits are within LOGIT_TOL (1e-5, tests/test_torch_lm_model.py)
  of the reference's rows (xlstm's within twice the reference's own spread
  under a ±2e-7 weight nudge where that is larger: its sLSTM is chaotic at
  the smoke init, and tensor parallelism reorders its sums); the caches,
  gathered from every rank's blocks, within LOGIT_TOL of the reference's,
  the recurrent states (Mamba's, mLSTM's, sLSTM's) also within STATE_RTOL
  of their buffer's largest |value|.  A recurrent state sums the whole prefix of a residual stream
  that tensor parallelism rounds in another order, so a rounding gap
  reaches every element at the buffer's scale, not at each element's own:
  on jamba's deepest Mamba h the sharded route is 1.9e-5 from the
  reference where the unsharded port is 1.0e-5 (values up to 8.7), and an
  element-wise STATE_RTOL fails on a few small elements.  Greedy ids are
  identical on every rank.
* The caches are allocated as this rank's blocks: each buffer has the
  shape the reference's ``cache_pspecs`` imply.
* No rank gathers the whole param tree (``sharding.tree_gather`` raises
  while the ranks serve), and the all-gathered bytes of a decode step are
  exactly the plan's: each leaf's gathers at its block, once each, the
  logits' vocab columns, and the activations the plan gathers (q heads
  before a sequence-sliced cache, Mamba's ``in_proj`` product, the mLSTM's
  ``up_proj`` product, the sLSTM's pre-activations, output and cache m).
* ``launch.serve.main`` on two ranks gives the one-process launcher's ids.
* ``sharding.use_labels`` on the pod mesh: each leaf "local" or
  "gathered" as the plan in ``parallel/sharding.py``'s doc says.
"""

import concurrent.futures
import functools
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_model import LOGIT_TOL, STATE_RTOL, chip_smoke
from torch_parallel_serve_ranks import launch_rank, serve_rank

from repro.compat import abstract_mesh
from repro.configs import smoke_config as jsmoke_config
from repro.models import init_cache as jinit_cache
from repro.parallel import sharding as jsharding
from repro.runtime import steps as jsteps
from repro_torch import configs
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import param_logical_axes
from repro_torch.parallel import sharding

ARCHS = ["reservoir_lm", "granite-8b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "xlstm-1.3b",
         "llama-3.2-vision-11b", "seamless-m4t-medium"]
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
PROMPT, DECODES = 7, 3
# xlstm's sLSTM is chaotic at its smoke init (r_rec drawn at 1/sqrt(heads)):
# its logits are held to twice the reference's own spread under the weight
# nudge of tests/test_torch_lm_train_archs.py where that passes LOGIT_TOL
SPREAD_ARCHS = ("xlstm-1.3b",)
NUDGE, NUDGE_SEED = 2e-7, 99
MAX_LEN = 12                     # divides into the slices of every mesh's sequence axes
AXES = ("data", "model")
TP_AXES = ("heads", "kv", "mlp", "vocab", "expert")

CS = chip_smoke()


# batch 1 on (2, 1): the long-context layout (each attention cache's
# sequence over "data"), on the long_500k archs and a cross-attention one
BATCH_ONE = ["reservoir_lm", "granite-8b", "jamba-v0.1-52b", "xlstm-1.3b",
             "llama-3.2-vision-11b"]


def _cases(shape):
    return [(arch, 2) for arch in ARCHS] + ([(arch, 1) for arch in BATCH_ONE]
                                            if shape == (2, 1) else [])


@functools.cache
def _inputs(arch, batch):
    """(numpy params, tokens, context) of a case."""
    cfg = configs.smoke_config(arch)
    ctx = CS.lm_context(cfg, 2, 2)
    return (CS.lm_numpy_params(cfg, 0), CS.lm_tokens(cfg, (2, PROMPT + DECODES), 1)[:batch],
            None if ctx is None else ctx[:batch])


def _run_reference(arch, batch, nudge=False):
    jcfg = jsmoke_config(arch)
    host, toks, ctx = _inputs(arch, batch)
    jp = jax.tree.map(jnp.asarray, host)
    if nudge:
        rng = np.random.default_rng(NUDGE_SEED)
        jp = jax.tree.map(lambda a: jnp.asarray(
            a * (1 + NUDGE * rng.choice((-1.0, 1.0), a.shape)), jnp.float32), host)
    prefill = jax.jit(lambda p, t, c: jsteps.serve_prefill(jcfg, p, t, c, max_len=MAX_LEN))
    decode = jax.jit(lambda p, c, t: jsteps.serve_decode(jcfg, p, c, t))
    logit, cache = prefill(jp, jnp.asarray(toks[:, :PROMPT], jnp.int32),
                           None if ctx is None else jnp.asarray(ctx))
    logits = [np.asarray(logit)]
    for i in range(PROMPT, PROMPT + DECODES):
        logit, cache = decode(jp, cache, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        logits.append(np.asarray(logit))
    return logits, jax.tree.map(np.asarray, cache["units"])


@functools.cache
def _pool():
    return concurrent.futures.ThreadPoolExecutor(max_workers=1)


@functools.cache
def _reference_future(arch, batch, nudge=False):
    return _pool().submit(_run_reference, arch, batch, nudge)


def _reference(arch, batch):
    """The reference's unsharded serve of a case: (the logits of the
    prefill and of each decode step, the final cache).  Computed in a
    worker thread while the ranks serve (``_served`` submits it)."""
    return _reference_future(arch, batch).result()


@functools.cache
def _served(shape):
    for mesh in MESHES:                       # the reference runs while the ranks serve
        for arch, batch in _cases(mesh):
            _reference_future(arch, batch)
            if arch in SPREAD_ARCHS:
                _reference_future(arch, batch, nudge=True)
    cases = [(arch, batch, *_inputs(arch, batch)) for arch, batch in _cases(shape)]
    with tempfile.TemporaryDirectory() as store:
        ranks = run_ranks(serve_rank, math.prod(shape), store_dir=store,
                          args=(shape, cases, PROMPT, DECODES, MAX_LEN), timeout=240)
    return {case: [r[i] for r in ranks] for i, case in enumerate(_cases(shape))}


def _rows(shape, rank, batch):
    """The rows of a batch rank ``rank`` of the ``shape`` mesh holds."""
    d = divmod(rank, shape[1])[0]
    if batch % shape[0]:
        return slice(0, batch)
    n = batch // shape[0]
    return slice(d * n, (d + 1) * n)


def _logit_tol(arch, batch) -> float:
    """LOGIT_TOL, or for SPREAD_ARCHS twice the reference's own logit
    spread under a ±NUDGE relative nudge of every weight where that is
    larger."""
    if arch not in SPREAD_ARCHS:
        return LOGIT_TOL
    ref, nudged = _reference(arch, batch)[0], _reference_future(arch, batch, True).result()[0]
    return max(LOGIT_TOL, 2 * max(float(np.abs(a - b).max()) for a, b in zip(ref, nudged)))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_serving_logits_and_ids_match_the_reference(shape):
    for (arch, batch), ranks in _served(shape).items():
        ref = _reference(arch, batch)[0]
        tol = _logit_tol(arch, batch)
        for rank, got in enumerate(ranks):
            rows = _rows(shape, rank, batch)
            assert len(got["logits"]) == 1 + DECODES
            for step, (t, j) in enumerate(zip(got["logits"], ref, strict=True)):
                assert t.shape == (rows.stop - rows.start, j.shape[-1])
                np.testing.assert_allclose(t, j[rows], atol=tol, rtol=0,
                                           err_msg=f"{arch} batch {batch} rank {rank} "
                                                   f"step {step}")
            np.testing.assert_array_equal(got["ids"], ranks[0]["ids"])
        # the greedy ids are the reference's wherever its top two differ by more than the tolerance
        ref_ids = np.stack([j.argmax(-1) for j in ref], axis=1)
        top2 = np.stack([np.sort(j, -1)[:, -2:] for j in ref], axis=1)
        decided = (top2[..., 1] - top2[..., 0]) > 2 * tol
        np.testing.assert_array_equal(ranks[0]["ids"][decided], ref_ids[decided])


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_serving_caches_gather_to_the_references(shape):
    for (arch, batch), ranks in _served(shape).items():
        cfg = configs.smoke_config(arch)
        ref = _reference(arch, batch)[1]
        for got in ranks:
            for blk, tu, ju in zip(cfg.unit, got["cache"], ref, strict=True):
                rtol = STATE_RTOL if blk.mixer in ("mamba", "mlstm", "slstm") else 0.0
                for t, j in zip(tu, ju, strict=True):
                    j = np.asarray(j, np.float32)
                    assert t.shape == j.shape, (arch, blk)
                    np.testing.assert_allclose(t, j, atol=LOGIT_TOL + rtol * np.abs(j).max(),
                                               rtol=0, err_msg=f"{arch} {blk}")


def _reference_cache_specs(arch, shape, batch):
    jcfg = jsmoke_config(arch)
    mesh = abstract_mesh(shape, AXES)
    ctx = jcfg.n_context_tokens
    shapes = jax.eval_shape(lambda: jinit_cache(jcfg, batch, MAX_LEN, context_len=ctx))
    return shapes, jsharding.cache_pspecs(jcfg, mesh, shapes)


def _blocks(entry, sizes):
    return math.prod(sizes[a] for a in _axes(entry))


@pytest.mark.parametrize("shape", MESHES)
def test_caches_are_allocated_as_the_references_specs_cut_them(shape):
    sizes = dict(zip(AXES, shape))
    for (arch, batch), ranks in _served(shape).items():
        shapes, specs = _reference_cache_specs(arch, shape, batch)
        want = []
        for entry, entry_specs in zip(shapes["units"], specs["units"], strict=True):
            for leaf, spec in zip(entry, entry_specs, strict=True):
                dims = list(leaf.shape)
                for i, e in enumerate(spec):
                    dims[i] //= _blocks(e, sizes)
                want.append(tuple(dims))
        for got in ranks:
            assert got["shapes"] == want, arch
        seq = [spec[0][2] for blk, spec in zip(jsmoke_config(arch).unit, specs["units"])
               if blk.mixer in ("attn", "cross_attn")]
        assert [_axes(e) for e in ranks[0]["seq_entries"]] == [_axes(e) for e in seq], arch
    # the layouts the meshes exercise: 2 kv heads on a 4-wide "model" axis
    # slice the sequence over it; batch 1 slices it over "data"
    served = _served(shape)
    if shape == (1, 4):
        assert served[("granite-8b", 2)][0]["seq_entries"] == [("model",)]
    if shape == (2, 1):
        assert served[("granite-8b", 1)][0]["seq_entries"] == [("data",)]


def _axes(entry) -> tuple:
    """A spec entry's axes (JAX writes a one-axis tuple as the axis)."""
    return tuple(entry) if isinstance(entry, (tuple, list)) else ((entry,) if entry else ())


def _leaf_gather_bytes(arch, shape):
    """(the bytes the all-gathers of the plan's leaves return in one step,
    the bytes of those leaves as their blocks use them): each leaf, stored
    under the reference's ``param_pspecs``, gathered at its block over
    every axis but the "model" entry a TP block keeps (dims in order, an
    entry's axes last first, one-rank axes skipped)."""
    jcfg = jsmoke_config(arch)
    from repro.models.model import param_logical_axes

    sizes = dict(zip(AXES, shape))
    specs = jsharding.param_pspecs(jcfg, abstract_mesh(shape, AXES))
    axes = param_logical_axes(jcfg)
    params = CS.lm_numpy_params(configs.smoke_config(arch), 0)
    total = held = 0

    def leaf(arr, spec, logical, whole):
        nonlocal total, held
        cur = first = 4 * arr.size // math.prod(_blocks(e, sizes) for e in spec)
        for entry, ax in zip(spec, logical, strict=True):
            if entry == "model" and ax in TP_AXES and not whole:
                continue
            for a in reversed(_axes(entry)):
                if sizes[a] > 1:
                    cur *= sizes[a]
                    total += cur
        held += cur if cur > first else 0

    def flat(tree_p, tree_s, tree_a, kind=None):
        # the router and the mLSTM's gate biases are used whole, and so is
        # every leaf of an mLSTM whose d_in "model" does not divide
        replicated = kind == "mlstm" and (jcfg.d_model * jcfg.mlstm_expand) % shape[1] != 0
        for name, arr in tree_p.items():
            whole = name in ("mlp/router", "mixer/b_i", "mixer/b_f") or (
                replicated and name.startswith("mixer/"))
            leaf(arr, tree_s[name], tree_a[name], whole)

    flat(params["embed"], specs["embed"], axes["embed"])
    flat(params["final_norm"], specs["final_norm"], axes["final_norm"])
    for p, s, a, blk in zip(params["units"], specs["units"], axes["units"], jcfg.unit):
        flat(p, s, a, blk.mixer)
    return total, held


def _activation_gather_bytes(arch, shape, batch):
    """The bytes the plan's activation all-gathers return in one decode
    step: the logits' vocab columns, q heads before a cache sliced over
    "model", Mamba's ``in_proj`` product, the mLSTM's ``up_proj`` product,
    the sLSTM's pre-activations and, where "model" divides its heads, its
    output and the cache's m, else its c, n, h cache blocks."""
    cfg = configs.smoke_config(arch)
    d, m = shape
    if m == 1:
        return 0
    rows = batch // d if batch % d == 0 else batch
    f = 4 * rows * cfg.n_units
    total = 4 * rows * cfg.vocab_size if cfg.vocab_size % m == 0 else 0
    s_div = m * (d if batch % d else 1)
    for blk in cfg.unit:
        length = MAX_LEN if blk.mixer == "attn" else cfg.n_context_tokens
        if blk.mixer in ("attn", "cross_attn") and cfg.n_kv_heads % m and \
                cfg.n_heads % m == 0 and length % s_div == 0:
            total += f * cfg.n_heads * cfg.head_dim
        if blk.mixer == "mamba":
            d_in = cfg.d_model * cfg.mamba_expand
            total += f * 2 * d_in if (2 * d_in) % m == 0 else 0
        if blk.mixer == "mlstm":
            d_in = cfg.d_model * cfg.mlstm_expand
            total += f * 2 * d_in if d_in % m == 0 else 0
        if blk.mixer == "slstm":
            d = cfg.d_model
            total += f * 4 * d if (4 * d) % m == 0 else 0
            if cfg.n_heads % m == 0:
                total += f * (d + cfg.n_heads)
            elif d % m == 0:
                total += f * 3 * d
    return total


@pytest.mark.parametrize("shape", MESHES)
def test_a_decode_step_gathers_the_plans_leaves_once_and_no_whole_tree(shape):
    for (arch, batch), ranks in _served(shape).items():
        leaves, held = _leaf_gather_bytes(arch, shape)
        assert held < 4 * sum(a.size for a in jax.tree.leaves(_inputs(arch, batch)[0]))
        want = leaves + _activation_gather_bytes(arch, shape, batch)
        for got in ranks:
            assert got["gathered_bytes"] == want, (arch, batch)


def test_the_launcher_on_two_ranks_gives_the_one_process_launchers_ids(tmp_path, capsys):
    from repro_torch.launch import serve

    argv = ["--device", "cpu", "--arch", "jamba-v0.1-52b", "--requests", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    two = run_ranks(launch_rank, 2, store_dir=str(tmp_path), args=(argv,), timeout=120)
    one = serve.main(argv)
    assert one.shape == (2, 4)
    np.testing.assert_array_equal(two[0], one)
    np.testing.assert_array_equal(two[1], one)
    assert "ranks=1" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["reservoir_lm", "granite-8b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "xlstm-1.3b"])
def test_the_serving_plan_labels_each_leaf_as_its_block_uses_it(arch):
    """On the 16 × 16 pod mesh at full width: a leaf is "local" where its
    block computes over its "model" block (heads, kv, mlp, vocab, expert),
    else "gathered" (a leaf no axis shards is stored whole: "local"); the
    router and the mLSTM's gate biases keep no "model" block although their
    axes are TP axes; xlstm's mLSTM leaves keep their d_in block, the
    sLSTM's ``w_in`` and ``bias`` their columns, its ``r_rec`` (4 heads on
    16) is stored whole and its gated projection (f = 2730) gathered; each
    use keeps at most a "model" entry, and only on a TP axis."""
    cfg = configs.get_config(arch)
    mesh = sharding.AbstractMesh((16, 16), AXES)
    specs, uses = sharding.param_pspecs(cfg, mesh), sharding.use_pspecs(cfg, mesh)
    labels = sharding.use_labels(cfg, mesh)
    axes = param_logical_axes(cfg)
    for pos, blk in enumerate(cfg.unit):
        for name, label in labels["units"][pos].items():
            spec, use, logical = (t["units"][pos][name] for t in (specs, uses, axes))
            kept = [ax for e, ax in zip(use, logical, strict=True) if e == "model"]
            assert all(e in (None, "model") for e in use)
            assert label == ("local" if kept else "gathered") or not any(spec), (name, label)
            assert all(ax in TP_AXES for ax in kept)
            if name in ("mlp/router", "mixer/b_i", "mixer/b_f"):
                assert not kept and (label == "gathered" or not any(spec)), name
            if name.startswith("norm_") or name.startswith("mixer/readout") or \
                    (name == "mixer/w_in" and blk.mixer == "reservoir"):
                assert label == "gathered", name
            if blk.mixer == "mlstm" and name.startswith("mixer/") and \
                    name not in ("mixer/b_i", "mixer/b_f"):
                assert kept == ["mlp"] and label == "local", name
            if blk.mixer == "slstm" and name.startswith("mixer/"):
                want = {"mixer/w_in": "local", "mixer/bias": "local", "mixer/r_rec": "local"}
                assert label == want.get(name, "gathered"), name
                assert (kept == ["mlp"]) == (name in ("mixer/w_in", "mixer/bias")), name
                if name == "mixer/r_rec":
                    assert not any(spec), spec                 # stored whole
    assert labels["embed"]["embedding"] == "local"          # vocab-parallel
    if arch == "granite-8b":                                # 8 kv heads on a 16-wide axis
        unit = labels["units"][0]
        assert (unit["mixer/wq"], unit["mixer/wk"], unit["mlp/wi_gate"]) == \
            ("local", "gathered", "local")
