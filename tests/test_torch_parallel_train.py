"""The port's sharded train step (``runtime.steps.train_step`` under a mesh:
Megatron tensor parallelism over "model", each unit's leaves gathered as
it runs, the gradients back as each rank's blocks by reduce-scatter) on
gloo ranks on the CPU.

* On a 2 × 2 ("data", "model") world, three steps of reservoir_lm's smoke
  config from the JAX package's numpy state are held to the reference's
  unsharded ``train_step``, at the tolerances of
  tests/test_torch_lm_train.py: loss, ce, z-loss, grad norm and lr within
  2e-5, the moments within 1e-5 of each leaf's largest, the params within
  1e-5 of each leaf's largest but for elements whose reference gradient is
  at round-off level (bounded by 2·Σlr).  Each microbatch's rows are split
  over the two data ranks; the MLP and the vocab run tensor-parallel over
  the two model ranks, which the recorded collectives show.
* On a (1, 2) world (tensor parallelism alone: both ranks see every row)
  the same three steps are held to the reference at the same tolerances.
  Tensor parallelism sums each product's partial sums in another order,
  so the steps are no longer the unsharded step's bits.  Each rank stores
  only its blocks.
* The step never gathers the whole tree (``sharding.tree_gather`` raises
  while the ranks step); its all-gathers over the fsdp axes return each
  unit's leaves once a microbatch, and once more in a ``"full"``
  recompute, beside the final norm once, one collective a unit and axis;
  the gradients of the leaves gathered over "data" come back by one
  reduce-scatter a unit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_model import chip_smoke

from repro.configs import smoke_config as jsmoke_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import steps as jsteps
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import sharding
from repro_torch.runtime import steps

CS = chip_smoke()
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
M = 2
BATCH = (4 * M, 12)
MOMENT_TOL = 1e-5
PARAM_TOL = 1e-5
AMBIGUOUS = 1e-4


def _cfg():
    return dataclasses.replace(smoke_config("reservoir_lm"), microbatches=M)


def _host_state(cfg):
    return CS.lm_train_state(CS.lm_numpy_params(cfg, 0))


def _gathered(state, cfg, mesh):
    specs = steps.state_pspecs(cfg, mesh)
    return {"params": sharding.tree_gather(state["params"], specs["params"], mesh),
            "m": sharding.tree_gather(state["opt"]["m"], specs["params"], mesh),
            "v": sharding.tree_gather(state["opt"]["v"], specs["params"], mesh)}


def _refuse(*_args, **_kw):
    raise AssertionError("the train step gathered the whole param tree")


def _sharded_rank(rank, shape, host, batches, remat="none"):
    cfg = dataclasses.replace(_cfg(), remat=remat)
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    full = convert.train_state_from_reference(host, device="cpu")
    state = sharding.tree_shard(full, steps.state_pspecs(cfg, mesh), mesh)
    out = []
    for batch in batches:
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        whole, sharding.tree_gather = sharding.tree_gather, _refuse
        try:
            with sharding.use_mesh(mesh), sharding.record_collectives() as events:
                state, metrics = steps.train_step(cfg, AdamWConfig(**OPT), state, tb)
        finally:
            sharding.tree_gather = whole
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "state": _gathered(state, cfg, mesh), "events": [dict(e) for e in events],
                    "local_numel": sum(t.numel() for t in tree_leaves(state["params"]))})
    return out


def _batches(cfg):
    return CS.lm_train_batches(cfg, 3, BATCH, 7)


def _assert_matches_reference(ranks, host, batches):
    """Every rank's three steps against the reference's unsharded steps
    (the module doc's tolerances)."""
    jcfg = dataclasses.replace(jsmoke_config("reservoir_lm"), microbatches=M)
    jstate = jax.tree.map(jnp.asarray, host)
    paths = [p for p, _ in convert_paths(host)]
    ambiguous = {p: np.zeros(np.shape(w), bool) for p, w in convert_paths(host)}
    lr_sum = 0.0
    for i, batch in enumerate(batches):
        jb = jax.tree.map(jnp.asarray, batch)
        grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(jcfg, p, b)[0]))
        gsum = None
        for j in range(M):
            g = grad_fn(jstate["params"], jax.tree.map(
                lambda x: x.reshape(M, -1, *x.shape[1:])[j], jb))
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        for p, g in zip(paths, jax.tree.leaves(gsum)):
            g = np.asarray(g) / M
            ambiguous[p] |= np.abs(g) <= AMBIGUOUS * np.abs(g).max()
        jstate, jm = jax.jit(lambda st, b: jsteps.train_step(jcfg, JAdamWConfig(**OPT), st, b))(
            jstate, jb)
        lr_sum += float(jm["lr"])
        for rank_out in ranks:
            got = rank_out[i]
            for k in ("loss", "ce", "z_loss", "grad_norm", "lr"):
                assert abs(got["metrics"][k] - float(jm[k])) <= CS.LM_TRAIN_TOL, (i, k)
            assert got["metrics"]["tokens"] == float(jm["tokens"]) == BATCH[0] * BATCH[1]
            for name in ("m", "v"):
                for path, t, w in zip(paths, tree_leaves(got["state"][name]),
                                      jax.tree.leaves(jstate["opt"][name]), strict=True):
                    w = np.asarray(w)
                    assert np.abs(t - w).max() <= MOMENT_TOL * np.abs(w).max(), (name, path)
            for path, t, w in zip(paths, tree_leaves(got["state"]["params"]),
                                  jax.tree.leaves(jstate["params"]), strict=True):
                w = np.asarray(w)
                gap = np.abs(t - w)
                tight = PARAM_TOL * float(np.abs(w).max())
                assert float(gap[~ambiguous[path]].max(initial=0.0)) <= tight, path
                assert float(gap[ambiguous[path]].max(initial=0.0)) <= 2 * lr_sum, path


def _kinds(events) -> set:
    return {(e["kind"], e["axis"]) for e in events}


def test_sharded_step_on_2x2_matches_the_reference_over_three_steps(tmp_path):
    cfg = _cfg()
    host = _host_state(cfg)
    batches = _batches(cfg)
    ranks = run_ranks(_sharded_rank, 4, store_dir=str(tmp_path),
                      args=((2, 2), host, batches), timeout=120)
    _assert_matches_reference(ranks, host, batches)
    # each rank stores its shards only: a quarter or a half of most leaves
    n_full = sum(int(np.prod(np.shape(w))) for _, w in convert_paths(host))
    assert ranks[0][0]["local_numel"] < n_full / 2
    # tensor parallelism over "model" (g sums the MLP's and the vocab's
    # partial sums, f their inputs' gradients), rows and gradients over "data"
    for rank_out in ranks:
        for got in rank_out:
            assert {("all-reduce", "model"), ("all-gather", "data"), ("all-gather", "model"),
                    ("reduce-scatter", "data"), ("all-reduce", "data")} <= _kinds(got["events"])


def convert_paths(host):
    """(path, leaf) of the params of a numpy train state, in leaf order."""
    from repro_torch.optim.adamw import tree_leaves_with_path

    return tree_leaves_with_path(host["params"])


def test_sharded_step_on_1x2_is_bitwise_the_unsharded_step(tmp_path):
    """(1, 2): tensor parallelism alone, held to the reference at the
    (2, 2) test's tolerances; no longer bitwise the unsharded step, since
    tensor parallelism adds partial sums in another order."""
    cfg = _cfg()
    host = _host_state(cfg)
    batches = _batches(cfg)
    ranks = run_ranks(_sharded_rank, 2, store_dir=str(tmp_path),
                      args=((1, 2), host, batches), timeout=120)
    _assert_matches_reference(ranks, host, batches)
    n_full = sum(int(np.prod(np.shape(w))) for _, w in convert_paths(host))
    for rank_out in ranks:
        assert rank_out[0]["metrics"] == ranks[0][0]["metrics"]
        assert rank_out[0]["local_numel"] < n_full
        for got in rank_out:
            kinds = _kinds(got["events"])
            assert ("all-reduce", "model") in kinds and ("reduce-scatter", "data") not in kinds


def _gather_bytes(host, remat):
    """(the bytes a step's all-gathers return, their count, the bytes its
    reduce-scatters return, their count) on a 2 × 2 mesh: each leaf, stored
    under the reference's ``param_pspecs``, gathered over every axis its
    use drops (dims in order, an entry's axes last first) at each use: the
    unit's leaves once a microbatch, twice under "full" (the recompute
    gathers again), the final norm once; a subtree's k-th gathers over one
    axis are one collective.  Each "data" gather of the forward
    reduce-scatters its input's bytes (the reservoir's fixed ``w_in`` too:
    its zero gradient rides in the collective of the unit's other
    leaves)."""
    from repro.compat import abstract_mesh
    from repro.models.model import param_logical_axes
    from repro.parallel import sharding as jsharding

    jcfg = jsmoke_config("reservoir_lm")
    sizes = {"data": 2, "model": 2}
    specs = jsharding.param_pspecs(jcfg, abstract_mesh((2, 2), ("data", "model")))
    axes = param_logical_axes(jcfg)
    tp = ("heads", "kv", "mlp", "vocab", "expert")
    gathered = scattered = n_gathers = n_scatters = 0
    for path, uses in ((("units", 0), 2 if remat == "full" else 1), (("final_norm",), 1),
                       (("embed",), 1)):
        tree, name_specs, name_axes = host["params"], specs, axes
        for key in path:
            tree, name_specs, name_axes = tree[key], name_specs[key], name_axes[key]
        collectives = set()
        for name, arr in tree.items():
            spec, logical = name_specs[name], name_axes[name]
            cur = 4 * arr.size
            for entry in spec:
                cur //= math.prod(sizes[a] for a in _axes(entry))
            stage = 0
            for entry, ax in zip(spec, logical, strict=True):
                if entry == "model" and ax in tp:
                    continue
                for a in reversed(_axes(entry)):
                    if a == "data":
                        scattered += cur
                    collectives.add((stage, a))
                    stage += 1
                    cur *= sizes[a]
                    gathered += uses * cur
        n_gathers += uses * len(collectives)
        n_scatters += sum(a == "data" for _, a in collectives)
    return M * gathered, M * n_gathers, M * scattered, M * n_scatters


def _axes(entry) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else ((entry,) if entry else ())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_the_step_gathers_each_unit_as_it_runs_and_reduce_scatters_its_gradients(remat,
                                                                                  tmp_path):
    cfg = _cfg()
    host = _host_state(cfg)
    ranks = run_ranks(_sharded_rank, 4, store_dir=str(tmp_path),
                      args=((2, 2), host, _batches(cfg)[:1], remat), timeout=120)
    gathered, n_gathers, scattered, n_scatters = _gather_bytes(host, remat)
    for (got,) in ranks:
        events = got["events"]
        ag = [e for e in events if e["kind"] == "all-gather"]
        assert sum(e["bytes"] for e in ag) == gathered and len(ag) == n_gathers
        rs = [e for e in events if e["kind"] == "reduce-scatter"]
        assert {e["axis"] for e in rs} == {"data"} and sum(e["bytes"] for e in rs) == scattered
        assert len(rs) == n_scatters
