"""The port's sharded train step (``runtime.steps.train_step`` under a mesh)
on gloo ranks on the CPU.

* On a 2 × 2 ("data", "model") world, three steps of reservoir_lm's smoke
  config from the JAX package's numpy state are held to the reference's
  unsharded ``train_step``, at the tolerances of
  tests/test_torch_lm_train.py: loss, ce, z-loss, grad norm and lr within
  2e-5, the moments within 1e-5 of each leaf's largest, the params within
  1e-5 of each leaf's largest but for elements whose reference gradient is
  at round-off level (bounded by 2·Σlr).  Each microbatch's rows are split
  over the two data ranks, and the gradients summed over them.
* On a (1, 2) world (storage sharding only: both ranks see every row) the
  three steps are bitwise the port's unsharded step's, params, moments and
  metrics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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


def _sharded_rank(rank, shape, host, batches, with_plain):
    cfg = _cfg()
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    full = convert.train_state_from_reference(host, device="cpu")
    state = sharding.tree_shard(full, steps.state_pspecs(cfg, mesh), mesh)
    plain = convert.train_state_from_reference(host, device="cpu")
    out = []
    for batch in batches:
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        with sharding.use_mesh(mesh), sharding.record_collectives() as events:
            state, metrics = steps.train_step(cfg, AdamWConfig(**OPT), state, tb)
        rec = {"metrics": {k: float(v) for k, v in metrics.items()},
               "state": _gathered(state, cfg, mesh), "events": len(events),
               "local_numel": sum(t.numel() for t in tree_leaves(state["params"]))}
        if with_plain:
            plain, pm = steps.train_step(cfg, AdamWConfig(**OPT), plain, tb)
            rec["plain"] = {"metrics": {k: float(v) for k, v in pm.items()},
                            "state": {name: [t.detach().clone() for t in tree_leaves(tree)]
                                      for name, tree in (("params", plain["params"]),
                                                         ("m", plain["opt"]["m"]),
                                                         ("v", plain["opt"]["v"]))}}
        out.append(rec)
    return out


def _batches(cfg):
    return CS.lm_train_batches(cfg, 3, BATCH, 7)


def test_sharded_step_on_2x2_matches_the_reference_over_three_steps(tmp_path):
    cfg, jcfg = _cfg(), dataclasses.replace(jsmoke_config("reservoir_lm"), microbatches=M)
    host = _host_state(cfg)
    batches = _batches(cfg)
    ranks = run_ranks(_sharded_rank, 4, store_dir=str(tmp_path),
                      args=((2, 2), host, batches, False), timeout=120)
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
    # each rank stores its shards only: a quarter or a half of most leaves
    n_full = sum(int(np.prod(np.shape(w))) for _, w in convert_paths(host))
    assert ranks[0][0]["local_numel"] < n_full / 2


def convert_paths(host):
    """(path, leaf) of the params of a numpy train state, in leaf order."""
    from repro_torch.optim.adamw import tree_leaves_with_path

    return tree_leaves_with_path(host["params"])


def test_sharded_step_on_1x2_is_bitwise_the_unsharded_step(tmp_path):
    cfg = _cfg()
    ranks = run_ranks(_sharded_rank, 2, store_dir=str(tmp_path),
                      args=((1, 2), _host_state(cfg), _batches(cfg), True), timeout=120)
    for rank_out in ranks:
        for got in rank_out:
            assert got["metrics"] == got["plain"]["metrics"]
            for name in ("params", "m", "v"):
                for a, b in zip(tree_leaves(got["state"][name]),
                                tree_leaves(got["plain"]["state"][name]), strict=True):
                    np.testing.assert_array_equal(a, b)
            assert got["events"] > 0
