"""One sharded ``train_step`` (``runtime.steps.train_step`` under a mesh:
Megatron tensor parallelism over "model", each unit's leaves gathered as
it runs, the gradients back as each rank's blocks) of every arch that
tests/test_torch_parallel_serve.py serves, on gloo ranks on the CPU,
against the JAX package's unsharded ``train_step``.

One spawn a mesh ((1, 2) at the smoke configs' remat "none", (2, 2) at
remat "full", so every unit's recompute gathers again;
``torch_parallel_train_ranks.train_rank``) steps every arch from the same
numpy state and batch (2 × 10 tokens, and stub context) as
tests/test_torch_lm_train_archs.py, at its tolerances: loss, grad norm
and MoE aux within 2e-5 relative, each leaf's first moment within 1e-5 of
its largest (the second, a square, within twice that), or within twice
the reference's own gradient spread under a ±2e-7 weight nudge where that
is larger (jamba and xlstm).  A first moment is the clipped gradient
times 1 - beta1, so it holds each leaf's gradient.  No rank gathers the
whole tree (``sharding.tree_gather`` raises while the ranks step), each
stores less than the whole, and on (2, 2) the gradients arrive by
reduce-scatter over "data".
"""

import concurrent.futures
import functools
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_lm_train import CS, GRAD_TOL, MOMENT_TOL, _ref_grads, _rel_err
from test_torch_parallel_serve import ARCHS
from torch_parallel_train_ranks import train_rank

from repro.configs import smoke_config as jsmoke_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import steps as jsteps
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.optim.adamw import tree_leaves_with_path

MESHES = {(1, 2): "none", (2, 2): "full"}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
SPREAD_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")


@functools.cache
def _inputs(arch):
    """(numpy train state, numpy batch with any context) of an arch."""
    cfg = smoke_config(arch)
    host = CS.lm_train_state(CS.lm_numpy_params(cfg, 0))
    (batch,) = CS.lm_train_batches(cfg, 1, (2, 10), 4)
    ctx = CS.lm_context(cfg, 2, CS.LM_CONTEXT_SEED)
    return host, batch if ctx is None else {**batch, "context": ctx}


def _run_reference(arch):
    """The reference's unsharded step: its metrics and moments, and the
    tolerance (``GRAD_TOL``, or twice its own gradient spread)."""
    jcfg = jsmoke_config(arch)
    host, batch = _inputs(arch)
    jb = jax.tree.map(jnp.asarray, batch)
    tol = GRAD_TOL
    if arch in SPREAD_ARCHS:
        rng = np.random.default_rng(99)
        nudged = jax.tree.map(lambda a: jnp.asarray(
            a * (1 + 2e-7 * rng.choice((-1.0, 1.0), a.shape)), jnp.float32), host["params"])
        want = _ref_grads(jcfg, jax.tree.map(jnp.asarray, host["params"]), jb, 1)
        tol = max(tol, 2 * max(_rel_err(a, b) for a, b in
                               zip(_ref_grads(jcfg, nudged, jb, 1), want)))
    jstate, jm = jsteps.train_step(jcfg, JAdamWConfig(**OPT),
                                   jax.tree.map(jnp.asarray, host), jb)
    return {"metrics": {k: float(v) for k, v in jm.items()}, "tol": tol,
            **{k: [np.asarray(t) for t in jax.tree.leaves(jstate["opt"][k])]
               for k in ("m", "v")}}


@functools.cache
def _pool():
    return concurrent.futures.ThreadPoolExecutor(max_workers=1)


@functools.cache
def _reference_future(arch):
    return _pool().submit(_run_reference, arch)


@functools.cache
def _trained(shape):
    """Each arch's result on every rank of ``shape`` (the references run in
    a worker thread meanwhile)."""
    for arch in ARCHS:
        _reference_future(arch)
    cases = [(arch, MESHES[shape], *_inputs(arch)) for arch in ARCHS]
    with tempfile.TemporaryDirectory() as store:
        ranks = run_ranks(train_rank, math.prod(shape), store_dir=store,
                          args=(shape, cases, OPT), timeout=300)
    return {arch: [r[i] for r in ranks] for i, arch in enumerate(ARCHS)}


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_sharded_train_step_matches_the_reference(arch, shape):
    ranks = _trained(shape)[arch]
    ref = _reference_future(arch).result()
    host = _inputs(arch)[0]
    paths = [p for p, _ in tree_leaves_with_path(host["params"])]
    n_full = sum(np.size(a) for _, a in tree_leaves_with_path(host["params"]))
    tol = ref["tol"]
    for rank, got in enumerate(ranks):
        for k in ("loss", "grad_norm", "moe_aux"):
            bound = max(CS.LM_TRAIN_TOL, tol) * max(1.0, abs(ref["metrics"][k]))
            assert abs(got["metrics"][k] - ref["metrics"][k]) <= bound, (rank, k)
        assert got["metrics"]["tokens"] == ref["metrics"]["tokens"] == 20
        for name, factor in (("m", 1), ("v", 2)):
            for path, t, w in zip(paths, [a for _, a in tree_leaves_with_path(got[name])],
                                  ref[name], strict=True):
                assert _rel_err(t, w) <= factor * max(MOMENT_TOL, tol), (rank, name, path)
        assert got["local_numel"] < n_full
        kinds = {(e["kind"], e["axis"]) for e in got["events"]}
        if shape == (2, 2):
            assert ("reduce-scatter", "data") in kinds
