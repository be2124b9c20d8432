"""The composed-graph cells of chip_smoke.py's ``composed`` phase against
the JAX package (benchmarks/composed_reservoirs.py): the six topologies on
the memory-capacity probe, seeds 0..2.

The phase holds the card's K1/K3 run of each cell to the constants
recomputed here (to 1e-9): the reference pipeline's MC (``fast`` path and
its einsum fold, as the benchmark runs it; ``COMPOSED_REF_MC``) and the MC
of a float64 ridge at COMPOSED_F64_LAM on the reference's materialized
graph features (``COMPOSED_REF_MC_F64``).  The tolerances come from the
measurements here:

* the port on the CPU (K1's and K3's plain versions) against the reference:
  ≤ 5.2e-3 MC, and the exact Gram of the port's features solved by
  ``solve_gcv`` on the CPU ≤ 4.7e-3, within COMPOSED_HOST_MC_TOL (6e-3), in
  every cell but d1_l1_baseline; the reference's own MC moves by ≤ 2.7e-3
  there under a 2e-7 relative move of its inputs;
* d1_l1_baseline: the reference's own f32 MC moves by more than
  COMPOSED_MC_TOL when its inputs move by 2e-7 relative, its float64-ridge
  MC by under 1e-5 — so that cell's pipeline MC is not held;
* the float64-ridge MC on the port's states: within COMPOSED_F64_TOL.

COMPOSED_MC_TOL (0.02) holds the card's pipeline, whose f32 eigh is
cuSOLVER's, not the host LAPACK's that the reference runs: chip_smoke.py's
``composed`` phase measures the gap that eigh opens.
"""

import dataclasses
import functools
import importlib
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_stage_masks as jbuild_stage_masks
from repro.core import graph_states as jgraph_states
from repro.core import tasks as jtasks
from repro.core.metrics import memory_capacity_score
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro_torch.convert import graph_from_reference
from repro_torch.pipeline import Experiment
from test_torch_fig5 import chip_smoke, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("d1_l1_baseline", "d1_l2", "d2_l1", "d2_l2", "d3_l1", "d3_l2")


def reference_topologies():
    """benchmarks/composed_reservoirs.py's ``topologies()``."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("benchmarks.composed_reservoirs").topologies()


@functools.cache
def mc_batch(perturb: float = 0.0):
    """Seeds 0..COMPOSED_SEEDS-1 of the MC probe; ``perturb`` moves each
    train input by up to that relative amount (seeded)."""
    cs = chip_smoke()
    ds = [jtasks.memory_capacity(cs.MC_SAMPLES, max_delay=cs.MC_MAX_DELAY, seed=s)
          for s in range(cs.COMPOSED_SEEDS)]
    batch = [np.stack([getattr(d, f) for d in ds])
             for f in ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    if perturb:
        rng = np.random.default_rng(0)
        batch[0] = (batch[0] * (1 + rng.uniform(-perturb, perturb, batch[0].shape))
                    ).astype(np.float32)
    return tuple(batch)


def reference_mc(name: str, perturb: float = 0.0):
    """(pipeline MC, float64-ridge MC, λ picks) of the reference on the
    first seeds."""
    cs = chip_smoke()
    g = reference_topologies()[name]
    batch = mc_batch(perturb)
    cfg = JConfig(n_nodes=g.width, washout=cs.MC_WASHOUT, ridge_l2=cs.MC_LAMS, topology=g,
                  stream_chunk_k=cs.MC_CHUNK, state_method="fast", state_noise_rel=0.0)
    res = JExperiment(cfg).run(*batch)
    mc = [memory_capacity_score(batch[3][b], res.y_pred[b]) for b in range(len(batch[0]))]
    tr, te = jnp.asarray(batch[0], jnp.float32), jnp.asarray(batch[2], jnp.float32)
    lo = jnp.min(tr, axis=1, keepdims=True)
    scale = 1.0 / (jnp.max(tr, axis=1, keepdims=True) - lo + 1e-12)
    masks = jbuild_stage_masks(g)
    f_tr, fin = jgraph_states(g, (tr - lo) * scale, masks, return_final=True)
    f_te = jgraph_states(g, (te - lo) * scale, masks, s0=fin)

    def with_bias(f):
        f = np.asarray(f)
        return np.concatenate([f, np.ones((*f.shape[:2], 1), f.dtype)], axis=-1)

    w = cs.MC_WASHOUT
    f64 = cs.ridge64_mc(with_bias(f_tr)[:, w:], batch[1][:, w:], with_bias(f_te), batch[3],
                        cs.COMPOSED_F64_LAM)
    return mc, f64, np.asarray(res.lam)


def test_topologies_are_the_benchmarks():
    cs = chip_smoke()
    ours = cs.composed_topologies()
    assert tuple(ours) == NAMES
    for name, g in reference_topologies().items():
        assert ours[name] == graph_from_reference(g)
        assert g.width == 48


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_composed_constants_and_port_tolerance(name):
    """The constants chip_smoke.py holds, and the port on the CPU against
    them: pipeline MC, and the MC of the exact Gram of the port's features
    solved on the CPU, within COMPOSED_HOST_MC_TOL (outside
    COMPOSED_F32_EXEMPT), float64-ridge MC on the port's states within
    COMPOSED_F64_TOL, the reference's λ picks all COMPOSED_F64_LAM."""
    cs = chip_smoke()
    mc, f64, lam = reference_mc(name)
    assert mc == pytest.approx(list(cs.COMPOSED_REF_MC[name]), abs=1e-9)
    assert f64 == pytest.approx(list(cs.COMPOSED_REF_MC_F64[name]), abs=1e-9)
    assert np.allclose(lam, cs.COMPOSED_F64_LAM, rtol=1e-6)
    g = cs.composed_topologies()[name]
    batch = mc_batch()
    res = Experiment(cs.composed_config(g), device="cpu").run(*batch)
    got = [memory_capacity_score(batch[3][b], res.y_pred[b]) for b in range(len(batch[0]))]
    w = cs.MC_WASHOUT
    x_tr, x_te = cs.composed_features(g, batch, w, "cpu")
    exact, exact_lam = cs.exact_gram_mc(x_tr, batch[1][:, w:], x_te, batch[3], "cpu")
    assert np.allclose(exact_lam, cs.COMPOSED_F64_LAM, rtol=1e-6)
    if name not in cs.COMPOSED_F32_EXEMPT:
        assert np.max(np.abs(np.asarray(got) - mc)) <= cs.COMPOSED_HOST_MC_TOL
        assert np.max(np.abs(np.asarray(exact) - mc)) <= cs.COMPOSED_HOST_MC_TOL
    port_f64 = cs.composed_f64_mc(g, batch, w, "cpu")
    assert np.max(np.abs(np.asarray(port_f64) - f64)) <= cs.COMPOSED_F64_TOL


@pytest.mark.parametrize("name", NAMES[1:])
def test_references_own_mc_spread_is_within_the_host_tolerance(name):
    """COMPOSED_HOST_MC_TOL covers the reference's own f32 MC under a 2e-7
    relative move of its inputs in every held cell."""
    cs = chip_smoke()
    assert name not in cs.COMPOSED_F32_EXEMPT
    mc, _, _ = reference_mc(name, perturb=2e-7)
    ref = np.asarray(cs.COMPOSED_REF_MC[name])
    assert np.max(np.abs(np.asarray(mc) - ref)) <= cs.COMPOSED_HOST_MC_TOL


def test_baseline_f32_mc_is_the_references_own_round_off():
    """Why d1_l1_baseline's pipeline MC is not held: the reference's own
    moves by more than COMPOSED_MC_TOL under a 2e-7 relative move of its
    inputs, while its float64-ridge MC moves by under 1e-5."""
    cs = chip_smoke()
    assert cs.COMPOSED_F32_EXEMPT == ("d1_l1_baseline",)
    mc, f64, _ = reference_mc("d1_l1_baseline", perturb=2e-7)
    ref = np.asarray(cs.COMPOSED_REF_MC["d1_l1_baseline"])
    assert np.max(np.abs(np.asarray(mc) - ref)) > cs.COMPOSED_MC_TOL
    ref64 = np.asarray(cs.COMPOSED_REF_MC_F64["d1_l1_baseline"])
    assert np.max(np.abs(np.asarray(f64) - ref64)) < 1e-5


def test_composed_config_is_the_benchmarks():
    cs = chip_smoke()
    g = cs.composed_topologies()["d2_l1"]
    cfg = cs.composed_config(g)
    assert (cfg.washout, cfg.ridge_l2, cfg.stream_chunk_k, cfg.state_noise_rel) == (
        40, (1e-8, 1e-6, 1e-4), 64, 0.0)
    assert (cfg.state_method, cfg.readout_use_kernel) == ("kernel", True)
    assert dataclasses.replace(cfg, state_method="fast").topology == g
