"""Port parity: the device subsystem (repro_torch.devices vs repro.devices).

Mirrors tests/test_devices.py case by case, on the CPU, with the same
numpy inputs handed to both packages (N = 16, K = 40, B = 3).  Tolerances:
within the port, the CMT cavity's ``ref``, ``fast`` and kernel paths (the
kernel's plain version on CPU tensors) agree bitwise, and so do chunk
resumes; against the JAX package, states agree to 1e-5 (the same separately
rounded f32 ops, but exp/expm1 of two libms may differ by an ulp, carried
through the recurrence), tick maps to 1e-6, finite-difference gains to
1e-3 (an ulp of the tick over h = 2⁻¹²), sweep NRMSE to 1e-3 on the cells
the reference calls stable.  The two ``chip_smoke`` tests recompute the
constants that ``chip_smoke.py`` holds the card to.
"""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import SiliconMR as JMR
from repro.core import make_mask as jmake_mask
from repro.core import tasks as jtasks
from repro.core.masking import sample_and_hold as jsample_and_hold
from repro.core.reservoir import _states_ref as j_states_ref
from repro.core.reservoir import generate_states as jgenerate_states
from repro.devices import CMTSweepParams as JParams
from repro.devices import SweepGrid as JSweepGrid
from repro.devices import calibrated_twin as jcalibrated_twin
from repro.devices import calibration_report as jcalibration_report
from repro.devices import run_device_sweep as jrun_device_sweep
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro_torch.core import MODEL_REGISTRY, SiliconMR, generate_states, make_mask, register_model
from repro_torch.core import tasks
from repro_torch.core.reservoir import _states_fast_p
from repro_torch.devices import (CMTSweepParams, MRCavityCMT, SweepGrid, SweepResult,
                                 calibrated_twin, calibration_report, node_parity,
                                 run_device_sweep)
from repro_torch.pipeline import Experiment, ExperimentConfig
from repro_torch.pipeline.experiment import _gen_states

N = 16
K = 40
B = 3
MASK = make_mask(N, seed=3)
MR = SiliconMR()
TWIN = calibrated_twin(MR)                       # zero-power limit
CMT_HOT = calibrated_twin(MR, power_mw=1.0)      # nonlinear mechanisms on
J_HOT = jcalibrated_twin(JMR(), power_mw=1.0)


def _stream(seed: int, k: int = K, b: int | None = B) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (k,) if b is None else (b, k)).astype(np.float32)


def _jax_states(model, j, p=None):
    """The JAX package's states of ``j`` under MASK (``fast`` with ``p``,
    else the sequential oracle ``_states_ref``)."""
    if p is not None:
        return np.asarray(jgenerate_states(model, jnp.asarray(j), jnp.asarray(MASK.numpy()),
                                           method="fast", dev_params=p))
    u = jnp.asarray(j)[..., None] * jnp.asarray(MASK.numpy())
    return np.asarray(j_states_ref(model, u, jnp.zeros((j.shape[0], N), jnp.float32)))


def _lane_grid():
    vals = dict(detune=[-0.5, 0.0, 1.0], loss_scale=[1.0, 1.2, 1.5], power=[0.0, 0.5, 1.0])
    return (CMTSweepParams(**{k: torch.tensor(v) for k, v in vals.items()}),
            JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in vals.items()}))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# ---------------------------------------------------------------------------
# registry and the model itself
# ---------------------------------------------------------------------------


def test_registry_contains_cmt():
    assert MODEL_REGISTRY["mr_cavity_cmt"] is MRCavityCMT
    register_model("mr_cavity_cmt", MRCavityCMT)   # idempotent re-register
    with pytest.raises(ValueError, match="already registered"):
        register_model("mr_cavity_cmt", SiliconMR)


def test_fields_properties_and_validation_match_reference():
    for kw in ({}, dict(detune=0.7, loss_scale=1.3, power_mw=2.0, n_substeps=3),
               dict(kappa_charge=0.02, kappa_discharge=0.03)):
        port, ref = calibrated_twin(MR, **kw), jcalibrated_twin(JMR(), **kw)
        for f in dataclasses.fields(ref):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
        for prop in ("alpha", "kappa_c", "kappa_d"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert tuple(port.sweep_point()) == tuple(ref.sweep_point())
    for bad in (dict(n_substeps=0), dict(theta_ps=0.0), dict(tau_fc_ps=-1.0),
                dict(loss_scale=-0.1), dict(power_mw=-1.0)):
        with pytest.raises(ValueError):
            MRCavityCMT(**bad)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_node_and_period_update_match_reference(m):
    port = dataclasses.replace(CMT_HOT, n_substeps=m, detune=0.3, loss_scale=1.2)
    ref = dataclasses.replace(J_HOT, n_substeps=m, detune=0.3, loss_scale=1.2)
    rng = np.random.default_rng(m)
    u, s_tau, s_pn = (rng.uniform(-0.5, 1.5, (4, 19)).astype(np.float32) for _ in range(3))
    got = port.node_update(*(torch.as_tensor(a) for a in (u, s_tau, s_pn)))
    want = ref.node_update(*(jnp.asarray(a) for a in (u, s_tau, s_pn)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    got_p = port.period_update(torch.as_tensor(u), torch.as_tensor(s_tau),
                               torch.as_tensor(s_tau[:, -1]))
    want_p = ref.period_update(jnp.asarray(u), jnp.asarray(s_tau), jnp.asarray(s_tau[:, -1]))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# calibration: the CMT low-power limit is the paper model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_calibrated_twin_tick_parity_any_substeps(m):
    """The zero-power tick map is substep-count independent and matches
    SiliconMR to f32 rounding, and the port's twin ticks as the JAX
    package's does on the same grid."""
    twin = calibrated_twin(MR, n_substeps=m)
    assert node_parity(MR, twin, device="cpu") < 1e-5
    g = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    grid = np.meshgrid(g, g, g, indexing="ij")
    got = twin.node_update(*(torch.as_tensor(a) for a in grid))
    want = jcalibrated_twin(JMR(), n_substeps=m).node_update(*(jnp.asarray(a) for a in grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_calibrated_twin_requires_zero_tpa():
    with pytest.raises(ValueError, match="beta_tpa"):
        calibrated_twin(SiliconMR(beta_tpa=0.3))


def test_small_signal_gains_match():
    rep = calibration_report(MR, TWIN, device="cpu")
    ref = jcalibration_report(JMR(), jcalibrated_twin(JMR()))
    for branch in ("charge", "discharge"):
        assert rep[branch]["max_abs_delta"] < 1e-3
        for key in ("mr_drive", "cmt_drive", "mr_state", "cmt_state"):
            assert abs(rep[branch][key] - ref[branch][key]) <= 1e-3, (branch, key)


def test_stream_parity_low_power():
    j = _stream(0)
    a = generate_states(MR, j, MASK, method="ref", device="cpu")
    b = generate_states(TWIN, j, MASK, method="ref", device="cpu")
    assert float(torch.max(torch.abs(a - b))) < 1e-4


# ---------------------------------------------------------------------------
# integrator: substep convergence, path parity, chunked resume
# ---------------------------------------------------------------------------


def test_substep_convergence_with_nonlinearity_on():
    g = torch.linspace(0.0, 1.0, 7, dtype=torch.float32)
    u, st, sp = torch.meshgrid(g, g, g, indexing="ij")

    def tick(m):
        return dataclasses.replace(CMT_HOT, n_substeps=m).node_update(u, st, sp)

    ref = tick(64)
    errs = [float(torch.max(torch.abs(tick(m) - ref))) for m in (1, 4, 16)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] < 1e-2


def test_fast_matches_ref_bitwise():
    j = _stream(1)
    a = generate_states(CMT_HOT, j, MASK, method="ref", device="cpu")
    b = generate_states(CMT_HOT, j, MASK, method="fast", device="cpu")
    assert torch.equal(a, b)
    np.testing.assert_allclose(b.numpy(), _jax_states(J_HOT, j), rtol=0, atol=1e-5)


def test_kernel_matches_ref():
    """The kernel path's plain version (CPU tensors) equals the port's ref
    path bitwise and the JAX package's ``_states_ref`` within 1e-5."""
    j = _stream(2)
    a = generate_states(CMT_HOT, j, MASK, method="ref", device="cpu")
    b = generate_states(CMT_HOT, j, MASK, method="kernel", device="cpu")
    assert torch.equal(a, b)
    np.testing.assert_allclose(b.numpy(), _jax_states(J_HOT, j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["ref", "fast", "kernel"])
def test_chunk_resume_bit_exact(method):
    j = _stream(3)
    full = generate_states(CMT_HOT, j, MASK, method=method, device="cpu")
    s0, out = None, []
    for lo, hi in ((0, 13), (13, 14), (14, K)):
        states, s0 = generate_states(CMT_HOT, j[:, lo:hi], MASK, s0=s0, method=method,
                                     return_final=True, device="cpu")
        out.append(states)
    assert torch.equal(torch.cat(out, dim=1), full)


# ---------------------------------------------------------------------------
# swept parameters: lanes == points, finiteness, validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["ref", "fast"])
def test_swept_lanes_match_unswept_points(method):
    """Each lane of a dev_params run equals the model frozen at that grid
    point (κ pinned to the base model's anchor), and the swept states
    agree with the JAX package's."""
    j = _stream(4)
    p, jp = _lane_grid()
    swept = generate_states(CMT_HOT, j, MASK, method=method, dev_params=p, device="cpu")
    for lane in range(B):
        point = dataclasses.replace(
            CMT_HOT, detune=float(p.detune[lane]), loss_scale=float(p.loss_scale[lane]),
            power_mw=float(p.power[lane]), kappa_charge=CMT_HOT.kappa_c,
            kappa_discharge=CMT_HOT.kappa_d)
        ref = generate_states(point, j[lane], MASK, method=method, device="cpu")
        assert float(torch.max(torch.abs(swept[lane] - ref))) < 1e-5
    np.testing.assert_allclose(swept.numpy(), _jax_states(J_HOT, j, jp), rtol=0, atol=1e-5)


def test_states_fast_p_matches_reference():
    """``_states_fast_p`` on the masked input against the JAX package's, at
    per-lane points and from a nonzero state."""
    j = _stream(8)
    p, jp = _lane_grid()
    s0 = np.random.default_rng(8).uniform(0, 0.3, (B, N)).astype(np.float32)
    u = j[..., None] * MASK.numpy()
    got = _states_fast_p(CMT_HOT, p, torch.as_tensor(u), torch.as_tensor(s0))
    from repro.core.reservoir import _states_fast_p as j_states_fast_p

    want = j_states_fast_p(J_HOT, jp, jnp.asarray(u), jnp.asarray(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_states_finite_over_parameter_box():
    grid = SweepGrid(detune=(-2.0, 0.0, 2.0), loss_scale=(1.0, 1.5, 2.0), power=(0.0, 1.0, 2.0))
    j = _stream(5, b=grid.size)
    states = generate_states(CMT_HOT, j, MASK, method="fast", dev_params=grid.lanes(),
                             device="cpu")
    assert bool(torch.all(torch.isfinite(states)))


def test_dev_params_scalar_leaves_broadcast():
    j = _stream(6)
    p0 = CMTSweepParams(detune=0.0, loss_scale=1.0, power=1.0)
    a = generate_states(CMT_HOT, j, MASK, method="fast", dev_params=p0, device="cpu")
    point = dataclasses.replace(CMT_HOT, power_mw=1.0, kappa_charge=CMT_HOT.kappa_c,
                                kappa_discharge=CMT_HOT.kappa_d)
    b = generate_states(point, j, MASK, method="fast", device="cpu")
    assert float(torch.max(torch.abs(a - b))) < 1e-5


def test_dev_params_rejected_on_kernel_path():
    with pytest.raises(NotImplementedError, match="kernel"):
        generate_states(CMT_HOT, _stream(7), MASK, method="kernel", dev_params=_lane_grid()[0],
                        device="cpu")
    with pytest.raises(TypeError, match="swept device parameters"):
        generate_states(MR, _stream(7), MASK, method="fast", dev_params=_lane_grid()[0],
                        device="cpu")


def test_experiment_dev_params_validation():
    """The reference's checks: the kernel state path, a composed topology
    and a leaf that is neither scalar nor [B] raise ValueError; the WDM
    workload raises NotImplementedError."""
    ds = tasks.narma10(200, seed=0)
    base = dict(model=CMT_HOT, n_nodes=N, washout=20, state_noise_rel=0.0)
    args = (ds.inputs_train[None, :], ds.targets_train[None, :],
            ds.inputs_test[None, :], ds.targets_test[None, :])
    p0 = CMTSweepParams(detune=0.0, loss_scale=1.0, power=0.0)
    with pytest.raises(ValueError, match="kernel"):
        Experiment(ExperimentConfig(state_method="kernel", **base), device="cpu").run(
            *args, dev_params=p0)
    from repro.core.graph import ReservoirStage, chain
    from repro_torch.convert import graph_from_reference

    topo = graph_from_reference(chain(ReservoirStage(model=J_HOT, n_nodes=N, mask_seed=3)))
    with pytest.raises(ValueError, match="topology"):
        Experiment(ExperimentConfig(topology=topo, stream_chunk_k=16, **base),
                   device="cpu").run(*args, dev_params=p0)
    bad = CMTSweepParams(detune=torch.zeros((2,)), loss_scale=1.0, power=0.0)
    with pytest.raises(ValueError, match="batch lane"):
        Experiment(ExperimentConfig(**base), device="cpu").run(*args, dev_params=bad)
    cfg = ExperimentConfig(**base)
    with pytest.raises(NotImplementedError, match="WDM"):
        _gen_states(cfg, torch.stack([MASK, MASK]), torch.zeros((2, 5)), wdm=True,
                    dev_params=p0)


@pytest.mark.parametrize("stream_chunk_k", [None, 16])
def test_experiment_dev_params_matches_reference(stream_chunk_k):
    """``Experiment.run(dev_params=...)``, materialized and streamed, against
    the JAX package's on the same two lanes (noise off): NRMSE within 1e-3.
    The streamed fit solves through the f32 Gram and eigh; its λ grid stops
    at 1e-4, where that solve is well conditioned in both packages (below
    it the two spread f32 round-off by ~1e-3 on a fit this short, as ROADMAP
    Queue 3 records for the Gram readout)."""
    ds = jtasks.narma10(400, seed=1)
    batch = [np.stack([getattr(ds, f)] * 2) for f in
             ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    kw = dict(n_nodes=N, washout=20, ridge_l2=(1e-4, 1e-2), state_noise_rel=0.0,
              stream_chunk_k=stream_chunk_k, state_method="fast")
    vals = dict(detune=[0.0, 0.75], loss_scale=[1.0, 1.25], power=[1.0, 0.5])
    got = Experiment(ExperimentConfig(model=CMT_HOT, **kw), device="cpu").run(
        *batch, dev_params=CMTSweepParams(**{k: torch.tensor(v) for k, v in vals.items()}))
    want = JExperiment(JConfig(model=J_HOT, **kw)).run(
        *batch, dev_params=JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in vals.items()}))
    np.testing.assert_allclose(got.nrmse, want.nrmse, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# sweep driver: grid algebra, the map against the reference's
# ---------------------------------------------------------------------------


def test_sweep_grid_lanes_fold_roundtrip():
    grid = SweepGrid(detune=(-1.0, 1.0), loss_scale=(1.0, 1.5, 2.0), power=(0.0, 1.0))
    assert grid.shape == (2, 3, 2) and grid.size == 12
    lanes = grid.lanes()
    jlanes = JSweepGrid(detune=(-1.0, 1.0), loss_scale=(1.0, 1.5, 2.0), power=(0.0, 1.0)).lanes()
    for a, b in zip(lanes, jlanes):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b))
    folded = grid.fold(lanes.detune)
    for i, d in enumerate(grid.detune):
        assert np.all(folded[i] == d)
    idx = (1, 2, 0)
    flat = np.ravel_multi_index(idx, grid.shape)
    assert grid.point(idx) == {"detune": float(lanes.detune[flat]),
                               "loss_scale": float(lanes.loss_scale[flat]),
                               "power": float(lanes.power[flat])}
    with pytest.raises(ValueError, match="empty"):
        SweepGrid(detune=(), loss_scale=(1.0,), power=(0.0,))


def test_stable_region_summary():
    grid = SweepGrid(detune=(0.0, 1.0), loss_scale=(1.0,), power=(0.0, 1.0))
    nrmse = np.array([[[0.2, 0.9]], [[np.inf, 0.3]]])
    res = SweepResult(grid=grid, nrmse=nrmse, ser=np.zeros_like(nrmse), lam=np.zeros_like(nrmse))
    region = res.stable_region(nrmse_max=0.4)
    assert region["summary"]["n_stable"] == 2
    assert region["summary"]["best_point"]["nrmse"] == 0.2
    assert region["map"].tolist() == [[[True, False]], [[False, True]]]
    assert region["summary"]["stable_detune"] == [0.0, 1.0]
    assert region["summary"]["stable_power"] == [0.0, 1.0]


@pytest.mark.parametrize("samples,washout,chunk,lams", [
    (300, 20, 32, (1e-6, 1e-4)),           # tests/test_devices.py's sweep
    (1200, 50, 128, (1e-8, 1e-6, 1e-4)),   # benchmarks/device_sweep.py's, at N = 16
], ids=["reference_test", "benchmark_point"])
def test_run_device_sweep_matches_reference(samples, washout, chunk, lams):
    """The map against the JAX package's on the same grid: the same stable
    map at the 0.8 bound, NRMSE within 1e-3 on the stable cells, all cells
    finite.  No cell is stable at the reference test's size (both packages
    score NRMSE > 1 on 300 samples); at the benchmark's point one is.  A
    grid of new values gives a new map."""
    ds = tasks.narma10(samples, seed=0)
    jds = jtasks.narma10(samples, seed=0)
    kw = dict(n_nodes=N, washout=washout, stream_chunk_k=chunk, ridge_l2=lams)
    axes = (dict(detune=(-0.5, 0.5), loss_scale=(1.0,), power=(0.0, 1.0)) if samples == 300
            else dict(detune=(0.0, 0.75), loss_scale=(1.0,), power=(0.0, 1.0)))
    res = run_device_sweep(TWIN, SweepGrid(**axes), ds, device="cpu", **kw)
    want = jrun_device_sweep(jcalibrated_twin(JMR()), JSweepGrid(**axes), jds, **kw)
    assert res.nrmse.shape == (2, 1, 2) and np.all(np.isfinite(res.nrmse))
    stable = res.stable_region(nrmse_max=0.8)["map"]
    assert np.array_equal(stable, want.stable_region(nrmse_max=0.8)["map"])
    assert stable.any() == (samples == 1200)
    np.testing.assert_allclose(res.nrmse[stable], want.nrmse[stable], rtol=0, atol=1e-3)
    if samples == 300:
        shifted = SweepGrid(detune=(-0.25, 0.75), loss_scale=(1.1,), power=(0.25, 1.25))
        res2 = run_device_sweep(TWIN, shifted, ds, device="cpu", **kw)
        assert not np.array_equal(res.nrmse, res2.nrmse)


# ---------------------------------------------------------------------------
# the constants chip_smoke.py holds the card to
# ---------------------------------------------------------------------------


def _cmt_main_reference(cs, perturb: float = 0.0):
    """The JAX package at chip_smoke.py's CMT point on the first seeds (the
    ``fast`` path, noise off): the pipeline's result, and its train/test
    states through the pipeline's input layer.  ``perturb`` moves each train
    input by up to that relative amount (seeded)."""
    n = len(cs.CMT_REF_NRMSE)
    ds = [jtasks.narma10(cs.CMT_SAMPLES, seed=s) for s in range(n)]
    batch = [np.stack([getattr(d, f) for d in ds]) for f in
             ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    if perturb:
        rng = np.random.default_rng(0)
        batch[0] = (batch[0] * (1 + rng.uniform(-perturb, perturb, batch[0].shape))
                    ).astype(np.float32)
    model = jcalibrated_twin(JMR(), power_mw=cs.CMT_POWER_MW)
    point = cs.main_point()
    cfg = JConfig(model=model, n_nodes=point.n_nodes, washout=point.washout,
                  ridge_l2=point.ridge_l2, state_noise_rel=0.0, state_method="fast",
                  readout_use_kernel=True)
    res = JExperiment(cfg).run(*batch)
    tr, te = jnp.asarray(batch[0], jnp.float32), jnp.asarray(batch[2], jnp.float32)
    lo = jnp.min(tr, axis=1, keepdims=True)
    scale = 1.0 / (jnp.max(tr, axis=1, keepdims=True) - lo + 1e-12)
    mask = jmake_mask(cfg.n_nodes, seed=cfg.mask_seed)
    st_tr, fin = jgenerate_states(model, jsample_and_hold((tr - lo) * scale), mask,
                                  method="fast", return_final=True)
    st_te = jgenerate_states(model, jsample_and_hold((te - lo) * scale), mask, s0=fin,
                             method="fast")
    return res, batch, np.array(st_tr), np.array(st_te)


def test_chip_smoke_cmt_nrmse_comes_from_the_reference():
    """chip_smoke.py's ``cmt_main`` holds the first seeds on the card to the
    JAX package's, computed here on the CPU at the same point: the
    pipeline's NRMSE (the Gram readout) with its λ, and the NRMSE of a
    float64 ridge at that λ on the reference's states."""
    cs = _chip_smoke()
    res, batch, st_tr, st_te = _cmt_main_reference(cs)
    assert res.nrmse.tolist() == pytest.approx(list(cs.CMT_REF_NRMSE), abs=1e-9)
    assert np.allclose(res.lam, cs.CMT_REF_LAM, rtol=1e-6)
    f64 = cs.ridge64_nrmse(st_tr, batch[1], st_te, batch[3], lam=cs.CMT_REF_LAM,
                           washout=cs.main_point().washout)
    assert f64 == pytest.approx(list(cs.CMT_REF_NRMSE_F64), abs=1e-9)


def _sweep_reference(cs, perturb: float = 0.0):
    """The JAX package's map at chip_smoke.py's sweep, and a float64 ridge
    at λ = SWEEP_LAMS[-1] on its states of each of its stable cells (the
    cell's dataclass point through the ``fast`` path, as
    ``sweep_cell_model`` builds it): [(lane, NRMSE)].  ``perturb`` moves
    each train input by up to that relative amount (seeded)."""
    ds = jtasks.narma10(cs.SWEEP_SAMPLES, seed=0)
    if perturb:
        rng = np.random.default_rng(0)
        ds = dataclasses.replace(ds, inputs_train=(ds.inputs_train * (
            1 + rng.uniform(-perturb, perturb, ds.inputs_train.shape))).astype(np.float32))
    grid = JSweepGrid(**cs.SWEEP_GRID)
    twin = jcalibrated_twin(JMR())
    res = jrun_device_sweep(twin, grid, ds, n_nodes=cs.SWEEP_N, washout=cs.SWEEP_WASHOUT,
                            stream_chunk_k=cs.SWEEP_CHUNK, ridge_l2=cs.SWEEP_LAMS)
    tr, te = jnp.asarray(ds.inputs_train)[None], jnp.asarray(ds.inputs_test)[None]
    lo = jnp.min(tr, axis=1, keepdims=True)
    scale = 1.0 / (jnp.max(tr, axis=1, keepdims=True) - lo + 1e-12)
    mask = jmake_mask(cs.SWEEP_N, seed=1)
    cells = []
    for flat in np.flatnonzero(res.stable_region(nrmse_max=cs.SWEEP_STABLE)["map"].ravel()):
        model = cs.sweep_cell_model(twin, grid, int(flat))
        st_tr, fin = jgenerate_states(model, jsample_and_hold((tr - lo) * scale), mask,
                                      method="fast", return_final=True)
        st_te = jgenerate_states(model, jsample_and_hold((te - lo) * scale), mask, s0=fin,
                                 method="fast")
        cells.append((int(flat), cs.ridge64_nrmse(
            np.array(st_tr), ds.targets_train[None], np.array(st_te), ds.targets_test[None],
            lam=cs.SWEEP_LAMS[-1], washout=cs.SWEEP_WASHOUT)[0]))
    return res, cells


def test_chip_smoke_sweep_map_comes_from_the_reference():
    """chip_smoke.py's ``device_sweep`` holds the 60-lane NARMA10 map on the
    card to the JAX package's, computed here on the CPU at the same grid,
    and its stable cells' states to a float64 ridge on the reference's."""
    cs = _chip_smoke()
    res, cells = _sweep_reference(cs)
    assert res.nrmse.ravel().tolist() == pytest.approx(list(cs.SWEEP_REF_NRMSE), abs=1e-9)
    assert cells == [(c, pytest.approx(v, abs=1e-9)) for c, v in cs.SWEEP_REF_STABLE_F64]


@pytest.mark.parametrize("cell", ["cmt_main", "device_sweep"])
def test_f32_readout_spread_is_the_references_own(cell):
    """Why chip_smoke.py holds the CMT point's seeds and the sweep's stable
    cells through a float64 ridge on the states: there the reference's own
    f32 Gram/eigh NRMSE moves by more than the tolerance chip_smoke.py
    holds the states to (CMT_NRMSE_TOL, SWEEP_TOL) when its train inputs
    move by 2e-7 relative (about an ulp), while the float64 ridge on its
    states moves by under 1e-5."""
    cs = _chip_smoke()
    if cell == "cmt_main":
        res, batch, st_tr, st_te = _cmt_main_reference(cs, perturb=2e-7)
        moved = np.abs(res.nrmse - np.asarray(cs.CMT_REF_NRMSE))
        f64 = cs.ridge64_nrmse(st_tr, batch[1], st_te, batch[3], lam=cs.CMT_REF_LAM,
                               washout=cs.main_point().washout)
        f64_moved = np.abs(np.asarray(f64) - np.asarray(cs.CMT_REF_NRMSE_F64))
        tol = cs.CMT_NRMSE_TOL
    else:
        res, cells = _sweep_reference(cs, perturb=2e-7)
        lanes = [c for c, _ in cs.SWEEP_REF_STABLE_F64]
        moved = np.abs(res.nrmse.ravel()[lanes] - np.asarray(cs.SWEEP_REF_NRMSE)[lanes])
        f64_moved = np.abs(np.asarray([v for _, v in cells])
                           - np.asarray([v for _, v in cs.SWEEP_REF_STABLE_F64]))
        tol = cs.SWEEP_TOL
    assert moved.max() > tol
    assert f64_moved.max() < 1e-5


# ---------------------------------------------------------------------------
# generated splits and grid points (tests/test_properties.py's CMT cases)
# ---------------------------------------------------------------------------

P_N, P_B, P_K = 7, 3, 24
P_MASK = make_mask(P_N, seed=3)


@st.composite
def split_points(draw, k=P_K, max_cuts=4):
    """1..max_cuts sorted interior cut positions of a length-k stream."""
    n_cuts = draw(st.integers(1, max_cuts))
    return sorted(draw(st.lists(st.integers(1, k - 1), min_size=n_cuts, max_size=n_cuts,
                                unique=True)))


@given(cuts=split_points(), seed=st.integers(0, 20),
       method=st.sampled_from(["ref", "fast", "kernel"]))
@settings(max_examples=25, deadline=None)
def test_cmt_chunked_resume_bit_exact_for_arbitrary_splits(cuts, seed, method):
    j = torch.as_tensor(_stream(seed, k=P_K, b=P_B))
    full, fin_full = generate_states(CMT_HOT, j, P_MASK, method=method, return_final=True,
                                     device="cpu")
    bounds = [0] + cuts + [P_K]
    s = torch.zeros((P_B, P_N))
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        states, s = generate_states(CMT_HOT, j[:, lo:hi], P_MASK, s0=s, method=method,
                                    return_final=True, device="cpu")
        parts.append(states)
    assert torch.equal(torch.cat(parts, dim=1), full)
    assert torch.equal(s, fin_full)


@given(seed=st.integers(0, 20), detune=st.floats(-2.0, 2.0), loss=st.floats(1.0, 2.0),
       power=st.floats(0.0, 2.0))
@settings(max_examples=25, deadline=None)
def test_cmt_swept_lane_matches_unswept_point(seed, detune, loss, power):
    j = _stream(seed, k=P_K, b=1)
    p = CMTSweepParams(detune=torch.tensor(detune, dtype=torch.float32),
                       loss_scale=torch.tensor(loss, dtype=torch.float32),
                       power=torch.tensor(power, dtype=torch.float32))
    swept = generate_states(CMT_HOT, j, P_MASK, method="fast", dev_params=p, device="cpu")
    point = dataclasses.replace(CMT_HOT, detune=detune, loss_scale=loss, power_mw=power,
                                kappa_charge=CMT_HOT.kappa_c, kappa_discharge=CMT_HOT.kappa_d)
    ref = generate_states(point, j, P_MASK, method="fast", device="cpu")
    assert bool(torch.all(torch.isfinite(swept)))
    np.testing.assert_allclose(swept.numpy(), ref.numpy(), atol=1e-5, rtol=0)
