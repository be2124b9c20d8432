"""Port parity: WDM ensembles (repro_torch channel_states, the WDM and
shared-readout streaming fits, WDMExperiment; DESIGN.md §9).

Mirrors tests/test_wdm_streaming.py and the shared-readout cases of
tests/test_composed.py.  The same numpy inputs go through the JAX package
(jnp "fast" reservoir and einsum fold, as its own tests run it) and the
port on the CPU, where the port's kernel wrappers take their plain
versions.

Tolerances: channel states vs the JAX package ≤1e-6 (SiliconMR's bound);
streamed vs materialized per-channel fits ≤1e-3 NRMSE and SER with the
same λ (the reference's bar), weights atol/rtol 0.1 (the reference's own);
port vs JAX on the same configuration ≤1e-3 NRMSE; bf16 chunks ≤0.06 NRMSE
and ≤0.05 SER.  The shared readout is held at one well-conditioned λ
(1e-4): its 4·32 + 1 = 129 features on 320 rows leave λ = 1e-8 ill-posed
in f32.  Within the port, chunk resume and the R = 1 shared readout are
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SiliconMR as JMR
from repro.core import tasks as jtasks
from repro.pipeline import ExperimentConfig as JConfig
from repro.pipeline import WDMExperiment as JWDMExperiment
from repro.pipeline import channel_states as jchannel_states
from repro_torch import convert
from repro_torch.analysis.tracer import Trace
from repro_torch.core import SiliconMR, make_mask, tasks
from repro_torch.pipeline import (ExperimentConfig, WDMExperiment, channel_states,
                                  fit_ridge, fit_ridge_batched, fit_ridge_streaming_shared,
                                  fit_ridge_streaming_wdm)
from repro_torch.pipeline.experiment import _run_pipeline

LAMS = (1e-8, 1e-6, 1e-4)
CHUNK = 64
BF16_NRMSE_TOL = 0.06
BF16_SER_TOL = 0.05


def _stack(datasets):
    return tuple(np.stack([getattr(d, f) for d in datasets])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


@pytest.fixture(scope="module")
def narma_channels():
    """4 wavelength channels = 4 independent NARMA10 draws, 360/360 periods
    (a ragged last chunk of 40 at chunk 64)."""
    return _stack([tasks.narma10(720, seed=s) for s in range(4)])


@pytest.fixture(scope="module")
def chan_eq_channels():
    return _stack([tasks.channel_equalization(1200, snr_db=24.0, seed=s) for s in range(4)])


def _base(**kw):
    base = dict(n_nodes=32, washout=40, ridge_l2=LAMS, state_noise_rel=0.0,
                state_method="kernel", readout_use_kernel=True)
    base.update(kw)
    return base


def _port(r=4, shared=False, masks=None, **kw):
    return WDMExperiment(ExperimentConfig(model=SiliconMR(), **_base(**kw)), r, masks=masks,
                         shared_readout=shared, device="cpu")


def _jax(r=4, shared=False, **kw):
    kw = {"state_method": "fast", "readout_use_kernel": False, **kw}
    return JWDMExperiment(JConfig(model=JMR(), **_base(**kw)), r, shared_readout=shared)


def _masks(r, n, seed0):
    return torch.stack([make_mask(n, seed=seed0 + i) for i in range(r)])


# ---------------------------------------------------------------------------
# channel_states: the reference's states, bitwise chunk resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["ref", "fast", "kernel"])
def test_channel_states_chunk_resume_bit_parity(method):
    """Chunked channel_states(return_final=True) resumes bit-exactly within
    the port on every method (a ragged 17-period chunk grid), and the states
    match the JAX package's channel_states to 1e-6."""
    rng = np.random.default_rng(11)
    r, k, n = 3, 50, 12
    j = torch.as_tensor(rng.uniform(0, 1, (r, k)), dtype=torch.float32)
    masks = _masks(r, n, 60)
    full, fin_full = channel_states(SiliconMR(), j, masks, method=method, return_final=True,
                                    device="cpu")
    assert torch.equal(fin_full, full[:, -1])
    chunks, s = [], None
    for lo in range(0, k, 17):
        st, s = channel_states(SiliconMR(), j[:, lo:lo + 17], masks, s0=s, method=method,
                               return_final=True, device="cpu")
        chunks.append(st)
    assert torch.equal(torch.cat(chunks, dim=1), full) and torch.equal(s, fin_full)
    want = jchannel_states(JMR(), jnp.asarray(j.numpy()), jnp.asarray(masks.numpy()),
                           method="ref")
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["fast", "kernel"])
def test_channel_states_bf16_chunks_track_f32(method):
    """state_dtype='bfloat16' rounds only the emitted states: the f32 carry
    is bitwise the f32 run's, the states within bf16 round-off."""
    rng = np.random.default_rng(12)
    r, k, n = 3, 40, 10
    j = torch.as_tensor(rng.uniform(0, 1, (r, k)), dtype=torch.float32)
    masks = _masks(r, n, 70)
    st32, fin32 = channel_states(SiliconMR(), j, masks, method=method, return_final=True,
                                 device="cpu")
    st16, fin16 = channel_states(SiliconMR(), j, masks, method=method, return_final=True,
                                 state_dtype="bfloat16", device="cpu")
    assert st16.dtype == torch.bfloat16 and fin16.dtype == torch.float32
    assert torch.equal(fin16, fin32)
    np.testing.assert_allclose(st16.float().numpy(), st32.numpy(), atol=1e-2, rtol=1e-2)


def test_channel_states_kernel_is_one_per_lane_scan(monkeypatch):
    """method='kernel' calls the scan op ONCE for all R channels, with the
    [R, N] mask stack (its per-lane mode)."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    calls = []
    real = scan_ops.dfr_scan

    def spy(model, j, mask, s0, **kw):
        calls.append(tuple(mask.shape))
        return real(model, j, mask, s0, **kw)

    monkeypatch.setattr(scan_ops, "dfr_scan", spy)
    j = torch.rand((5, 9))
    channel_states(SiliconMR(), j, _masks(5, 7, 1), method="kernel", device="cpu")
    assert calls == [(5, 7)]


def test_channel_states_rejects_bad_arguments():
    j = torch.zeros((3, 10))
    with pytest.raises(ValueError, match="channels mismatch"):
        channel_states(SiliconMR(), j, _masks(2, 8, 1), device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        channel_states(SiliconMR(), j, _masks(3, 8, 1), method="pallas", device="cpu")


# ---------------------------------------------------------------------------
# fit_ridge_streaming_wdm: streamed per-channel Grams == materialized fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gram-op", "gram-plain"])
def test_fit_wdm_streaming_matches_materialized(use_kernel):
    """Chunked WDM fit ≈ the materialized per-channel Gram fit (same λ,
    weights within the reference's 0.1), s_end bitwise the last state row
    for K % chunk_k != 0."""
    rng = np.random.default_rng(5)
    r, k, n, w0 = 3, 200, 24, 30
    j = torch.as_tensor(rng.uniform(0, 1, (r, k)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((r, k)), dtype=torch.float32)
    masks = _masks(r, n, 80)
    st = channel_states(SiliconMR(), j, masks, method="kernel", device="cpu")
    w_m, idx_m = fit_ridge_batched(st[:, w0:], y[:, w0:], lambdas=LAMS, use_kernel=True,
                                   device="cpu")
    for chunk in (64, 72):
        w_s, idx_s, s_end = fit_ridge_streaming_wdm(
            SiliconMR(), masks, j, y, washout=w0, chunk_k=chunk, lambdas=LAMS,
            use_kernel=use_kernel, device="cpu")
        assert torch.equal(s_end, st[:, -1])
        assert torch.equal(idx_s, idx_m)
        np.testing.assert_allclose(w_s.numpy(), w_m.numpy(), atol=0.1, rtol=0.1)


def test_fit_wdm_streaming_rejects_mismatched_channels():
    masks = _masks(2, 8, 1)
    with pytest.raises(ValueError, match="channels mismatch"):
        fit_ridge_streaming_wdm(SiliconMR(), masks, torch.zeros((3, 60)), torch.zeros((3, 60)),
                                washout=10, chunk_k=16, device="cpu")


# ---------------------------------------------------------------------------
# WDMExperiment end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wdm_streamed(narma_channels):
    return _port(stream_chunk_k=CHUNK).run(*narma_channels)


def test_wdm_experiment_streaming_parity(narma_channels, wdm_streamed):
    """Streamed WDMExperiment == the materialized one (K1 per-lane + the Gram
    fit) within 1e-3 NRMSE/SER and the same λ; == the JAX streamed WDM run
    within 1e-3; every channel beats the mean predictor."""
    res_m = _port().run(*narma_channels)
    res_s = wdm_streamed
    assert np.max(np.abs(res_s.nrmse - res_m.nrmse)) <= 1e-3, (res_s.nrmse, res_m.nrmse)
    assert np.max(np.abs(res_s.ser - res_m.ser)) <= 1e-3
    np.testing.assert_array_equal(res_s.lam, res_m.lam)
    assert res_s.y_pred.shape == res_m.y_pred.shape == (4, 360)
    assert np.all(res_s.nrmse < 0.9), res_s.nrmse
    want = _jax(stream_chunk_k=CHUNK).run(*narma_channels)
    assert np.max(np.abs(res_s.nrmse - want.nrmse)) <= 1e-3, (res_s.nrmse, want.nrmse)
    np.testing.assert_array_equal(res_s.lam, want.lam)


def test_wdm_experiment_materialized_matches_reference(narma_channels):
    """stream_chunk_k=None: per-lane states and the batched Gram fit, against
    the JAX package's materialized WDMExperiment (SVD readout, noise off)."""
    kw = dict(ridge_l2=(1e-4,), readout_use_kernel=False)
    got = _port(**kw).run(*narma_channels)
    want = _jax(**kw).run(*narma_channels)
    assert np.max(np.abs(got.nrmse - want.nrmse)) <= 1e-3, (got.nrmse, want.nrmse)
    np.testing.assert_array_equal(got.lam, want.lam)


def test_wdm_streaming_fast_state_method(narma_channels, wdm_streamed):
    """The WDM chunk loop also runs with the "fast" reservoir and the plain
    matmul fold."""
    res_j = _port(stream_chunk_k=CHUNK, state_method="fast",
                  readout_use_kernel=False).run(*narma_channels)
    assert np.max(np.abs(res_j.nrmse - wdm_streamed.nrmse)) <= 2e-3


def test_wdm_experiment_bf16_chunk_parity(chan_eq_channels):
    """bf16 state chunks stay within the documented band of the f32 streamed
    run on chan-eq, in the port as in the JAX package."""
    res32 = _port(stream_chunk_k=CHUNK).run(*chan_eq_channels)
    res16 = _port(stream_chunk_k=CHUNK, stream_state_dtype="bfloat16").run(*chan_eq_channels)
    assert np.max(np.abs(res16.nrmse - res32.nrmse)) <= BF16_NRMSE_TOL, (res16.nrmse,
                                                                          res32.nrmse)
    assert np.max(np.abs(res16.ser - res32.ser)) <= BF16_SER_TOL, (res16.ser, res32.ser)
    want = _jax(stream_chunk_k=CHUNK, stream_state_dtype="bfloat16").run(*chan_eq_channels)
    assert np.max(np.abs(res16.ser - want.ser)) <= BF16_SER_TOL, (res16.ser, want.ser)


def test_wdm_experiment_default_masks_and_validation():
    """Default per-channel masks are the reference's (make_mask seeded
    mask_seed + r); an explicit stack overrides them; bad shapes raise."""
    exp = _port(r=3)
    ref = JWDMExperiment(JConfig(model=JMR(), **_base()), 3)
    np.testing.assert_array_equal(exp.masks.numpy(), np.asarray(ref.masks))
    assert not torch.equal(exp.masks[0], exp.masks[1])
    custom = torch.stack([make_mask(32, seed=7)] * 3)
    assert torch.equal(_port(r=3, masks=custom).masks, custom)
    with pytest.raises(ValueError, match="masks"):
        _port(r=4, masks=custom)
    with pytest.raises(ValueError, match="channel rows"):
        exp.run(np.zeros((2, 100)), np.zeros((2, 100)), np.zeros((2, 50)), np.zeros((2, 50)))
    with pytest.raises(ValueError, match="n_channels"):
        _port(r=0)
    with pytest.raises(ValueError, match="streaming"):
        _port(r=2, shared=True)


def test_reference_masks_carry_across(narma_channels):
    """A reference WDMExperiment's [R, N] masks carried across as numpy
    (convert.mask_from_numpy) run the port's WDMExperiment as its own."""
    jexp = JWDMExperiment(JConfig(model=JMR(), **_base(mask_seed=5)), 4)
    masks = convert.mask_from_numpy(np.asarray(jexp.masks))
    assert tuple(masks.shape) == (4, 32) and masks.dtype == torch.float32
    got = _port(masks=masks, stream_chunk_k=CHUNK).run(*narma_channels)
    own = _port(mask_seed=5, stream_chunk_k=CHUNK).run(*narma_channels)
    np.testing.assert_array_equal(got.nrmse, own.nrmse)
    with pytest.raises(ValueError, match="mask"):
        convert.mask_from_numpy(np.zeros((2, 3, 4)))


def test_wdm_experiment_metrics_only(narma_channels, wdm_streamed):
    """collect_y_pred=False on the WDM path: metrics bitwise, y_pred None."""
    res_nc = _port(stream_chunk_k=CHUNK, collect_y_pred=False).run(*narma_channels)
    assert res_nc.y_pred is None and res_nc.batch == 4
    np.testing.assert_array_equal(res_nc.nrmse, wdm_streamed.nrmse)
    np.testing.assert_array_equal(res_nc.ser, wdm_streamed.ser)


# ---------------------------------------------------------------------------
# Shared readout
# ---------------------------------------------------------------------------


def _shared_inputs(r):
    rng = np.random.default_rng(5)
    j = torch.as_tensor(rng.uniform(0.05, 0.95, (r, 240)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((240,)), dtype=torch.float32)
    return j, y, _masks(r, 16, 20)


def test_shared_readout_matches_materialized_concat():
    """The shared streamed fit ≈ one Gram fit over the materialized [K, R·N]
    concatenated features: same λ, weights within the reference's 0.1, the
    carry bitwise the last state row of every channel."""
    r, w0 = 4, 24
    j, y, masks = _shared_inputs(r)
    lams = (1e-6, 1e-4)
    w_s, i_s, s_s = fit_ridge_streaming_shared(SiliconMR(), masks, j, y, washout=w0,
                                               chunk_k=CHUNK, lambdas=lams,
                                               state_method="fast", device="cpu")
    assert tuple(w_s.shape) == (r * 16 + 1, 1)
    st, fin = channel_states(SiliconMR(), j, masks, method="fast", return_final=True,
                             device="cpu")
    x = st.movedim(0, 1).reshape(240, r * 16)[w0:]
    w_m, i_m = fit_ridge(x, y[w0:], lambdas=lams, use_kernel=True, device="cpu")
    assert int(i_s) == int(i_m)
    np.testing.assert_allclose(w_s.numpy(), w_m.numpy(), atol=0.1, rtol=0.1)
    assert torch.equal(s_s, fin)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gram-op", "gram-plain"])
def test_shared_readout_r1_equals_per_channel(use_kernel):
    """At R = 1 the shared Gram has no cross terms: the shared fit IS the
    per-channel WDM fit, bitwise."""
    j, y, masks = _shared_inputs(1)
    kw = dict(washout=24, chunk_k=CHUNK, lambdas=(1e-6, 1e-4), state_method="kernel",
              use_kernel=use_kernel, device="cpu")
    w_s, i_s, s_s = fit_ridge_streaming_shared(SiliconMR(), masks, j, y, **kw)
    w_p, i_p, s_p = fit_ridge_streaming_wdm(SiliconMR(), masks, j, y[None], **kw)
    assert torch.equal(w_s, w_p[0]) and int(i_s) == int(i_p[0]) and torch.equal(s_s, s_p)


def test_wdm_shared_experiment_matches_reference():
    """WDMExperiment(shared_readout=True): ensemble-level shapes, a finite
    NRMSE, and the JAX package's NRMSE within 1e-3 at λ = 1e-4."""
    ds = jtasks.narma10(560, seed=3)
    r = 4
    tr = np.stack([ds.inputs_train] * r)
    te = np.stack([ds.inputs_test] * r)
    kw = dict(n_nodes=16, washout=24, stream_chunk_k=CHUNK, ridge_l2=(1e-4,))
    got = _port(r=r, shared=True, **kw).run(tr, ds.targets_train, te, ds.targets_test)
    assert got.nrmse.shape == (1,) and np.isfinite(got.nrmse).all()
    assert got.readout_w.shape == (1, r * 16 + 1)
    assert got.y_pred.shape == (1, ds.targets_test.shape[0])
    want = _jax(r=r, shared=True, **kw).run(tr, ds.targets_train, te, ds.targets_test)
    assert np.max(np.abs(got.nrmse - want.nrmse)) <= 1e-3, (got.nrmse, want.nrmse)


def test_wdm_shared_bad_arguments():
    j, y, masks = _shared_inputs(2)
    with pytest.raises(ValueError, match="masks must be"):
        fit_ridge_streaming_shared(SiliconMR(), masks[0], j, y, washout=4, chunk_k=16,
                                   device="cpu")
    with pytest.raises(ValueError, match="channels mismatch"):
        fit_ridge_streaming_shared(SiliconMR(), masks, j[:1], y, washout=4, chunk_k=16,
                                   device="cpu")
    with pytest.raises(ValueError, match="stream length"):
        fit_ridge_streaming_shared(SiliconMR(), masks, j, y[:-1], washout=4, chunk_k=16,
                                   device="cpu")


# ---------------------------------------------------------------------------
# The memory property: no [R, K, N] tensor
# ---------------------------------------------------------------------------


R, N, K_TR, K_TE, W0 = 3, 24, 300, 270, 40
LENGTHS = (K_TR, K_TE, K_TR - W0, 320)   # stream lengths, fit window, padded length


def _full_stream_shapes(shapes):
    return [s for s in shapes if set(s) & set(LENGTHS) and set(s) & {N, N + 1}]


@pytest.mark.parametrize("shared", [False, True], ids=["per_channel", "shared"])
def test_wdm_streaming_pipeline_holds_no_channel_state_tensor(shared):
    """Under a dispatch mode, the streamed WDM run (fit + eval; per-channel
    or shared readout) creates no tensor with a stream-long axis beside an
    N- or (N + 1)-long axis; its state blocks are chunk-sized; the
    materialized WDM run does create [R, K, N] tensors."""
    rng = np.random.default_rng(3)
    rows = 1 if shared else R
    args = [torch.as_tensor(a, dtype=torch.float32) for a in
            (rng.uniform(0, 1, (R, K_TR)), rng.uniform(0, 1, (rows, K_TR)),
             rng.uniform(0, 1, (R, K_TE)), rng.uniform(0, 1, (rows, K_TE)))]
    cfg = ExperimentConfig(model=SiliconMR(), **_base(n_nodes=N, washout=W0,
                                                      stream_chunk_k=CHUNK))
    masks = _masks(R, N, 30)
    with Trace() as rec:
        _run_pipeline(cfg, masks, *args, wdm=True, shared=shared)
    assert not _full_stream_shapes(rec.shapes)
    assert (R, CHUNK, N) in rec.shapes
    if not shared:
        with Trace() as rec_m:
            _run_pipeline(ExperimentConfig(model=SiliconMR(), **_base(n_nodes=N, washout=W0)),
                          masks, *args, wdm=True)
        assert (R, K_TR, N) in rec_m.shapes
