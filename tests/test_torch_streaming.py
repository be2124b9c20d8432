"""Port parity: the streaming fused path (repro_torch.pipeline, DESIGN.md §8).

Mirrors tests/test_streaming.py case by case.  The same numpy inputs go
through the JAX package and the port on the CPU, where the port's kernel
wrappers take their plain versions.  The JAX side runs as its own tests
run it: the ``use_kernel=False`` einsum fold with the jnp ("fast")
reservoir, plus one interpret-mode Pallas case.

Tolerances:

* streamed vs materialized Gram fit, noise off: ≤1e-3 NRMSE and SER, the
  same λ (the reference's acceptance bar); weights atol/rtol 0.1 (f32 Gram
  sums in another order, amplified by λ down to 1e-8 — the reference's own
  bound);
* port vs JAX on the same streamed configuration: ≤1e-3 NRMSE and SER
  (diagonal noise is deterministic, so it holds to the same bar); s_end
  ≤1e-6 (the states' bound);
* bf16 state chunks vs f32 chunks: ≤0.06 NRMSE and ≤0.05 SER (DESIGN.md §9);
* within the port: chunk resume, λ = 1 forgetting and metrics-only vs
  collected runs are bitwise.

The jaxpr "no full-K tensor" guards of the reference become the shape
record of the port's contract tracer (``repro_torch.analysis.tracer.Trace``,
a dispatch mode that records every op's output shape, a kernel call as one
op) during a streamed CPU run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SiliconMR as JMR
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro.pipeline import fit_ridge_streaming as jfit_streaming
from repro.pipeline.ridge import _fold_chunk as jfold_chunk
from repro.pipeline.ridge import _plan_fold as jplan_fold
from repro_torch.analysis.tracer import Trace
from repro_torch.core import SiliconMR, generate_states, make_mask, tasks
from repro_torch.core.metrics import VAR_EPS, nrmse as host_nrmse
from repro_torch.pipeline import (Experiment, ExperimentConfig, fit_ridge_batched,
                                  fit_ridge_streaming, record_stages, with_bias)
from repro_torch.pipeline.experiment import (_eval_streaming, _run_pipeline,
                                             _streaming_metrics)
from repro_torch.pipeline.ridge import _fold_chunk, _plan_fold

LAMS = (1e-8, 1e-6, 1e-4)
CHUNK = 64
BF16_NRMSE_TOL = 0.06
BF16_SER_TOL = 0.05


def _stack(datasets):
    return tuple(np.stack([getattr(d, f) for d in datasets])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


@pytest.fixture(scope="module")
def narma_batch():
    """Four NARMA10 instances, 360/360 periods: 360 % 64 leaves a ragged
    last chunk of 40 in both splits."""
    return _stack([tasks.narma10(720, seed=s) for s in range(4)])


def _base(**kw):
    base = dict(n_nodes=32, washout=40, ridge_l2=LAMS, state_noise_rel=0.0,
                state_method="kernel", readout_use_kernel=True)
    base.update(kw)
    return base


def _port(**kw):
    return Experiment(ExperimentConfig(model=SiliconMR(), **_base(**kw)), device="cpu")


def _jax(**kw):
    kw = {"state_method": "fast", "readout_use_kernel": False, **kw}
    return JExperiment(JConfig(model=JMR(), **_base(**kw)))


def _two_ch(tg):
    return np.stack([tg, np.roll(tg, 1, axis=-1)], axis=-1)


# ---------------------------------------------------------------------------
# Fit-level parity
# ---------------------------------------------------------------------------


def _fit_inputs():
    rng = np.random.default_rng(5)
    b, k, n = 3, 200, 24
    return (rng.uniform(0, 1, (b, k)).astype(np.float32),
            rng.standard_normal((b, k)).astype(np.float32), make_mask(n, seed=1))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gram-op", "gram-plain"])
def test_fit_ridge_streaming_matches_materialized(use_kernel):
    """Chunked fit ≈ the materialized Gram fit (same λ, weights within the
    reference's 0.1), with s_end bitwise the last state row even when
    K % chunk_k != 0; and the JAX streamed fit gives the same λ and s_end."""
    j, y, mask = _fit_inputs()
    w0 = 30
    st = generate_states(SiliconMR(), j, mask, method="kernel", device="cpu")
    w_m, idx_m = fit_ridge_batched(st[:, w0:], y[:, w0:], lambdas=LAMS, use_kernel=True,
                                   device="cpu")
    for chunk in (64, 72):          # 200 % 72 != 0: a padded tail
        w_s, idx_s, s_end = fit_ridge_streaming(
            SiliconMR(), mask, j, y, washout=w0, chunk_k=chunk, lambdas=LAMS,
            use_kernel=use_kernel, device="cpu")
        assert torch.equal(s_end, st[:, -1])
        assert torch.equal(idx_s, idx_m)
        np.testing.assert_allclose(w_s.numpy(), w_m.numpy(), atol=0.1, rtol=0.1)
        w_j, idx_j, s_j = jfit_streaming(
            JMR(), jnp.asarray(mask.numpy()), jnp.asarray(j), jnp.asarray(y), washout=w0,
            chunk_k=chunk, lambdas=LAMS, state_method="fast", use_kernel=False)
        np.testing.assert_array_equal(idx_s.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(s_end.numpy(), np.asarray(s_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(w_s.numpy(), np.asarray(w_j), atol=0.1, rtol=0.1)


def test_fit_ridge_streaming_matches_pallas_interpret():
    """The JAX fit through both Pallas kernels in interpret mode (kernel
    reservoir, accumulate-into Gram) against the port's kernel path.  The
    25-feature reservoir Gram is ill-conditioned, so f32 sums in another
    order move single weights by up to ~0.015 (the reference's own bound is
    0.1); the fitted predictions on the states agree to 1e-2 (≈0.005
    measured, on values up to 1.4)."""
    j, y, mask = _fit_inputs()
    w_s, idx_s, s_end = fit_ridge_streaming(SiliconMR(), mask, j, y, washout=30, chunk_k=72,
                                            lambdas=(1e-4,), device="cpu")
    w_j, idx_j, s_j = jfit_streaming(JMR(), jnp.asarray(mask.numpy()), jnp.asarray(j),
                                     jnp.asarray(y), washout=30, chunk_k=72, lambdas=(1e-4,),
                                     state_method="kernel", use_kernel=True)
    np.testing.assert_array_equal(idx_s.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(s_end.numpy(), np.asarray(s_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w_s.numpy(), np.asarray(w_j), atol=0.1, rtol=0.1)
    x = with_bias(generate_states(SiliconMR(), j, mask, method="kernel", device="cpu"))
    pred = x @ w_s
    np.testing.assert_allclose(pred.numpy(), (x @ torch.as_tensor(np.asarray(w_j))).numpy(),
                               rtol=0, atol=1e-2)


def test_fit_ridge_streaming_rejects_bad_arguments():
    mask = make_mask(8, seed=1)
    j = torch.zeros((2, 30))
    with pytest.raises(ValueError, match="washout"):
        fit_ridge_streaming(SiliconMR(), mask, j, torch.zeros((2, 30)), washout=40,
                            chunk_k=16, device="cpu")
    with pytest.raises(ValueError, match="chunk_k"):
        fit_ridge_streaming(SiliconMR(), mask, j, torch.zeros((2, 30)), washout=4,
                            chunk_k=0, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        fit_ridge_streaming(SiliconMR(), mask, j, torch.zeros((2, 31)), washout=4,
                            chunk_k=16, device="cpu")
    with pytest.raises(NotImplementedError, match="kernel"):   # the default state_method
        fit_ridge_streaming(SiliconMR(), mask, j, torch.zeros((2, 30)), washout=4,
                            chunk_k=16, dev_params={"q": 1.0}, device="cpu")


# ---------------------------------------------------------------------------
# End-to-end parity through Experiment.run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def streamed(narma_batch):
    """The port's streamed run (kernel reservoir, Gram op), shared below."""
    return _port(stream_chunk_k=CHUNK).run(*narma_batch)


def test_streaming_experiment_parity(narma_batch, streamed):
    """Streamed == materialized Gram-path Experiment within 1e-3 NRMSE/SER
    and the same λ (noise off, ragged chunks); and == the JAX streamed run
    within 1e-3."""
    res_m = _port().run(*narma_batch)
    assert np.max(np.abs(streamed.nrmse - res_m.nrmse)) <= 1e-3, (streamed.nrmse, res_m.nrmse)
    assert np.max(np.abs(streamed.ser - res_m.ser)) <= 1e-3
    np.testing.assert_array_equal(streamed.lam, res_m.lam)
    assert streamed.y_pred.shape == res_m.y_pred.shape == (4, 360)
    want = _jax(stream_chunk_k=CHUNK).run(*narma_batch)
    assert np.max(np.abs(streamed.nrmse - want.nrmse)) <= 1e-3, (streamed.nrmse, want.nrmse)
    assert np.max(np.abs(streamed.ser - want.ser)) <= 1e-3
    np.testing.assert_array_equal(streamed.lam, want.lam)


def test_streaming_experiment_fast_state_method(narma_batch):
    """The chunk loop also runs with the "fast" reservoir and the plain
    matmul fold: streaming is a pipeline property, not a kernel mode."""
    res_s = _port(stream_chunk_k=CHUNK, state_method="fast",
                  readout_use_kernel=False).run(*narma_batch)
    res_m = _port(state_method="fast").run(*narma_batch)
    assert np.max(np.abs(res_s.nrmse - res_m.nrmse)) <= 2e-3


def test_streaming_multichannel(narma_batch, streamed):
    """C = 2 output channels through the streamed fit and the streamed eval."""
    tr_in, tr_tg, te_in, te_tg = narma_batch
    res1 = _port(stream_chunk_k=CHUNK, ridge_l2=(1e-4,)).run(*narma_batch)
    res2 = _port(stream_chunk_k=CHUNK, ridge_l2=(1e-4,)).run(tr_in, _two_ch(tr_tg), te_in,
                                                             _two_ch(te_tg))
    assert res2.y_pred.shape == (4, 360, 2)
    assert res2.readout_w.shape == (4, 33, 2)
    np.testing.assert_allclose(res2.y_pred[..., 0], res1.y_pred, atol=1e-5)
    want = _jax(stream_chunk_k=CHUNK, ridge_l2=(1e-4,)).run(tr_in, _two_ch(tr_tg), te_in,
                                                            _two_ch(te_tg))
    assert np.max(np.abs(res2.nrmse - want.nrmse)) <= 1e-3


@pytest.mark.parametrize("chunk", [CHUNK, 360], ids=["ragged", "aligned"])
def test_streaming_bf16_chunks_within_drift_bound(narma_batch, chunk):
    """bf16 state chunks vs f32 chunks: ≤0.06 NRMSE, ≤0.05 SER — in the port
    and in the JAX package alike; and the two bf16 runs agree to the same
    bound.  With chunk 360 the train split ends on a chunk end, so the
    train -> test carry is the f32 kernel carry."""
    f32 = _port(stream_chunk_k=chunk).run(*narma_batch)
    b16 = _port(stream_chunk_k=chunk, stream_state_dtype="bfloat16").run(*narma_batch)
    assert np.max(np.abs(b16.nrmse - f32.nrmse)) <= BF16_NRMSE_TOL, (b16.nrmse, f32.nrmse)
    assert np.max(np.abs(b16.ser - f32.ser)) <= BF16_SER_TOL
    want = _jax(stream_chunk_k=chunk, stream_state_dtype="bfloat16").run(*narma_batch)
    assert np.max(np.abs(b16.nrmse - want.nrmse)) <= BF16_NRMSE_TOL, (b16.nrmse, want.nrmse)
    assert np.max(np.abs(b16.ser - want.ser)) <= BF16_SER_TOL


# ---------------------------------------------------------------------------
# Diagonal noise mode (noise as its expected Tikhonov diagonal)
# ---------------------------------------------------------------------------


def test_streaming_diagonal_noise(narma_batch):
    """The σ²·T·I-regularised streamed fit: deterministic, so it matches the
    JAX diagonal-noise run within 1e-3; within the reference's band; and
    within 0.1 of the materialized sampled-noise fit (expectation vs one
    draw)."""
    kw = dict(state_noise_rel=0.003, state_noise_mode="diagonal")
    res_s = _port(stream_chunk_k=CHUNK, **kw).run(*narma_batch)
    want = _jax(stream_chunk_k=CHUNK, **kw).run(*narma_batch)
    assert np.max(np.abs(res_s.nrmse - want.nrmse)) <= 1e-3, (res_s.nrmse, want.nrmse)
    np.testing.assert_array_equal(res_s.lam, want.lam)
    assert np.all(res_s.nrmse < 0.85) and np.all(res_s.nrmse > 0.2), res_s.nrmse
    res_m = _port(state_noise_rel=0.003).run(*narma_batch)
    assert np.max(np.abs(res_s.nrmse - res_m.nrmse)) < 0.1, (res_s.nrmse, res_m.nrmse)


def test_noise_mode_validation():
    with pytest.raises(ValueError, match="diagonal"):
        ExperimentConfig(**_base(stream_chunk_k=64, state_noise_rel=0.003))
    with pytest.raises(ValueError, match="streaming"):
        ExperimentConfig(state_noise_rel=0.003, state_noise_mode="diagonal")
    with pytest.raises(ValueError, match="state_noise_mode"):
        ExperimentConfig(state_noise_mode="bogus")
    with pytest.raises(ValueError, match="set stream_chunk_k"):
        ExperimentConfig(stream_state_dtype="bfloat16")
    # noise off: the mode is irrelevant on both routes
    ExperimentConfig(**_base(stream_chunk_k=64))
    ExperimentConfig(state_noise_rel=0.0, state_noise_mode="diagonal")
    assert ExperimentConfig(stream_chunk_k=8, state_noise_rel=0.0,
                            stream_state_dtype="bfloat16")._stream_state_dtype_arg == "bfloat16"
    assert ExperimentConfig()._stream_state_dtype_arg is None


# ---------------------------------------------------------------------------
# The fold: f32 targets, forgetting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False], ids=["gram-op", "gram-plain"])
def test_fold_keeps_f32_targets_beside_bf16_chunks(use_kernel):
    """bf16 X with f32 targets that bf16 cannot hold: c matches the f32
    Xᵀy to f32 round-off, not to bf16's (the reference's fold hands its
    kernel f32 targets)."""
    rng = np.random.default_rng(3)
    b, t, f = 2, 48, 9
    x = torch.as_tensor(rng.uniform(-1, 1, (b, t, f)), dtype=torch.float32).to(torch.bfloat16)
    y = torch.as_tensor(1.0 + rng.uniform(0, 1, (b, t, 1)) * 2.0 ** -12, dtype=torch.float32)
    assert not torch.equal(y.to(torch.bfloat16).float(), y)
    plan = _plan_fold(f, t, use_kernel=use_kernel, block_t=16)
    g = torch.zeros((b, f, f))
    c = torch.zeros((b, f, 1))
    _, c, _ = _fold_chunk(plan, g, c, torch.zeros(b), x, y)
    x64, y64 = x.double(), y.double()
    want = x64.mT @ y64
    rounded = x64.mT @ y.to(torch.bfloat16).double()
    err = float((c.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    assert float((rounded - want).abs().max()) > 100 * err


def test_fold_forgetting_matches_jax_and_closed_form():
    """The λ-decayed fold == the JAX fold and Σᵢ λ^(n-1-i)·XᵢᵀXᵢ in float64;
    λ = 1.0 is bitwise the plain accumulation."""
    f, ch, c, n_chunks, lam, b = 9, 6, 2, 4, 0.9, 3
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_chunks, b, ch, f)).astype(np.float32)
    y = rng.standard_normal((n_chunks, b, ch, c)).astype(np.float32)
    plan = _plan_fold(f, ch, use_kernel=False, block_t=512)
    jplan = jplan_fold(f, ch, use_kernel=False, block_t=512, block_f=128, state_dtype=None)

    def fold_all(forgetting):
        g, cv, y2 = torch.zeros((b, f, f)), torch.zeros((b, f, c)), torch.zeros(b)
        jg, jc, jy2 = jnp.zeros((b, f, f)), jnp.zeros((b, f, c)), jnp.zeros(b)
        for xi, yi in zip(x, y):
            g, cv, y2 = _fold_chunk(plan, g, cv, y2, torch.as_tensor(xi), torch.as_tensor(yi),
                                    forgetting=forgetting)
            jg, jc, jy2 = jfold_chunk(jplan, jg, jc, jy2, jnp.asarray(xi), jnp.asarray(yi),
                                      forgetting=forgetting)
        for got, want in ((g, jg), (cv, jc), (y2, jy2)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        return g, cv, y2

    g, cv, y2 = fold_all(lam)
    wts = lam ** np.arange(n_chunks - 1, -1, -1, dtype=np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    np.testing.assert_allclose(g.numpy(), np.einsum("n,nbtf,nbtg->bfg", wts, x64, x64),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y2.numpy(), np.einsum("n,nbtc->b", wts, y64 * y64),
                               rtol=1e-4, atol=1e-4)
    g1, c1, y21 = fold_all(1.0)
    plain = torch.zeros((b, f, f))
    for xi in x:
        xt = torch.as_tensor(xi)
        plain.baddbmm_(xt.mT, xt)
    assert torch.equal(g1, plain)


def test_forgetting_fit_matches_reference_and_one_is_bitwise():
    """forgetting=1.0 is bitwise the default fit within the port; 0.9 picks
    the JAX package's λ and s_end; the bad values raise."""
    j, y, mask = _fit_inputs()
    kw = dict(washout=24, chunk_k=24, lambdas=LAMS, state_method="fast", device="cpu")
    w_a, i_a, s_a = fit_ridge_streaming(SiliconMR(), mask, j, y, **kw)
    w_b, i_b, s_b = fit_ridge_streaming(SiliconMR(), mask, j, y, forgetting=1.0, **kw)
    assert torch.equal(w_a, w_b) and torch.equal(i_a, i_b) and torch.equal(s_a, s_b)
    w_f, i_f, s_f = fit_ridge_streaming(SiliconMR(), mask, j, y, forgetting=0.9, **kw)
    assert not torch.equal(w_f, w_a)
    w_j, i_j, s_j = jfit_streaming(JMR(), jnp.asarray(mask.numpy()), jnp.asarray(j),
                                   jnp.asarray(y), washout=24, chunk_k=24, lambdas=LAMS,
                                   state_method="fast", use_kernel=False, forgetting=0.9)
    np.testing.assert_array_equal(i_f.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_f.numpy(), np.asarray(s_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w_f.numpy(), np.asarray(w_j), atol=0.1, rtol=0.1)
    with pytest.raises(ValueError, match="forgetting"):
        fit_ridge_streaming(SiliconMR(), mask, j, y, forgetting=0.0, **kw)
    with pytest.raises(ValueError, match="noise_rel"):
        fit_ridge_streaming(SiliconMR(), mask, j, y, forgetting=0.9, noise_rel=0.01, **kw)


# ---------------------------------------------------------------------------
# Metrics-only evaluation and the streamed metrics
# ---------------------------------------------------------------------------


def test_streaming_metrics_only_matches_collected(narma_batch, streamed):
    """collect_y_pred=False: y_pred None, every metric bitwise equal."""
    res_nc = _port(stream_chunk_k=CHUNK, collect_y_pred=False).run(*narma_batch)
    assert res_nc.y_pred is None and res_nc.batch == streamed.batch
    np.testing.assert_array_equal(res_nc.nrmse, streamed.nrmse)
    np.testing.assert_array_equal(res_nc.ser, streamed.ser)
    np.testing.assert_array_equal(res_nc.lam, streamed.lam)
    np.testing.assert_array_equal(res_nc.readout_w, streamed.readout_w)


def test_streaming_metrics_large_mean_target(narma_batch):
    """The in-loop variance is shifted by the first sample, so a target on a
    DC offset of 200 keeps its variance: the streamed NRMSE is within 2 % of
    the float64 host metric on the very predictions the run emitted."""
    tr_in, tr_tg, te_in, te_tg = narma_batch
    off = 200.0
    res = _port(stream_chunk_k=CHUNK).run(tr_in, tr_tg + off, te_in, te_tg + off)
    assert np.all(np.isfinite(res.nrmse))
    for i in range(te_tg.shape[0]):
        host = host_nrmse(te_tg[i] + off, res.y_pred[i])
        assert abs(res.nrmse[i] - host) / host < 0.02, (i, res.nrmse[i], host)


def test_streaming_metrics_zero_variance_targets(narma_batch):
    """Constant test targets: var clamps to 0 and NRMSE is the VAR_EPS-floored
    value — finite, and bitwise equal between metrics-only and collected."""
    tr_in, tr_tg, te_in, te_tg = narma_batch
    const = np.full_like(te_tg, 0.6)
    res = _port(stream_chunk_k=CHUNK).run(tr_in, tr_tg, te_in, const)
    res_nc = _port(stream_chunk_k=CHUNK, collect_y_pred=False).run(tr_in, tr_tg, te_in, const)
    assert res_nc.y_pred is None and np.all(np.isfinite(res.nrmse))
    np.testing.assert_array_equal(res_nc.nrmse, res.nrmse)
    np.testing.assert_array_equal(res_nc.ser, res.ser)
    for i in range(te_tg.shape[0]):
        mse = np.mean((res.y_pred[i].astype(np.float64) - 0.6) ** 2)
        np.testing.assert_allclose(res.nrmse[i], np.sqrt(mse / VAR_EPS), rtol=1e-3)


def test_streaming_metrics_channel_mean_nrmse_under_chunking(narma_batch):
    """C = 2 channels with a ~1600x variance mismatch through a ragged chunk
    grid: NRMSE is the mean of per-channel NRMSEs, not a pooled one."""
    tr_in, tr_tg, te_in, te_tg = narma_batch

    def two_ch(tg):
        return np.stack([tg, 40.0 * tg + 7.0], axis=-1)

    kw = dict(stream_chunk_k=96, ridge_l2=(1e-4,))
    assert te_in.shape[1] % 96 != 0
    args = (tr_in, two_ch(tr_tg), te_in, two_ch(te_tg))
    res = _port(**kw).run(*args)
    res_nc = _port(collect_y_pred=False, **kw).run(*args)
    np.testing.assert_array_equal(res_nc.nrmse, res.nrmse)
    np.testing.assert_array_equal(res_nc.ser, res.ser)
    y = two_ch(te_tg).astype(np.float64)
    yp = res.y_pred.astype(np.float64)
    gold = np.mean(np.sqrt(np.mean((yp - y) ** 2, axis=1) / (np.var(y, axis=1) + VAR_EPS)),
                   axis=-1)
    np.testing.assert_allclose(res.nrmse, gold, rtol=1e-3)
    pooled = np.sqrt(np.mean((yp - y) ** 2, axis=(1, 2)) / (np.var(y, axis=(1, 2)) + VAR_EPS))
    assert np.all(res.nrmse > 2.0 * pooled), (res.nrmse, pooled)
    want = _jax(**kw).run(*args)
    assert np.max(np.abs(res.nrmse - want.nrmse)) <= 1e-3


def test_streaming_ser_ignores_padded_tail():
    """t_test = 129 with chunk 128: the padded rows of the last chunk add no
    symbol mismatch and the SER divides by t_test.  A bias-only readout pins
    ŷ ≡ 2 (symbol 1) everywhere."""
    b, n, t_test = 2, 8, 129
    cfg = ExperimentConfig(**_base(n_nodes=n, stream_chunk_k=128, collect_y_pred=False,
                                   state_method="fast", readout_use_kernel=False))
    mask = make_mask(n, seed=2)
    j_te = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (b, t_test)),
                           dtype=torch.float32)
    w_fit = torch.zeros((b, n + 1, 1))
    w_fit[:, -1, 0] = 2.0
    def states_fn(j_c, s):
        return generate_states(SiliconMR(), j_c, mask, s0=s, method="fast",
                               return_final=True, device="cpu")

    for tgt, want in ((1.0, 0.0), (-3.0, 1.0)):
        te_tg3 = torch.full((b, t_test, 1), tgt)
        y_raw, acc = _eval_streaming(cfg, states_fn, j_te, te_tg3, w_fit, torch.zeros((b, n)))
        assert y_raw is None
        nrmse, ser = _streaming_metrics(acc, t_test, channel_axis=False)
        np.testing.assert_array_equal(ser.numpy(), np.full((b,), want, np.float32))
        assert torch.all(torch.isfinite(nrmse))


def test_streaming_stage_marks(narma_batch, streamed):
    """record_stages of a streamed run: the chunk loop (with its state and
    fold stages summed over chunks), the solve and the streamed eval; the
    recorded run gives the same numbers."""
    with record_stages() as seconds:
        timed = _port(stream_chunk_k=CHUNK).run(*narma_batch)
    assert set(seconds) == {"input_layer", "stream_fit", "stream_states", "stream_fold",
                            "solve", "stream_eval", "pack"}
    assert seconds["stream_states"] + seconds["stream_fold"] <= seconds["stream_fit"]
    np.testing.assert_array_equal(timed.nrmse, streamed.nrmse)


# ---------------------------------------------------------------------------
# The memory property: no full-K state tensor, no prediction block
# ---------------------------------------------------------------------------


def _full_stream_shapes(shapes, lengths, widths):
    return [s for s in shapes if set(s) & set(lengths) and set(s) & set(widths)]


# B = 3, N = 24, chunk 64, K_train = 300, K_test = 270 (both ragged): none of
# the stream lengths (300, 270, their fit window 260 and padded length 320)
# equals another dimension of the run.
B, N, K_TR, K_TE, W0 = 3, 24, 300, 270, 40
LENGTHS = (K_TR, K_TE, K_TR - W0, 320)


def _stream_batch(c=1):
    rng = np.random.default_rng(9)
    arrs = [rng.uniform(0, 1, (B, K_TR)), rng.uniform(0, 1, (B, K_TR, c)),
            rng.uniform(0, 1, (B, K_TE)), rng.uniform(0, 1, (B, K_TE, c))]
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrs]


def test_streaming_fit_holds_no_full_stream_state_tensor():
    """Under a dispatch mode, the streamed fit creates no tensor with a
    stream-long axis beside an N- or (N + 1)-long axis, and its largest
    state block is the chunk; the materialized fit does create one."""
    j, y = _stream_batch()[:2]
    mask = make_mask(N, seed=1)
    with Trace() as rec:
        fit_ridge_streaming(SiliconMR(), mask, j, y, washout=W0, chunk_k=CHUNK,
                            lambdas=(1e-6,), device="cpu")
    assert not _full_stream_shapes(rec.shapes, LENGTHS, (N, N + 1))
    assert (B, CHUNK, N) in rec.shapes and (B, CHUNK, N + 1) in rec.shapes
    with Trace() as rec_m:
        st = generate_states(SiliconMR(), j, mask, method="kernel", device="cpu")
        fit_ridge_batched(st[:, W0:], y[:, W0:], use_kernel=True, device="cpu")
    assert _full_stream_shapes(rec_m.shapes, LENGTHS, (N, N + 1))


@pytest.mark.parametrize("collect", [False, True], ids=["metrics_only", "collected"])
def test_streaming_pipeline_holds_no_state_or_prediction_block(collect):
    """The whole streamed Experiment (fit + eval, C = 2 targets) creates no
    full-stream state tensor in either mode; with collect_y_pred=False no
    [B, T_test, C] prediction block either, while the collected run does
    build one."""
    args = _stream_batch(c=2)
    cfg = ExperimentConfig(model=SiliconMR(), **_base(n_nodes=N, washout=W0,
                                                      stream_chunk_k=CHUNK,
                                                      collect_y_pred=collect))
    mask = make_mask(N, seed=1)
    with Trace() as rec:
        out = _run_pipeline(cfg, mask, *args)
    assert not _full_stream_shapes(rec.shapes, LENGTHS, (N, N + 1))
    preds = [s for s in rec.shapes if len(s) == 3 and s[-1] == 2 and s[1] in (K_TE, 320)]
    assert bool(preds) == collect, preds
    assert (out[0] is None) != collect
