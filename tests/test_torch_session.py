"""Port parity: online sessions (repro_torch.pipeline.session, DESIGN.md §10).

Counterparts of tests/test_serving.py's session cases.  The same numpy
inputs go through the JAX package and the port on the CPU, where the
port's kernel wrappers take their plain versions.

Tolerances:

* within the port, bitwise: λ = 1.0 forgetting is the default fold; a
  chunk-aligned session equals ``fit_ridge_streaming`` over the
  concatenated stream (w, λ index and carry) at λ ∈ {1.0, 0.99}, on both
  fold ops; the chunked scan resumes exactly; predictions ignore the
  current targets; rows past ``n_valid`` change nothing; a reset zeroes
  only its rows.  The session's per-row mask [B, chunk] and the streaming
  fit's [chunk] mask hold the same values, and the session's sample count
  ``tcnt`` is the streaming fit's T_fit at λ = 1 as an exact f32 integer,
  so both hold bitwise;
* the forgetting fold against its float64 closed form: rtol/atol 1e-4
  (the reference's bound);
* port vs JAX ``session_step`` over ticks, from a reference slab carried
  across with ``session_state_from_reference``: the carry ≤1e-5 (f32
  states through several chunks), the Gram statistics ≤1e-4 relative to
  their scale, predictions ≤1e-3 (the readouts are solved from Grams that
  differ by f32 round-off, λ down to 1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SiliconMR as JMR
from repro.core.masking import make_mask as jmake_mask
from repro.pipeline.session import SessionConfig as JSessionConfig
from repro.pipeline.session import session_init as jsession_init
from repro.pipeline.session import session_step as jsession_step
from repro_torch.analysis.tracer import Trace
from repro_torch.convert import session_config_from_reference, session_state_from_reference
from repro_torch.core import SiliconMR, generate_states, make_mask
from repro_torch.pipeline import fit_ridge_streaming, with_bias
from repro_torch.pipeline.ridge import _fold_chunk, _plan_fold
from repro_torch.pipeline.session import (SessionConfig, SessionState, _session_step,
                                          session_health, session_init, session_predict,
                                          session_reset, session_solve, session_step,
                                          session_update)

MODEL = SiliconMR()
N, B, K, WASH = 16, 3, 96, 24
LAMS = (1e-8, 1e-6, 1e-4)
MASK = make_mask(N, seed=3)


def _stream(seed: int, k: int = K, b: int = B):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32)


def _cfg(**kw) -> SessionConfig:
    base = dict(model=MODEL, n_nodes=N, washout=WASH, ridge_l2=LAMS,
                chunk_k=24, state_method="kernel", use_kernel=False)
    base.update(kw)
    return SessionConfig(**base)


def _fit(j, y, **kw):
    base = dict(washout=WASH, chunk_k=24, lambdas=LAMS, state_method="kernel",
                use_kernel=False, device="cpu")
    base.update(kw)
    return fit_ridge_streaming(MODEL, MASK, j, y, **base)


def _assert_states_equal(a: SessionState, b: SessionState):
    for name, la, lb in zip(SessionState._fields, a, b):
        assert la.dtype == lb.dtype, name
        assert torch.equal(la, lb), name


# ---------------------------------------------------------------------------
# forgetting-factor streaming fit
# ---------------------------------------------------------------------------


def test_forgetting_one_is_default_and_validated():
    j, y = _stream(0), _stream(1)
    w_a, idx_a, s_a = _fit(j, y)
    w_b, idx_b, s_b = _fit(j, y, forgetting=1.0)
    assert torch.equal(w_a, w_b) and torch.equal(idx_a, idx_b) and torch.equal(s_a, s_b)
    with pytest.raises(ValueError, match="forgetting"):
        _fit(j, y, forgetting=0.0)
    with pytest.raises(ValueError, match="noise_rel"):
        _fit(j, y, forgetting=0.9, noise_rel=0.01)
    for bad in (dict(forgetting=0.0), dict(forgetting=1.5), dict(chunk_k=0),
                dict(refresh_every=0), dict(block_s=3), dict(block_f=0), dict(block_t=0)):
        with pytest.raises(ValueError):
            _cfg(**bad)
        if "block" not in next(iter(bad)):
            with pytest.raises(ValueError):
                JSessionConfig(**{**dict(n_nodes=N), **bad})


def test_forgetting_downweights_early_chunks():
    """With λ < 1 the fit tracks the LATE part of a stream whose target
    mapping flips mid-way."""
    j = _stream(3, k=2 * K)
    x = with_bias(generate_states(MODEL, j, MASK, method="fast", device="cpu"))
    rng = np.random.default_rng(7)
    w_a = torch.tensor(rng.standard_normal((N + 1,)), dtype=torch.float32)
    w_b = torch.tensor(rng.standard_normal((N + 1,)), dtype=torch.float32)
    y = torch.cat([x[:, :K] @ w_a, x[:, K:] @ w_b], dim=1)

    def late_err(forgetting):
        w, _, _ = _fit(j, y, lambdas=(1e-6,), forgetting=forgetting)
        pred = (x[:, K:] @ w)[..., 0]
        return float(torch.mean((pred - y[:, K:]) ** 2))

    assert late_err(0.5) < 0.25 * late_err(1.0)
    assert late_err(0.9) < late_err(1.0)


def test_forgetting_fold_matches_closed_form():
    """λ-folds over chunks == float64 Σᵢ λ^(n-1-i)·XᵢᵀXᵢ; λ = 1.0 is
    bitwise plain accumulation."""
    f, ch, c, n_chunks, lam = 9, 6, 2, 4, 0.9
    plan = _plan_fold(f, ch, use_kernel=False, block_t=512)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_chunks, B, ch, f)).astype(np.float32)
    y = rng.standard_normal((n_chunks, B, ch, c)).astype(np.float32)

    def fold_all(forgetting):
        g, cv = torch.zeros((B, f, f)), torch.zeros((B, f, c))
        y2 = torch.zeros((B,))
        for xi, yi in zip(x, y):
            g, cv, y2 = _fold_chunk(plan, g, cv, y2, torch.tensor(xi), torch.tensor(yi),
                                    forgetting=forgetting)
        return g.numpy(), cv.numpy(), y2.numpy()

    g, cv, y2 = fold_all(lam)
    w = lam ** np.arange(n_chunks - 1, -1, -1, dtype=np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    np.testing.assert_allclose(g, np.einsum("n,nbtf,nbtg->bfg", w, x64, x64),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cv, np.einsum("n,nbtf,nbtc->bfc", w, x64, y64),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y2, np.einsum("n,nbtc->b", w, y64 * y64), rtol=1e-4, atol=1e-4)
    g1 = fold_all(1.0)[0]
    g_ref = sum((torch.tensor(xi).mT @ torch.tensor(xi)).numpy() for xi in x)
    np.testing.assert_array_equal(g1, g_ref)


# ---------------------------------------------------------------------------
# sessions == streaming fit, resumability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lam", [1.0, 0.99])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_session_scan_bitwise_matches_streaming_fit(lam, use_kernel):
    """Chunk-aligned session updates + one solve == fit_ridge_streaming,
    bitwise (w, λ index, carry), through the port's own fold and solve."""
    chunk = 24
    j, y = _stream(5), _stream(6)
    w_ref, idx_ref, s_ref = _fit(j, y, chunk_k=chunk, use_kernel=use_kernel, forgetting=lam)
    cfg = _cfg(chunk_k=chunk, forgetting=lam, use_kernel=use_kernel)
    state = session_init(cfg, B, device="cpu")
    for lo in range(0, K, chunk):
        state = session_update(cfg, MASK, state, j[:, lo:lo + chunk], y[:, lo:lo + chunk])
    state = session_solve(cfg, state)
    assert state.g.shape == (B, N + 1, N + 1)           # no TPU padding
    assert torch.equal(w_ref, state.w)
    assert torch.equal(idx_ref.to(torch.int32), state.lam_idx)
    assert torch.equal(s_ref, state.s)


def test_session_chunked_resume_bit_exact_fixed_splits():
    """Hand-picked uneven splits of a session stream resume bitwise: a
    session fed [4 + 4] chunks through a fresh state rebuilt from the first
    half's leaves equals one fed all 8, and the reservoir scan resumes from
    its carry exactly at any split."""
    j = _stream(9, k=30)
    full, fin = generate_states(MODEL, j, MASK, method="kernel", return_final=True,
                                device="cpu")
    for cuts in ([7], [1, 11, 12], [5, 13, 21, 29]):
        bounds = [0] + cuts + [30]
        s = torch.zeros((B, N))
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            states, s = generate_states(MODEL, j[:, lo:hi], MASK, s0=s, method="kernel",
                                        return_final=True, device="cpu")
            parts.append(states)
        assert torch.equal(torch.cat(parts, dim=1), full) and torch.equal(s, fin)

    cfg = _cfg(chunk_k=12, forgetting=0.99)
    jj, yy = _stream(20, k=96), _stream(21, k=96)

    def run(state, lo, hi):
        for t in range(lo, hi):
            sl = slice(12 * t, 12 * (t + 1))
            _, state = session_step(cfg, MASK, state, jj[:, sl], yy[:, sl],
                                    refresh=t % 2 == 1)
        return state

    one = run(session_init(cfg, B, device="cpu"), 0, 8)
    half = run(session_init(cfg, B, device="cpu"), 0, 4)
    rebuilt = SessionState(*(torch.tensor(leaf.numpy()) for leaf in half))
    _assert_states_equal(run(rebuilt, 4, 8), one)


def test_session_step_predictions_ignore_current_targets():
    """Honest online inference: the tick-t prediction uses the readout from
    ticks < t only."""
    cfg = _cfg()
    j, y = _stream(10), _stream(11)
    st = session_init(cfg, B, device="cpu")
    ck = cfg.chunk_k
    for lo in range(0, K, ck):
        jc, yc = j[:, lo:lo + ck], y[:, lo:lo + ck]
        ya, st_next = session_step(cfg, MASK, st, jc, yc, refresh=True)
        yb, _ = session_step(cfg, MASK, st, jc, 1e6 * torch.ones_like(yc), refresh=True)
        assert torch.equal(ya, yb)
        st = st_next


def test_session_step_predict_then_update_order():
    """A target outlier in chunk t moves predictions from chunk t+1 on."""
    cfg = _cfg(refresh_every=1)
    j, y = _stream(12), _stream(13)
    ck = cfg.chunk_k

    def run(y_used):
        st = session_init(cfg, B, device="cpu")
        preds = []
        for lo in range(0, K, ck):
            p, st = session_step(cfg, MASK, st, j[:, lo:lo + ck], y_used[:, lo:lo + ck],
                                 refresh=True)
            preds.append(p)
        return preds

    y_bad = y.clone()
    y_bad[:, ck:2 * ck] += 100.0
    pa, pb = run(y), run(y_bad)
    assert torch.equal(pa[0], pb[0]) and torch.equal(pa[1], pb[1])
    assert float((pa[2] - pb[2]).abs().max()) > 1.0


def test_session_ragged_chunk_tail_independence():
    """Rows past n_valid do not affect the statistics."""
    cfg = _cfg()
    j, y = _stream(14), _stream(15)
    ck = cfg.chunk_k
    nv = torch.tensor([ck, ck // 2, ck // 3], dtype=torch.int32)
    st0 = session_init(cfg, B, device="cpu")
    a = session_update(cfg, MASK, st0, j[:, :ck], y[:, :ck], n_valid=nv)
    keep = torch.arange(ck)[None, :] < nv[:, None]
    b = session_update(cfg, MASK, st0, j[:, :ck],
                       torch.where(keep, y[:, :ck], 1e9), n_valid=nv)
    for name in ("g", "c", "y2", "tcnt"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_session_reset_clears_only_flagged_rows():
    cfg = _cfg()
    j, y = _stream(16), _stream(17)
    st = session_init(cfg, B, device="cpu")
    _, st = session_step(cfg, MASK, st, j[:, :24], y[:, :24], refresh=True)
    st2 = session_reset(st, [True, False, False])
    for leaf, leaf2 in zip(st, st2):
        assert not torch.any(leaf2[0])
        assert torch.equal(leaf2[1:], leaf[1:])
    assert torch.any(st.s[0])                           # the input is unchanged


def test_session_predict_advances_carry_without_learning():
    cfg = _cfg()
    j, y = _stream(18), _stream(19)
    st = session_init(cfg, B, device="cpu")
    _, st = session_step(cfg, MASK, st, j[:, :24], y[:, :24], refresh=True)
    y_hat, st2 = session_predict(cfg, MASK, st, j[:, 24:48])
    assert y_hat.shape == (B, 24, 1)
    assert torch.equal(st2.g, st.g) and torch.equal(st2.tcnt, st.tcnt)
    assert int(st2.step[0]) == int(st.step[0]) + 24
    assert not torch.equal(st2.s, st.s)


def test_session_step_updates_the_handed_slab_in_place():
    """``_session_step`` folds into the slab it is handed (the reference
    server's donation); ``session_step`` leaves its input unchanged and
    gives the same result."""
    cfg = _cfg(use_kernel=True)
    j, y = _stream(22), _stream(23)
    st = session_init(cfg, B, device="cpu")
    _, st = session_step(cfg, MASK, st, j[:, :24], y[:, :24], refresh=True)
    g_before = st.g.clone()
    ya, sa = session_step(cfg, MASK, st, j[:, 24:48], y[:, 24:48])
    assert torch.equal(st.g, g_before)
    g_ptr = st.g.data_ptr()
    yb, sb = _session_step(cfg, MASK, st, j[:, 24:48], y[:, 24:48])
    assert sb.g.data_ptr() == g_ptr and not torch.equal(st.g, g_before)
    assert torch.equal(ya, yb)
    _assert_states_equal(sa, sb)


# ---------------------------------------------------------------------------
# the step holds no full-stream tensor; the fold's limits are checked up front
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh", [False, True])
def test_session_step_holds_no_full_stream_tensor(refresh):
    """Every tensor a step makes is at most chunk-sized per row: none holds
    a period axis longer than the chunk (the stream is 4096 periods), and
    none is larger than two feature-width chunks of the slab."""
    b, ck, stream_len = 8, 32, 4096
    cfg = _cfg(chunk_k=ck, use_kernel=True)
    j, y = _stream(24, k=stream_len, b=b), _stream(25, k=stream_len, b=b)
    state = session_init(cfg, b, device="cpu")
    with Trace() as log:
        _session_step(cfg, MASK, state, j[:, :ck], y[:, :ck], refresh=refresh)
    assert log.shapes
    assert not any(stream_len in s for s in log.shapes)
    largest = max(int(np.prod(s)) for s in log.shapes)
    assert largest <= max(2 * b * ck * (N + 1), b * (N + 1) ** 2 * len(LAMS))


def test_fold_plan_checks_the_kernel_limits_up_front():
    """The accumulate-into Gram fold takes ≤ 128 target columns and
    ≤ 65535 instances: a session config, a session slab or a streaming fit
    beyond either raises before any chunk runs; the matmul fold has no
    such limit."""
    with pytest.raises(ValueError, match="target columns"):
        _cfg(use_kernel=True, n_channels=129)
    _cfg(use_kernel=False, n_channels=129)
    cfg = _cfg(use_kernel=True)
    with pytest.raises(ValueError, match="65535 instances"):
        session_init(cfg, 65536, device="cpu")
    session_init(_cfg(n_nodes=1), 65536, device="cpu")
    j = torch.zeros((2, 48))
    with pytest.raises(ValueError, match="target columns"):
        _fit(j, torch.zeros((2, 48, 129)), use_kernel=True)
    with pytest.raises(ValueError, match="65535 instances"):
        fit_ridge_streaming(SiliconMR(), make_mask(1), torch.zeros((65536, 48)),
                            torch.zeros((65536, 48)), washout=WASH, chunk_k=24,
                            use_kernel=True, device="cpu")
    with pytest.raises(ValueError, match="block_t"):
        _plan_fold(5, 8, use_kernel=False, block_t=0)


def test_session_health_flags_non_finite_rows():
    cfg = _cfg()
    st = session_init(cfg, B, device="cpu")
    st.g[1, 0, 0] = float("nan")
    st.w[2, 3, 0] = float("inf")
    assert session_health(st).tolist() == [True, False, False]
    y_hat = torch.zeros((B, 24, 1))
    y_hat[0, 5, 0] = float("nan")
    assert session_health(st, y_hat).tolist() == [False, False, False]


# ---------------------------------------------------------------------------
# the port against the JAX session step
# ---------------------------------------------------------------------------


def test_session_step_matches_reference_from_a_converted_slab():
    """Three JAX ticks make a slab; it crosses with
    ``session_state_from_reference`` and both packages run three more
    ticks on the same chunks.  The config crosses field by field."""
    jcfg = JSessionConfig(model=JMR(), n_nodes=N, washout=WASH, ridge_l2=LAMS, chunk_k=24,
                          forgetting=0.99, refresh_every=2, state_method="fast")
    cfg = session_config_from_reference(jcfg)
    assert cfg == _cfg(forgetting=0.99, refresh_every=2, state_method="fast")
    cfg = _cfg(forgetting=0.99, refresh_every=2, use_kernel=True)
    jmask = jnp.asarray(jmake_mask(N, seed=3))
    assert np.array_equal(np.asarray(jmask), MASK.numpy())
    j, y = _stream(30, k=6 * 24), _stream(31, k=6 * 24)
    jj, jy = jnp.asarray(j.numpy()), jnp.asarray(y.numpy())
    jst = jsession_init(jcfg, B)
    for t in range(3):
        _, jst = jsession_step(jcfg, jmask, jst, jj[:, 24 * t:24 * (t + 1)],
                               jy[:, 24 * t:24 * (t + 1)], refresh=t % 2 == 0)
    st = session_state_from_reference(jst, device="cpu")
    for name, a, b in zip(SessionState._fields, jst, st):
        np.testing.assert_array_equal(np.asarray(a)[tuple(slice(0, n) for n in b.shape)],
                                      b.numpy(), err_msg=name)
    for t in range(3, 6):
        sl = slice(24 * t, 24 * (t + 1))
        jy_hat, jst = jsession_step(jcfg, jmask, jst, jj[:, sl], jy[:, sl],
                                    refresh=t % 2 == 0)
        y_hat, st = session_step(cfg, MASK, st, j[:, sl], y[:, sl], refresh=t % 2 == 0)
        np.testing.assert_allclose(y_hat.numpy(), np.asarray(jy_hat), atol=1e-3)
    np.testing.assert_allclose(st.s.numpy(), np.asarray(jst.s), atol=1e-5)
    f = N + 1
    g_ref = np.asarray(jst.g)[:, :f, :f]
    np.testing.assert_allclose(st.g.numpy(), g_ref, atol=1e-4 * np.abs(g_ref).max())
    np.testing.assert_allclose(st.y2.numpy(), np.asarray(jst.y2), rtol=1e-5)
    for name in ("tcnt", "lam_idx", "step", "quarantined", "poison"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)),
                                      err_msg=name)
