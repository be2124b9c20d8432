"""Port parity: fault injection, quarantine and the chaos soak
(repro_torch.robustness, DESIGN.md §12).

Counterparts of tests/test_robustness.py.  The same numpy inputs go
through the JAX package and the port on the CPU (the port's kernel
wrappers take their plain versions).

Tolerances:

* within the port, bitwise: the neutral spec is an identity of the step;
  healthy rows of a faulted slab equal the clean run; a fault window is
  invisible outside it; the guard is invisible on clean data; stochastic
  draws replay exactly for the same (seed, tag, tick);
* deterministic faults (stuck node, detuning, droop, saturation) against
  the reference's transforms: ≤1e-6 relative (f32 sin/exp in two
  libraries);
* probability-1 poisoning faults: the same quarantine ticks and counts as
  the reference (the draw cannot matter);
* stochastic faults: the port's draws come from its own counter-based
  hash, not ``jax.random``: the fault rate of each is within 5 binomial
  standard deviations of its probability, as the reference's is, and the
  soak outcome (quarantined rows, finite output, isolation) agrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SiliconMR as JMR
from repro.pipeline.session import SessionConfig as JSessionConfig
from repro.robustness import inject_carry as jinject_carry
from repro.robustness import inject_inputs as jinject_inputs
from repro.robustness import no_faults as jno_faults
from repro.robustness import on_rows as jon_rows
from repro.robustness import run_soak as jrun_soak
from repro_torch.convert import fault_spec_from_reference
from repro_torch.core import SiliconMR, make_mask
from repro_torch.pipeline.ridge import guard_readout
from repro_torch.pipeline.session import SessionConfig, session_init, session_step
from repro_torch.robustness import (faulted_rows, faulty_step, inject_carry, inject_inputs,
                                    make_streams, no_faults, on_rows, run_soak)
from repro_torch.robustness.faults import _uniform

N, B, WASH, CHUNK = 16, 4, 24, 24
LAMS = (1e-8, 1e-6, 1e-4)
MASK = make_mask(N, seed=3)


def _cfg(**kw) -> SessionConfig:
    base = dict(model=SiliconMR(), n_nodes=N, washout=WASH, ridge_l2=LAMS,
                chunk_k=CHUNK, refresh_every=2, state_method="kernel", use_kernel=True)
    base.update(kw)
    return SessionConfig(**base)


def _spec(b=B):
    return no_faults(b, device="cpu")


def _chunks(seed: int, ticks: int, b: int = B, k: int = CHUNK):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0, 1, (b, ticks * k)), dtype=torch.float32),
            torch.tensor(rng.uniform(0, 1, (b, ticks * k)), dtype=torch.float32))


def _run_clean(cfg, j, y, ticks):
    st = session_init(cfg, B, device="cpu")
    outs = []
    for t in range(ticks):
        sl = slice(t * cfg.chunk_k, (t + 1) * cfg.chunk_k)
        yh, st = session_step(cfg, MASK, st, j[:, sl], y[:, sl],
                              refresh=(t % cfg.refresh_every) == 0)
        outs.append(yh)
    return torch.cat(outs, dim=1), st


def _run_faulted(cfg, spec, j, y, ticks, seed=0):
    st = session_init(cfg, B, device="cpu")
    outs = []
    for t in range(ticks):
        sl = slice(t * cfg.chunk_k, (t + 1) * cfg.chunk_k)
        yh, st = faulty_step(cfg, MASK, spec, st, j[:, sl], y[:, sl], t, seed=seed,
                             refresh=(t % cfg.refresh_every) == 0)
        outs.append(yh)
    return torch.cat(outs, dim=1), st


# ---------------------------------------------------------------------------
# fault harness: neutrality, targeting, the reference's transforms
# ---------------------------------------------------------------------------


def test_neutral_spec_is_bitwise_identity():
    cfg = _cfg()
    j, y = _chunks(0, 4)
    yh_a, st_a = _run_clean(cfg, j, y, 4)
    yh_b, st_b = _run_faulted(cfg, _spec(), j, y, 4)
    assert torch.equal(yh_a, yh_b)
    for la, lb in zip(st_a, st_b):
        assert torch.equal(la, lb)


def test_injectors_neutral_and_targeted():
    spec = _spec()
    rng = np.random.default_rng(1)
    jc = torch.tensor(rng.uniform(0, 1, (B, CHUNK)), dtype=torch.float32)
    jc[2, 4] = float("nan")            # the identity keeps a NaN a NaN
    s = torch.tensor(rng.standard_normal((B, N)), dtype=torch.float32)
    assert torch.equal(inject_inputs(spec, jc, 3).isnan(), jc.isnan())
    assert torch.equal(torch.nan_to_num(inject_inputs(spec, jc, 3)), torch.nan_to_num(jc))
    assert torch.equal(inject_carry(spec, s, 3), s)
    armed = on_rows(spec, [1], stuck_node=2, stuck_value=0.5)
    out = inject_carry(armed, s, 3).clone()
    assert out[1, 2] == 0.5
    out[1, 2] = s[1, 2]
    assert torch.equal(out, s)
    assert faulted_rows(armed).tolist() == [False, True, False, False]
    assert faulted_rows(spec).tolist() == [False] * B


def test_fault_window_gates_injection():
    spec = on_rows(_spec(), [0], nan_prob=1.0, from_tick=2, until_tick=3)
    rng = np.random.default_rng(2)
    jc = torch.tensor(rng.uniform(0, 1, (B, CHUNK)), dtype=torch.float32)
    for tick, fires in ((0, False), (1, False), (2, True), (3, False)):
        out = inject_inputs(spec, jc, tick)
        assert bool(out[0].isnan().any()) == fires, tick
        assert torch.equal(out[1:], jc[1:])


def test_deterministic_faults_match_reference():
    """Stuck node, thermal detuning, laser droop and saturation are pure
    functions of the spec and the tick: the port's transforms give the
    reference's values; the spec crosses with fault_spec_from_reference."""
    jspec = jon_rows(jno_faults(B), [0], stuck_node=3, stuck_value=0.5)
    jspec = jon_rows(jspec, [1], detune_amp=0.5, detune_period=64.0)
    jspec = jon_rows(jspec, [2], droop_rate=0.02)
    jspec = jon_rows(jspec, [3], sat_level=0.3, from_tick=1)
    spec = fault_spec_from_reference(jspec, device="cpu")
    for name, a, b in zip(spec._fields, jspec, spec):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    rng = np.random.default_rng(3)
    jc = rng.uniform(0, 1, (B, CHUNK)).astype(np.float32)
    s = rng.standard_normal((B, N)).astype(np.float32)
    for tick in (0, 1, 5, 40):
        np.testing.assert_allclose(inject_inputs(spec, torch.tensor(jc), tick).numpy(),
                                   np.asarray(jinject_inputs(jspec, jnp.asarray(jc), tick)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(inject_carry(spec, torch.tensor(s), tick).numpy(),
                                      np.asarray(jinject_carry(jspec, jnp.asarray(s), tick)))


def test_stochastic_draws_replay_and_match_reference_statistics():
    """The same (seed, tag, tick) replay the same draws; another seed or
    tick draws anew; each fault fires at its probability, as the
    reference's draws do (5 binomial standard deviations)."""
    u1 = _uniform(11, 0, 7, (64, 256), "cpu")
    assert torch.equal(u1, _uniform(11, 0, 7, (64, 256), "cpu"))
    assert not torch.equal(u1, _uniform(12, 0, 7, (64, 256), "cpu"))
    assert not torch.equal(u1, _uniform(11, 0, 8, (64, 256), "cpu"))
    assert not torch.equal(u1, _uniform(11, 1, 7, (64, 256), "cpu"))
    assert 0.0 <= float(u1.min()) and float(u1.max()) < 1.0
    assert abs(float(u1.mean()) - 0.5) < 5 * (1 / 12 / u1.numel()) ** 0.5
    b, k, ticks = 32, 64, 8
    jc = np.full((b, k), 0.5, np.float32)
    s = np.ones((b, N), np.float32)
    spec = on_rows(no_faults(b, device="cpu"), list(range(b)), nan_prob=0.1, inf_prob=0.05,
                   corrupt_prob=0.3)
    jspec = jon_rows(jno_faults(b), list(range(b)), nan_prob=0.1, inf_prob=0.05,
                     corrupt_prob=0.3)
    rates = {"port": [], "reference": []}
    for name, inj_in, inj_carry, sp, wrap in (
            ("port", inject_inputs, inject_carry, spec, torch.tensor),
            ("reference", jinject_inputs, jinject_carry, jspec, jnp.asarray)):
        outs = [np.asarray(inj_in(sp, wrap(jc), t, seed=5)) for t in range(ticks)]
        rows = [np.asarray(inj_carry(sp, wrap(s), t, seed=5)) for t in range(ticks)]
        out = np.stack(outs)
        rates[name] = [np.isnan(out).mean(), np.isposinf(out).mean(),
                       np.isnan(np.stack(rows)[..., 0]).mean()]
    n_in, n_rows = ticks * b * k, ticks * b
    for name, got in rates.items():
        for p, rate, n in zip((0.1, 0.05, 0.3), got, (n_in, n_in, n_rows)):
            assert abs(rate - p) < 5 * (p * (1 - p) / n) ** 0.5, (name, p, rate)
    a, b = (inject_inputs(spec, torch.tensor(jc), 3, seed=5) for _ in range(2))
    assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.isinf(), b.isinf())


# ---------------------------------------------------------------------------
# quarantine: containment + isolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", [dict(nan_prob=1.0), dict(inf_prob=1.0),
                                   dict(corrupt_prob=1.0)])
def test_poison_quarantines_row_and_isolates_neighbours(fault):
    cfg = _cfg()
    j, y = _chunks(3, 3)
    yh_clean, st_clean = _run_clean(cfg, j, y, 3)
    yh, st = _run_faulted(cfg, on_rows(_spec(), [1], **fault), j, y, 3)
    assert bool(st.quarantined[1]) and int(st.poison[1]) == 3
    assert bool(torch.isfinite(yh).all())
    assert not torch.any(yh[1])
    assert float(st.s[1].sum()) == 0 and int(st.step[1]) == 0
    ok = torch.tensor([True, False, True, True])
    assert torch.equal(yh[ok], yh_clean[ok])
    for la, lb in zip(st_clean, st):
        assert torch.equal(la[ok], lb[ok])


def test_degradation_faults_perturb_without_quarantine():
    cfg = _cfg()
    j, y = _chunks(4, 5)
    yh_clean, _ = _run_clean(cfg, j, y, 5)
    spec = on_rows(_spec(), [0], stuck_node=3, stuck_value=0.5)
    spec = on_rows(spec, [1], detune_amp=0.5, detune_period=64.0)
    spec = on_rows(spec, [2], droop_rate=0.02)
    spec = on_rows(spec, [3], sat_level=0.3)
    yh, st = _run_faulted(cfg, spec, j, y, 5)
    assert bool(torch.isfinite(yh).all())
    assert not bool(st.quarantined.any()) and int(st.poison.sum()) == 0
    for i in range(B):
        assert not torch.equal(yh[i], yh_clean[i]), i


def test_quarantined_slot_reconverges_after_window():
    """Poison for 4 ticks, clean tail -> learns again; the port's soak
    report agrees with the reference's on the quarantine record, and both
    re-converge below the gate."""
    kw = dict(n_nodes=24, washout=32, chunk_k=32, ridge_l2=LAMS, refresh_every=2)
    cfg = _cfg(**kw)
    spec = on_rows(_spec(), [2], corrupt_prob=1.0, until_tick=4)
    rep = run_soak(cfg, spec, n_ticks=24)
    assert rep["healthy_bitwise_identical"]
    assert rep["output_all_finite"]
    assert rep["quarantine_events"] == [0, 0, 4, 0]
    assert rep["quarantine_ticks"][2] == [0, 1, 2, 3]
    assert rep["tail_ser_faulty"] < 0.5
    assert rep["tail_ser_faulty"] <= rep["tail_ser_clean"] + 0.15
    jrep = jrun_soak(JSessionConfig(model=JMR(), state_method="fast", **kw),
                     jon_rows(jno_faults(B), [2], corrupt_prob=1.0, until_tick=4), n_ticks=24)
    for key in ("faulty_rows", "quarantine_events", "quarantine_ticks",
                "healthy_bitwise_identical", "output_all_finite"):
        assert rep[key] == jrep[key], key
    assert abs(rep["tail_ser_clean"] - jrep["tail_ser_clean"]) <= 0.02
    assert abs(rep["tail_ser_faulty"] - jrep["tail_ser_faulty"]) <= 0.05


def test_stochastic_soak_outcome_matches_reference():
    """NaN ticks at probability 0.2 on one row: both packages quarantine
    that row and only that row, emit only finite values, and keep the
    healthy rows bitwise (their own clean runs)."""
    kw = dict(n_nodes=16, washout=24, chunk_k=24, ridge_l2=(1e-6, 1e-4), refresh_every=2)
    rep = run_soak(_cfg(**kw), on_rows(_spec(), [1], nan_prob=0.2, until_tick=6), n_ticks=10,
                   seed=3)
    jrep = jrun_soak(JSessionConfig(model=JMR(), state_method="fast", **kw),
                     jon_rows(jno_faults(B), [1], nan_prob=0.2, until_tick=6), n_ticks=10,
                     seed=3)
    for r in (rep, jrep):
        assert r["healthy_bitwise_identical"] and r["output_all_finite"]
        assert r["faulty_rows"] == [1]
        assert r["quarantine_events"][1] >= 1 and r["quarantine_events"][::2] == [0, 0]
    # a NaN drive sample poisons the row the tick it lands: with 24 draws a
    # tick at p = 0.2 every armed tick fires (1 - 0.8^24 ≈ 0.995)
    assert rep["quarantine_ticks"][1] == jrep["quarantine_ticks"][1] == list(range(6))


def test_soak_streams_match_reference():
    from repro.robustness import make_streams as jmake_streams

    for a, b in zip(make_streams(3, 100, seed=4), jmake_streams(3, 100, seed=4)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_guard_off_documents_the_failure_mode():
    cfg = _cfg(guard=False)
    j, y = _chunks(5, 3)
    yh, st = _run_faulted(cfg, on_rows(_spec(), [1], nan_prob=1.0, until_tick=1), j, y, 3)
    assert bool(yh[1].isnan().any())
    assert bool(st.g[1].isnan().any())
    assert bool(torch.isfinite(yh[[0, 2, 3]]).all())


def test_guard_readout_falls_back_per_row():
    rng = np.random.default_rng(6)
    w_new = torch.tensor(rng.standard_normal((3, 5, 1)), dtype=torch.float32)
    w_new[1, 0, 0] = float("nan")
    idx_new = torch.tensor([2, 2, 0], dtype=torch.int32)
    w_last = torch.tensor(rng.standard_normal((3, 5, 1)), dtype=torch.float32)
    idx_last = torch.tensor([1, 1, 1], dtype=torch.int32)
    w, idx = guard_readout(w_new, idx_new, w_last, idx_last)
    assert torch.equal(w[0], w_new[0]) and torch.equal(w[1], w_last[1])
    assert torch.equal(w[2], w_new[2])
    assert idx.tolist() == [2, 1, 0]


@pytest.mark.parametrize("kernel", [False, True])
def test_guard_bitwise_invisible_on_clean_data(kernel):
    kw = dict(state_method="kernel" if kernel else "fast", use_kernel=kernel)
    j, y = _chunks(7, 3)
    yh_a, st_a = _run_clean(_cfg(**kw), j, y, 3)
    yh_b, st_b = _run_clean(_cfg(guard=False, **kw), j, y, 3)
    assert torch.equal(yh_a, yh_b)
    for name, la, lb in zip(st_a._fields, st_a, st_b):
        assert torch.equal(la, lb), name


def test_stochastic_soak_replays_identically():
    """Two soaks with the same seeds give the same report: the faults are
    a pure function of (seed, tag, tick), which kill-and-restore needs."""
    kw = dict(n_nodes=8, washout=8, chunk_k=8, ridge_l2=(1e-4,), refresh_every=2)
    spec = on_rows(no_faults(2, device="cpu"), [0], nan_prob=0.05, corrupt_prob=0.3,
                   until_tick=3)
    a = run_soak(_cfg(**kw), spec, n_ticks=4, seed=1)
    assert a == run_soak(_cfg(**kw), spec, n_ticks=4, seed=1)
    assert a["output_all_finite"] and a["healthy_bitwise_identical"]
