"""Benchmark task datasets (paper Section V) — port of ``repro/core/tasks.py``.

A numpy-only copy: the reference module is numpy too, but importing it goes
through ``repro/core/__init__.py``, which pulls in jax.  The generators run
the reference's float64 ops (Santa Fe's batched over seeds), so the same
seeds give bitwise-equal datasets (NARMA10's deterministic redraw on
divergence included).

* NARMA10 — Eq. (10); inputs i(k) ~ U[0, 0.5].  2000 samples: 1000 train /
  1000 test, as in the paper.
* Santa Fe dataset-A surrogate — Haken–Lorenz laser intensity, quantised to
  8-bit counts; 6000 samples: 4000 train / 2000 test.
* Nonlinear channel equalisation — Eq. (11-12); 4-level symbols through a
  linear-ISI + cubic channel with AWGN; 9000 symbols: 6000 train / 3000 test.
* Memory-capacity probes (linear MC, delayed XOR, parity).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Input series + aligned targets, split into train/test."""

    inputs_train: np.ndarray
    targets_train: np.ndarray
    inputs_test: np.ndarray
    targets_test: np.ndarray
    name: str = ""

    @property
    def n_train(self) -> int:
        return self.inputs_train.shape[0]


# NARMA10 recursion escape detection: bounded trajectories stay well under 1
# (the test suite pins max < 2.0); once |y| passes this bound the quadratic
# term has taken over and the run goes to inf within a few steps.
_NARMA_DIVERGENCE_BOUND = 10.0
_NARMA_MAX_REDRAWS = 16


def _narma10_recursion(i: np.ndarray) -> np.ndarray:
    """The raw Eq. (10) recursion; diverges for unlucky input draws."""
    n = i.shape[0]
    y = np.zeros(n)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(9, n - 1):
            y[k + 1] = (
                0.3 * y[k]
                + 0.05 * y[k] * np.sum(y[k - 9 : k + 1])
                + 1.5 * i[k] * i[k - 9]
                + 0.1
            )
            if not np.isfinite(y[k + 1]) or abs(y[k + 1]) > _NARMA_DIVERGENCE_BOUND:
                y[k + 1 :] = np.inf      # flag divergence; caller redraws
                break
    return y


def narma10(n_samples: int = 2000, *, train_frac: float = 0.5, seed: int = 0) -> Dataset:
    """NARMA10 (paper Eq. (10)): y(k+1) = 0.3y(k) + 0.05y(k)Σ₉y(k-i) + 1.5i(k)i(k-9) + 0.1.

    The NARMA10 recursion is not globally stable: for unlucky uniform input
    draws the quadratic term wins and y escapes to inf, which would silently
    poison a batched seed sweep (every instance shares one run, so a
    single inf row corrupts batch reductions).  Divergent draws are detected
    (|y| > 10, or non-finite) and the inputs re-drawn — deterministically
    from ``(seed, attempt)``, with attempt 0 reproducing the historical
    single-draw stream bit-for-bit — up to a bounded number of retries.
    """
    warm = 50
    n = n_samples + warm
    for attempt in range(_NARMA_MAX_REDRAWS):
        # attempt 0 must equal the pre-guard behavior: default_rng(seed)
        rng = np.random.default_rng(seed if attempt == 0 else (seed, attempt))
        i = rng.uniform(0.0, 0.5, size=n)
        y = _narma10_recursion(i)
        if np.isfinite(y).all():
            break
    else:
        raise RuntimeError(
            f"narma10(seed={seed}) diverged on {_NARMA_MAX_REDRAWS} "
            f"consecutive input draws — the recursion escape bound "
            f"{_NARMA_DIVERGENCE_BOUND} should make this astronomically rare")
    i, y = i[warm:], y[warm:]
    split = int(n_samples * train_frac)
    return Dataset(i[:split], y[:split], i[split:], y[split:], name="narma10")


def santa_fe(n_samples: int = 6000, *, train_frac: float = 4000 / 6000, seed: int = 0) -> Dataset:
    """Santa Fe-A surrogate: Haken–Lorenz laser intensity, one-step-ahead target.

    ẋ = σ(y−x), ẏ = (r−z)x − y, ż = xy − bz;  intensity ∝ x².  Parameters in
    the chaotic spiking regime of the NH3 laser model.  RK4, subsampled, then
    scaled to 8-bit counts (0..255) like the original recording.
    """
    i_tr, y_tr, i_te, y_te = (x[0] for x in santa_fe_seeds(n_samples, [seed],
                                                           train_frac=train_frac))
    return Dataset(i_tr, y_tr, i_te, y_te, name="santa_fe")


def santa_fe_seeds(n_samples: int, seeds, *, train_frac: float = 4000 / 6000):
    """:func:`santa_fe` of every seed in ``seeds`` at once: the reference's
    float64 RK4 ops on a [3, S] state stack (a column a seed, each seeded by
    ``default_rng(seed)``), so the host loop runs once, not S times; every
    column is bitwise the reference's one-seed series.  Returns the
    (inputs_train, targets_train, inputs_test, targets_test) of the stacked
    seeds, each [S, T]."""
    sigma, r, b = 2.0, 15.0, 0.25
    dt, sub = 0.04, 12
    warm = 2000
    state = np.stack([np.array([1.0, 1.0, 1.0])
                      + 0.1 * np.random.default_rng(s).standard_normal(3) for s in seeds],
                     axis=1)

    def deriv(s):
        x, y, z = s
        return np.array([sigma * (y - x), (r - z) * x - y, x * y - b * z])

    total = warm + n_samples + 1
    out = np.empty((total, state.shape[1]))
    for k in range(total):
        for _ in range(sub):
            k1 = deriv(state)
            k2 = deriv(state + 0.5 * dt * k1)
            k3 = deriv(state + 0.5 * dt * k2)
            k4 = deriv(state + dt * k3)
            state = state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out[k] = state[0] ** 2
    out = out[warm:]
    out = np.round(255.0 * (out - out.min(axis=0)) / (np.ptp(out, axis=0) + 1e-12)).T
    i, y = out[:, :-1], out[:, 1:]
    split = int(n_samples * train_frac)
    return i[:, :split], y[:, :split], i[:, split:], y[:, split:]


SYMBOLS = np.array([-3.0, -1.0, 1.0, 3.0])

# Linear-ISI taps of the Jaeger & Haas channel (paper Eq. (11)):
# q(n) = Σ_off w_off · d(n + off), taps n+2 .. n-7.
_CHAN_EQ_TAPS = {2: 0.08, 1: -0.12, 0: 1.0, -1: 0.18, -2: -0.1, -3: 0.09,
                 -4: -0.05, -5: 0.04, -6: 0.03, -7: 0.01}


# Post-drift link of channel_equalization_drift: the multipath changes — the
# first post-cursor echo flips sign and strengthens, the pre-cursor and
# second echo grow.  A readout equalising the old link misreads this one.
_CHAN_EQ_TAPS_DRIFTED = {**_CHAN_EQ_TAPS, 1: 0.20, -1: -0.25, -2: 0.15}


def _chan_eq_clean(d: np.ndarray, taps=_CHAN_EQ_TAPS) -> np.ndarray:
    """Noise-free received signal: linear ISI + cubic distortion (Eq. (11-12))."""
    q = np.zeros(d.shape[0])
    for off, w in taps.items():
        q += w * np.roll(d, -off)  # q(n) += w * d(n + off)
    return q + 0.036 * q**2 - 0.011 * q**3


def channel_equalization(
    n_symbols: int = 9000, *, snr_db: float = 24.0, train_frac: float = 6000 / 9000, seed: int = 0
) -> Dataset:
    """Nonlinear channel equalisation (paper Eq. (11-12), from Jaeger & Haas).

    d(n) i.i.d. over {-3,-1,1,3}; linear ISI q(n) over taps n+2..n-7; cubic
    distortion + AWGN.  Input to the reservoir is the received x(n); the
    target is the transmitted d(n).
    """
    rng = np.random.default_rng(seed)
    pad = 16
    n = n_symbols + 2 * pad
    d = rng.choice(SYMBOLS, size=n)
    x = _chan_eq_clean(d)
    sig_p = np.mean(x**2)
    noise_p = sig_p / (10.0 ** (snr_db / 10.0))
    x = x + rng.normal(0.0, np.sqrt(noise_p), size=n)
    d, x = d[pad:-pad], x[pad:-pad]
    split = int(n_symbols * train_frac)
    return Dataset(x[:split], d[:split], x[split:], d[split:], name=f"chan_eq_snr{snr_db:g}")


def channel_equalization_drift(
    n_symbols: int = 6000, *, snr_db: float = 28.0, snr_db_after: float = 16.0,
    drift_frac: float = 0.5, drift_taps: bool = True, train_frac: float = 0.0,
    seed: int = 0,
) -> Dataset:
    """Channel equalisation with a mid-stream link drift (online workload).

    Same ISI + cubic channel family as :func:`channel_equalization`, but at
    ``drift_frac`` of the stream the link changes: the AWGN power steps from
    ``snr_db`` to ``snr_db_after`` and (``drift_taps=True``) the multipath
    taps switch to ``_CHAN_EQ_TAPS_DRIFTED`` — the canonical drifting-link
    scenario where a forgetting-factor readout (pipeline/session, DESIGN.md
    §10) must out-track a λ = 1 one: the old link's equaliser misreads the
    new echoes, and the plain running Gram keeps it anchored there.  The
    default ``train_frac=0`` puts the whole stream in the test split: the
    intended consumer is the online session API, which learns as it serves
    (examples/online_equalization.py).
    """
    if not 0.0 < drift_frac < 1.0:
        raise ValueError(f"drift_frac must be in (0, 1), got {drift_frac}")
    rng = np.random.default_rng(seed)
    pad = 16
    n = n_symbols + 2 * pad
    d = rng.choice(SYMBOLS, size=n)
    k_step = pad + int(n_symbols * drift_frac)
    before = np.arange(n) < k_step
    taps_after = _CHAN_EQ_TAPS_DRIFTED if drift_taps else _CHAN_EQ_TAPS
    x_before = _chan_eq_clean(d)
    x = np.where(before, x_before, _chan_eq_clean(d, taps_after))
    # SNR referenced to the ORIGINAL link's clean power, so the pre-drift
    # segment is independent of what the link later drifts to
    sig_p = np.mean(x_before**2)
    sigma = np.where(before,
                     np.sqrt(sig_p / 10.0 ** (snr_db / 10.0)),
                     np.sqrt(sig_p / 10.0 ** (snr_db_after / 10.0)))
    x = x + sigma * rng.standard_normal(n)
    d, x = d[pad:-pad], x[pad:-pad]
    split = int(n_symbols * train_frac)
    return Dataset(x[:split], d[:split], x[split:], d[split:],
                   name=f"chan_eq_drift_snr{snr_db:g}to{snr_db_after:g}")


# ---------------------------------------------------------------------------
# Memory-capacity task suite (arXiv:2308.15902 / arXiv:2101.01664)
# ---------------------------------------------------------------------------
#
# The composed-reservoir payoff (core/graph.py, DESIGN.md §13) is *memory*,
# not just regression accuracy — deep chains and series-coupled loops are
# reported to hold inputs longer than one loop of the same total node count.
# These canonical characterisation tasks quantify that: linear MC (how many
# delayed copies of the input the readout can reconstruct), delayed XOR and
# parity (nonlinear memory — products of delayed bits).  All targets ride
# the pipeline's [T, C] multi-channel convention, so one batched Experiment
# evaluates every delay channel of every instance in a single run and
# `metrics.memory_capacity_score` reduces the predictions to the MC number.


def memory_capacity(
    n_samples: int = 2400, *, max_delay: int = 40, train_frac: float = 0.5,
    seed: int = 0,
) -> Dataset:
    """Linear memory-capacity probe (Jaeger 2001; arXiv:2308.15902 §IV).

    Input u(k) i.i.d. ~ U[0, 1]; target channel d (of ``max_delay``) is the
    delayed copy u(k − d), d = 1..max_delay — targets [T, max_delay].  The
    readout reconstructs every delay simultaneously (one multi-channel
    ridge fit); MC = Σ_d r²(u(k−d), ŷ_d) over the *test* split
    (``metrics.memory_capacity_score``).  ``max_delay`` bounds the curve —
    size it past the memory you expect (MC saturates below it).
    """
    if max_delay < 1:
        raise ValueError(f"max_delay must be >= 1, got {max_delay}")
    rng = np.random.default_rng(seed)
    n = n_samples + max_delay
    u = rng.uniform(0.0, 1.0, size=n)
    # y[k, d-1] = u[k - d], built on the warm prefix so every row is real
    y = np.stack([u[max_delay - d : n - d] for d in range(1, max_delay + 1)],
                 axis=1)
    u = u[max_delay:]
    split = int(n_samples * train_frac)
    return Dataset(u[:split], y[:split], u[split:], y[split:],
                   name=f"memory_capacity_d{max_delay}")


def delayed_xor(
    n_samples: int = 2400, *, delay: int = 2, train_frac: float = 0.5,
    seed: int = 0,
) -> Dataset:
    """Delayed-XOR probe: y(k) = u(k) XOR u(k − delay), u(k) ∈ {0, 1}.

    XOR is not linearly separable in (u(k), u(k−delay)), so reconstructing
    it needs *nonlinear* memory — the reservoir must mix the two bits, not
    just hold them (arXiv:2101.01664's XOR task).  Inputs are the raw bit
    stream; targets in {0, 1}.
    """
    if delay < 1:
        raise ValueError(f"delay must be >= 1, got {delay}")
    rng = np.random.default_rng(seed)
    n = n_samples + delay
    u = rng.integers(0, 2, size=n).astype(np.float64)
    y = np.logical_xor(u[delay:] > 0.5, u[:-delay] > 0.5).astype(np.float64)
    u = u[delay:]
    split = int(n_samples * train_frac)
    return Dataset(u[:split], y[:split], u[split:], y[split:],
                   name=f"delayed_xor_d{delay}")


def parity(
    n_samples: int = 2400, *, order: int = 3, delay: int = 1,
    train_frac: float = 0.5, seed: int = 0,
) -> Dataset:
    """Parity-``order`` probe: y(k) = Π_{m<order} b(k − delay − m), b ∈ {−1, +1}.

    The standard PAR-n nonlinear-memory benchmark: the product of ``order``
    consecutive ±1 bits starting ``delay`` steps back.  Each extra order
    multiplies in another delayed bit, so PAR-n needs n-way nonlinear
    mixing across the delay line.  Inputs are the ±1 bit stream mapped to
    {0, 1} drive levels ((b + 1)/2 — optical intensities are
    non-negative); targets stay ±1.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if delay < 0:
        raise ValueError(f"delay must be >= 0, got {delay}")
    rng = np.random.default_rng(seed)
    warm = delay + order
    n = n_samples + warm
    b = rng.choice([-1.0, 1.0], size=n)
    y = np.ones(n)
    for m in range(order):
        y *= np.roll(b, delay + m)
    u = (b + 1.0) / 2.0
    u, y = u[warm:], y[warm:]
    split = int(n_samples * train_frac)
    return Dataset(u[:split], y[:split], u[split:], y[split:],
                   name=f"parity_{order}_d{delay}")


def quantize_symbols(y: np.ndarray) -> np.ndarray:
    """Map regression outputs to the nearest 4-PAM symbol."""
    y = np.asarray(y)
    return SYMBOLS[np.argmin(np.abs(y[..., None] - SYMBOLS[None, :]), axis=-1)]
