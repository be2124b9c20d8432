"""Error metrics (paper Section V.B) — numpy-only port of ``repro/core/metrics.py``."""

from __future__ import annotations

import numpy as np

# Variance floor of the NRMSE denominator, shared by the host metric below
# and the evaluation in pipeline/experiment.py: one constant so a
# zero-variance (constant) target yields the same finite value everywhere.
# 1e-30 is exactly representable in f32 (min normal ~1.2e-38), so the device
# paths can use it literally — a float64-only floor like 1e-300 would
# underflow to 0.0 in f32 and reintroduce the host/device disagreement.
VAR_EPS = 1e-30


def nrmse(y_true, y_pred) -> float:
    """Normalised root-mean-square error, paper Eq. (8).

    NRMSE = sqrt( Σ (y - ŷ)² / (N · σ²_y) ) — normalised by the *target*
    variance, so a constant predictor at the target mean scores 1.0.
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    var = np.var(y_true)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2) / (var + VAR_EPS)))


def memory_capacity_score(y_true, y_pred) -> float:
    """Linear memory capacity MC = Σ_d r²(y_d, ŷ_d)  (Jaeger 2001).

    ``y_true``/``y_pred`` are [T, D] stacks — channel d the d-step-delayed
    input u(k − d) and its reconstruction (core/tasks.memory_capacity) —
    and r² the squared Pearson correlation per delay channel.  Bounded by
    the number of delay channels D evaluated (and, for a reservoir, by its
    node count); a channel whose target or prediction is constant
    contributes 0, not NaN.  This is the capacity metric of the
    series-coupled-MR and delay-RC characterisation papers
    (arXiv:2308.15902, arXiv:2101.01664).
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.ndim == 1:
        y_true, y_pred = y_true[:, None], y_pred[:, None]
    t = y_true - y_true.mean(axis=0)
    p = y_pred - y_pred.mean(axis=0)
    cov = np.sum(t * p, axis=0)
    denom = np.sum(t * t, axis=0) * np.sum(p * p, axis=0)
    r2 = np.divide(cov * cov, denom, out=np.zeros_like(cov),
                   where=denom > 0.0)
    return float(np.sum(r2))


def ser(symbols_true, symbols_pred) -> float:
    """Symbol error rate: fraction of incorrectly reproduced symbols.

    Paper Eq. (9) as printed reads 'correct / total'; the standard metric
    (and the paper's Fig. 6, where lower is better) is 'incorrect / total' —
    we use the standard (DESIGN.md §7).
    """
    t = np.asarray(symbols_true)
    p = np.asarray(symbols_pred)
    return float(np.mean(t != p))
