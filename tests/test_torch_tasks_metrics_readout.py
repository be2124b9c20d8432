"""Port parity: datasets, metrics and the host readout.

Datasets are numpy in both packages and must be bitwise equal for the same
seeds (NARMA10's redraw of a diverging draw included).  Metrics are numpy
too and must be equal.  The host readout solves in float64 from the same
f32 states, so its weights agree to float64 round-off (1e-6); through the
Gram op the f32 sums differ in order, so 1e-4 on a well-conditioned fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit_readout as jfit_readout
from repro.core import metrics as jmetrics
from repro.core import tasks as jtasks
from repro_torch.core import fit_readout, metrics, tasks

CASES = [
    ("narma10", dict(n_samples=400, seed=0)),
    ("narma10", dict(n_samples=2000, seed=83)),      # diverges on its first draw
    ("santa_fe", dict(n_samples=300, seed=1)),
    ("channel_equalization", dict(n_symbols=900, snr_db=20.0, seed=2)),
    ("channel_equalization_drift", dict(n_symbols=600, seed=3)),
    ("memory_capacity", dict(n_samples=300, max_delay=7, seed=4)),
    ("delayed_xor", dict(n_samples=300, delay=3, seed=5)),
    ("parity", dict(n_samples=300, order=3, delay=1, seed=6)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_datasets_bitwise(name, kw):
    got, want = getattr(tasks, name)(**kw), getattr(jtasks, name)(**kw)
    assert got.name == want.name
    for field in ("inputs_train", "targets_train", "inputs_test", "targets_test"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_quantize_symbols_and_metrics_equal():
    rng = np.random.default_rng(0)
    y = rng.normal(0, 2, 500)
    p = y + rng.normal(0, 0.5, 500)
    np.testing.assert_array_equal(tasks.quantize_symbols(p), jtasks.quantize_symbols(p))
    assert metrics.nrmse(y, p) == jmetrics.nrmse(y, p)
    assert metrics.ser(tasks.quantize_symbols(y), tasks.quantize_symbols(p)) == \
        jmetrics.ser(jtasks.quantize_symbols(y), jtasks.quantize_symbols(p))
    yy, pp = rng.normal(size=(200, 4)), rng.normal(size=(200, 4))
    assert metrics.memory_capacity_score(yy, pp) == jmetrics.memory_capacity_score(yy, pp)
    assert metrics.VAR_EPS == jmetrics.VAR_EPS == 1e-30


@pytest.mark.parametrize("kw,tol", [(dict(l2=1e-4), 1e-6), (dict(l2=(1e-6, 1e-4, 1e-2)), 1e-6),
                                    (dict(method="pinv"), 1e-6),
                                    (dict(l2=(1e-6, 1e-4), use_kernel=True), 1e-4)],
                         ids=["ridge", "ridge_gcv", "pinv", "ridge_gram_op"])
def test_fit_readout_matches_reference(kw, tol):
    rng = np.random.default_rng(9)
    states = rng.uniform(0, 1, (300, 12)).astype(np.float32)
    y = (states @ rng.standard_normal(12) + 0.05 * rng.standard_normal(300)).astype(np.float32)
    got = fit_readout(torch.as_tensor(states), y, **kw)
    want = jfit_readout(jnp.asarray(states), y, **kw)
    assert got.w.dtype == torch.float32 and tuple(got.w.shape) == (13, 1)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=tol, atol=tol)
    np.testing.assert_allclose(got(torch.as_tensor(states)).numpy(),
                               np.asarray(want(jnp.asarray(states))), rtol=1e-4, atol=1e-4)


def test_fit_readout_rejects_bad_arguments():
    with pytest.raises(ValueError):
        fit_readout(torch.zeros(10, 3), np.zeros(9))
    with pytest.raises(ValueError, match="unknown method"):
        fit_readout(torch.zeros(10, 3), np.zeros(10), method="lsqr")
