"""Port parity: the ridge readout (repro_torch.pipeline.ridge).

The eigh (Gram) solve is held at 2e-3, as the reference's own Gram-vs-
numpy solve is (tests/test_kernel_parity.py): f32 eigendecompositions
from two libraries differ in the small eigen-directions.  The SVD solve on
a well-conditioned problem agrees to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pipeline import ridge as jridge
from repro_torch.kernels.ridge_gram import ops as gram_ops
from repro_torch.pipeline import ridge

LAMS = (1e-6, 1e-4, 1e-2)


def _problem(b=5, t=60, n=24, seed=0):
    """A noisy fit on few samples, so GCV has a clear winner (a near-tie
    would let f32 round-off pick either λ)."""
    rng = np.random.default_rng(seed)
    states = rng.uniform(0, 1, (b, t, n)).astype(np.float32)
    w_true = rng.standard_normal(n + 1)
    y = (np.concatenate([states, np.ones((b, t, 1), np.float32)], -1) @ w_true
         + 0.5 * rng.standard_normal((b, t))).astype(np.float32)
    return states, y


def test_with_bias_gram_and_apply_readout_match_reference():
    states, y = _problem(b=1)
    x = ridge.with_bias(torch.as_tensor(states[0]))
    xj = jridge.with_bias(jnp.asarray(states[0]))
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    for use_kernel in (False, True):
        g, c = ridge.gram(x, torch.as_tensor(y[0])[:, None], use_kernel=use_kernel)
        gj, cj = jridge.gram(xj, jnp.asarray(y[0])[:, None])
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-4)
    w = np.random.default_rng(1).standard_normal((25, 1)).astype(np.float32)
    np.testing.assert_allclose(
        ridge.apply_readout(torch.as_tensor(states[0]), torch.as_tensor(w)).numpy(),
        np.asarray(jridge.apply_readout(jnp.asarray(states[0]), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


def test_solve_gcv_matches_reference():
    states, y = _problem(b=1)
    x = np.concatenate([states[0], np.ones((60, 1), np.float32)], -1)
    g = (x.T.astype(np.float64) @ x).astype(np.float32)
    c = (x.T.astype(np.float64) @ y[0][:, None]).astype(np.float32)
    y2 = np.float32(np.sum(y[0].astype(np.float64) ** 2))
    w, idx = ridge.solve_gcv(torch.as_tensor(g), torch.as_tensor(c), torch.as_tensor(y2),
                             60, LAMS)
    wj, idxj = jridge.solve_gcv(jnp.asarray(g), jnp.asarray(c), jnp.asarray(y2), 60, LAMS)
    assert int(idx) == int(idxj)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=2e-3, atol=2e-3)


def test_solve_gcv_svd_matches_reference():
    states, y = _problem(b=1)
    x = np.concatenate([states[0], np.ones((60, 1), np.float32)], -1)
    w, idx = ridge.solve_gcv_svd(torch.as_tensor(x), torch.as_tensor(y[0])[:, None], LAMS)
    wj, idxj = jridge.solve_gcv_svd(jnp.asarray(x), jnp.asarray(y[0])[:, None], LAMS)
    assert int(idx) == int(idxj)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["svd", "gram"])
def test_fit_ridge_and_batched_match_reference(use_kernel):
    states, y = _problem()
    w, idx = ridge.fit_ridge_batched(states, y, lambdas=LAMS, use_kernel=use_kernel,
                                     device="cpu")
    wj, idxj = jridge.fit_ridge_batched(jnp.asarray(states), jnp.asarray(y), lambdas=LAMS,
                                        use_kernel=use_kernel)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idxj))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=2e-3, atol=2e-3)
    # batched == per-instance within the port; through the Gram, a batched
    # matmul may round its sums differently from a single one, and the eigh
    # solve amplifies that by about cond(G) (the 2e-3 of the cross-framework
    # check); the SVD solve sees the same X in both
    tol = 2e-3 if use_kernel else 1e-5
    for i in range(states.shape[0]):
        wi, idxi = ridge.fit_ridge(states[i], y[i], lambdas=LAMS, use_kernel=use_kernel,
                                   device="cpu")
        np.testing.assert_allclose(w[i].numpy(), wi.numpy(), rtol=tol, atol=tol)
        assert int(idxi) == int(idx[i])


def test_fit_ridge_batched_is_one_gram_call(monkeypatch):
    """One Gram op call for the whole instance stack (one kernel launch on
    the card), never a per-instance loop."""
    calls = []
    real = gram_ops.gram_accumulate_batched

    def counting(x, y, **kw):
        calls.append(tuple(x.shape))
        return real(x, y, **kw)

    monkeypatch.setattr(gram_ops, "gram_accumulate_batched", counting)
    states, y = _problem(b=3, t=64, n=8)
    ridge.fit_ridge_batched(states, y, lambdas=LAMS, use_kernel=True, device="cpu")
    assert calls == [(3, 64, 9)]


def test_guard_readout_matches_reference():
    rng = np.random.default_rng(3)
    w_new = rng.standard_normal((4, 6, 2)).astype(np.float32)
    w_new[1, 2, 0] = np.nan
    w_new[3, 0, 1] = np.inf
    w_last = rng.standard_normal((4, 6, 2)).astype(np.float32)
    idx_new, idx_last = np.array([0, 1, 2, 0]), np.array([2, 2, 2, 2], np.int32)
    w, idx = ridge.guard_readout(torch.as_tensor(w_new), torch.as_tensor(idx_new),
                                 torch.as_tensor(w_last), torch.as_tensor(idx_last))
    wj, idxj = jridge.guard_readout(jnp.asarray(w_new), jnp.asarray(idx_new),
                                    jnp.asarray(w_last), jnp.asarray(idx_last))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idxj))
    assert idx.dtype == torch.int32


def test_fit_ridge_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    states, y = _problem(b=1, t=30, n=4)
    for fit in (lambda: ridge.fit_ridge(states[0], y[0]),
                lambda: ridge.fit_ridge_batched(states, y)):
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            fit()


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
