"""Port parity: the batched Gram op (repro_torch.kernels.ridge_gram).

On CPU tensors the wrappers take the plain version (block_t row tiles
folded in order), held against the JAX Pallas kernel in interpret mode at
rtol 1e-5 / atol 1e-4 (f32 sums in another order).  Within the port,
accumulate-into over tile-aligned chunks is bitwise equal to one-shot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ridge_gram import gram_accumulate as jgram
from repro.kernels.ridge_gram import gram_accumulate_batched as jgram_batched
from repro.kernels.ridge_gram import gram_ref_batched as jgram_ref_batched
from repro_torch.kernels.ridge_gram import (gram_accumulate, gram_accumulate_batched,
                                            gram_accumulate_batched_into, gram_plain_batched,
                                            gram_ref, gram_ref_batched)

TOL = dict(rtol=1e-5, atol=1e-4)


def _data(b, t, f, c, seed=0):
    rng = np.random.default_rng(seed + b + t + f + c)
    return (rng.standard_normal((b, t, f)).astype(np.float32),
            rng.standard_normal((b, t, c)).astype(np.float32))


@pytest.mark.parametrize("t,f,c", [(100, 37, 1), (257, 150, 1), (64, 129, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matches_pallas_interpret(t, f, c, dtype):
    x, y = _data(1, t, f, c)
    xt = torch.as_tensor(x[0]).to(getattr(torch, dtype))
    g, m = gram_accumulate(xt, torch.as_tensor(y[0]))
    xj = jnp.asarray(x[0]).astype(getattr(jnp, dtype))
    gj, mj = jgram(xj, jnp.asarray(y[0]).astype(xj.dtype), interpret=True)
    assert g.dtype == torch.float32 and tuple(g.shape) == (f, f) and tuple(m.shape) == (f, c)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), **TOL)


@pytest.mark.parametrize("b,t,f,c", [(3, 100, 37, 1), (2, 70, 20, 2)])
def test_gram_batched_matches_pallas_interpret(b, t, f, c):
    x, y = _data(b, t, f, c)
    g, m = gram_accumulate_batched(torch.as_tensor(x), torch.as_tensor(y), block_t=32)
    gj, mj = jgram_batched(jnp.asarray(x), jnp.asarray(y), block_t=32, interpret=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), **TOL)
    g2, m2 = gram_accumulate_batched(torch.as_tensor(x), torch.as_tensor(y[..., 0]))
    np.testing.assert_allclose(m2.numpy(), np.asarray(mj)[..., :1], **TOL)


def test_gram_oracle_matches_reference_oracle():
    x, y = _data(2, 50, 11, 2)
    g, m = gram_ref_batched(torch.as_tensor(x), torch.as_tensor(y))
    gj, mj = jgram_ref_batched(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), **TOL)
    g1, m1 = gram_ref(torch.as_tensor(x[0]), torch.as_tensor(y[0]))
    np.testing.assert_allclose(g1.numpy(), g[0].numpy(), **TOL)


@pytest.mark.parametrize("block_t,chunk", [(16, 32), (8, 8), (512, 96)])
def test_gram_into_bitwise_equals_one_shot(block_t, chunk):
    x, y = _data(2, 96, 20, 1, seed=31)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    g_full, c_full = gram_accumulate_batched(xt, yt, block_t=block_t)
    g = torch.zeros((2, 20, 20))
    c = torch.zeros((2, 20, 1))
    for lo in range(0, 96, chunk):
        out = gram_accumulate_batched_into(g, c, xt[:, lo:lo + chunk], yt[:, lo:lo + chunk],
                                           block_t=block_t)
        assert out[0] is g and out[1] is c          # in place, like the kernel
    assert torch.equal(g, g_full) and torch.equal(c, c_full)


@pytest.mark.parametrize("t,f,c", [(100, 37, 2), (64, 129, 1)])
def test_gram_into_adds_onto_running_stacks(t, f, c):
    x, y = _data(3, t, f, c)
    rng = np.random.default_rng(t + f)
    g0 = rng.standard_normal((3, f, f)).astype(np.float32)
    c0 = rng.standard_normal((3, f, c)).astype(np.float32)
    g, m = gram_accumulate_batched_into(torch.as_tensor(g0).clone(), torch.as_tensor(c0).clone(),
                                        torch.as_tensor(x), torch.as_tensor(y))
    gr, mr = jgram_ref_batched(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(g.numpy(), g0 + np.asarray(gr), **TOL)
    np.testing.assert_allclose(m.numpy(), c0 + np.asarray(mr), **TOL)


def test_gram_into_f32_targets_beside_bf16_x_match_pallas_fold():
    """round_y=False (the streaming fold) reads f32 targets beside a bf16 X
    as the reference's fold does, calling its Pallas kernel directly
    (interpret mode, through the reference's ``_fold_chunk``); the default
    rounds them to bf16 as the reference's public wrapper does."""
    from repro.kernels.ridge_gram import gram_accumulate_batched_into as jgram_into
    from repro.pipeline.ridge import _fold_chunk as jfold_chunk
    from repro.pipeline.ridge import _plan_fold as jplan_fold

    rng = np.random.default_rng(4)
    b, t, f = 2, 40, 21
    x = rng.uniform(-1, 1, (b, t, f)).astype(np.float32)
    y = (1.0 + rng.uniform(0, 1, (b, t, 1)) * 2.0 ** -12).astype(np.float32)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    g, c = gram_accumulate_batched_into(torch.zeros((b, f, f)), torch.zeros((b, f, 1)), xb,
                                        torch.as_tensor(y), round_y=False)
    plan = jplan_fold(f, t, use_kernel=True, block_t=16, block_f=128, state_dtype="bfloat16")
    fq = plan.fq
    gj, cj, _ = jfold_chunk(plan, jnp.zeros((b, fq, fq)), jnp.zeros((b, fq, 1)), jnp.zeros(b),
                            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj)[:, :f, :f], **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj)[:, :f], **TOL)
    gr, cr = gram_accumulate_batched_into(torch.zeros((b, f, f)), torch.zeros((b, f, 1)), xb,
                                          torch.as_tensor(y))
    _, cjr = jgram_into(jnp.zeros((b, f, f)), jnp.zeros((b, f, 1)),
                        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y), block_t=16)
    np.testing.assert_allclose(cr.numpy(), np.asarray(cjr), **TOL)
    assert float((cr - c).abs().max()) > 1e-3      # bf16 rounding of y ≈ 2⁻⁸ per row


def test_gram_rejects_bad_arguments():
    x = torch.zeros((2, 16, 5))
    y = torch.zeros((2, 16, 1))
    with pytest.raises(ValueError, match="init stacks"):
        gram_accumulate_batched_into(torch.zeros((2, 4, 4)), torch.zeros((2, 4, 1)), x, y)
    with pytest.raises(ValueError, match="contiguous float32"):
        gram_accumulate_batched_into(torch.zeros((2, 5, 5), dtype=torch.float64),
                                     torch.zeros((2, 5, 1)), x, y)
    with pytest.raises(ValueError, match="block_t"):
        gram_accumulate_batched(x, y, block_t=0)
    with pytest.raises(ValueError, match="expected x"):
        gram_accumulate_batched(x[0], y)
    before = gram_accumulate_batched.launches
    gram_plain_batched(x, y)
    gram_accumulate_batched(x, y)
    assert gram_accumulate_batched.launches == before   # plain versions are not launches
