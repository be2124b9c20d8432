"""Port parity: input masking (repro_torch.core.masking vs repro.core.masking).

Masks are built in numpy by both packages, so they must be bitwise equal;
the masked input is one f32 product, so it is bitwise equal too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as ref
from repro_torch.core import masking as port


@pytest.mark.parametrize("m", range(2, 17))
def test_mls_sequence_bitwise(m):
    np.testing.assert_array_equal(port.mls_sequence(m, init_state=m - 1),
                                  ref.mls_sequence(m, init_state=m - 1))


@pytest.mark.parametrize("n,levels,seed", [(1, (0.0, 1.0), 1), (30, (0.0, 1.0), 1),
                                           (400, (-1.0, 1.0), 1), (900, (0.0, 1.0), 1),
                                           (129, (0.2, 0.7), 77), (64, (0.0, 1.0), 5000)])
def test_make_mask_bitwise(n, levels, seed):
    got = port.make_mask(n, levels=levels, seed=seed)
    want = np.asarray(ref.make_mask(n, levels=levels, seed=seed))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_input_and_sample_and_hold_bitwise():
    rng = np.random.default_rng(0)
    j = rng.uniform(0, 1, (3, 11)).astype(np.float32)
    mask = port.make_mask(17, seed=3)
    got = port.masked_input(port.sample_and_hold(torch.as_tensor(j)), mask)
    want = ref.masked_input(ref.sample_and_hold(jnp.asarray(j)), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masking_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        port.make_mask(0)
    with pytest.raises(ValueError):
        port.mls_sequence(17)
    with pytest.raises(ValueError):
        port.mls_sequence(4, init_state=0)
