"""Port parity: reservoir states (repro_torch.core.reservoir vs repro.core.reservoir).

The port's ``ref``/``fast``/``kernel`` paths (the kernel path takes its
plain version on CPU tensors) are held against the JAX sequential oracle
``_states_ref``: ≤1e-6 for SiliconMR (the same separately rounded f32 ops
over K·N steps), ≤1e-5 for MackeyGlass and MZISine (libm pow/sin may differ
by an ulp, carried through the recurrence).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MZISine as JMZI
from repro.core import MackeyGlass as JMG
from repro.core import SiliconMR as JMR
from repro.core import make_mask as jmake_mask
from repro.core.reservoir import _states_ref
from repro_torch.core import MackeyGlass, MZISine, SiliconMR, generate_states, make_mask

PAIRS = [(SiliconMR(), JMR(), (0.0, 1.0), 1e-6),
         (SiliconMR(beta_tpa=0.5), JMR(beta_tpa=0.5), (0.0, 1.0), 1e-6),
         (MackeyGlass(), JMG(), (-1.0, 1.0), 1e-5),
         (MZISine(), JMZI(), (0.0, 1.0), 1e-5)]
IDS = ["mr", "mr_tpa", "mg", "mzi"]


def _inputs(b=3, k=20, n=16, levels=(0.0, 1.0)):
    rng = np.random.default_rng(b * k + n)
    j = rng.uniform(0, 1, (b, k)).astype(np.float32)
    s0 = rng.uniform(0, 0.3, (b, n)).astype(np.float32)
    mask = make_mask(n, levels=levels, seed=4)
    return j, s0, mask


@pytest.mark.parametrize("method", ["ref", "fast", "kernel"])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_generate_states_matches_jax_oracle(pair, method):
    pm, jm, levels, tol = pair
    j, s0, mask = _inputs(levels=levels)
    got = generate_states(pm, torch.as_tensor(j), mask, s0=torch.as_tensor(s0),
                          method=method, device="cpu")
    u = jnp.asarray(j)[..., None] * jnp.asarray(mask.numpy())
    want = _states_ref(jm, u, jnp.asarray(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("method", ["ref", "fast", "kernel"])
def test_chunk_resume_is_bitwise_within_the_port(method):
    j, s0, mask = _inputs(k=24)
    jt, s0t = torch.as_tensor(j), torch.as_tensor(s0)
    full, fin = generate_states(SiliconMR(), jt, mask, s0=s0t, method=method,
                                return_final=True, device="cpu")
    assert torch.equal(fin, full[:, -1])
    a, carry = generate_states(SiliconMR(), jt[:, :9], mask, s0=s0t, method=method,
                               return_final=True, device="cpu")
    b_, carry = generate_states(SiliconMR(), jt[:, 9:], mask, s0=carry, method=method,
                                return_final=True, device="cpu")
    assert torch.equal(torch.cat([a, b_], dim=1), full)
    assert torch.equal(carry, fin)


def test_series_input_state_dtype_and_default_s0():
    j, _, mask = _inputs(b=1)
    jt = torch.as_tensor(j[0])
    st = generate_states(SiliconMR(), jt, mask, method="kernel", device="cpu")
    assert tuple(st.shape) == (j.shape[1], mask.shape[0])
    st16, fin = generate_states(SiliconMR(), jt, mask, method="fast", device="cpu",
                                state_dtype="bfloat16", return_final=True)
    assert st16.dtype == torch.bfloat16 and fin.dtype == torch.float32
    np.testing.assert_allclose(st16.float().numpy(), st.numpy(), atol=4e-2)
    want = np.asarray(_states_ref(JMR(), jnp.asarray(j)[..., None] * jnp.asarray(mask.numpy()),
                                  jnp.zeros((1, mask.shape[0]), jnp.float32)))[0]
    np.testing.assert_allclose(st.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmake_mask(16, seed=4)))


def test_unported_options_and_bad_arguments_raise(monkeypatch):
    j, _, mask = _inputs()
    jt = torch.as_tensor(j)
    with pytest.raises(TypeError, match="swept device parameters"):
        generate_states(SiliconMR(), jt, mask, dev_params={"x": 1.0}, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        generate_states(SiliconMR(), jt, mask, method="pallas", device="cpu")
    with pytest.raises(ValueError, match="block_s"):
        generate_states(SiliconMR(), jt, mask, method="kernel", block_s=3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        generate_states(SiliconMR(), jt, mask)
