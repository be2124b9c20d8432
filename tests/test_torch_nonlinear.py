"""Port parity: device models (repro_torch.core.nonlinear vs repro.core.nonlinear,
and the CMT cavity of repro_torch.devices vs repro.devices).

One node step and one whole period are compared with the JAX models on the
same f32 inputs.  Tolerance 1e-6: both evaluate the same separately rounded
f32 ops (SiliconMR, Literal); MackeyGlass, MZISine and the CMT cavity also
call pow/sin/exp/expm1, whose libm implementations may differ by an ulp.
Whole periods are held to 1e-5 of the reference.  Within the port, a
period equals the node_update chain bitwise, except MackeyGlass, whose
log-depth affine scan rounds differently from the chain (≤ 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nonlinear as ref
from repro.devices import calibrated_twin as jcalibrated_twin
from repro_torch.core import nonlinear as port
from repro_torch.devices import calibrated_twin

PAIRS = [
    (port.SiliconMR(), ref.SiliconMR()),
    (port.SiliconMR(beta_tpa=0.5), ref.SiliconMR(beta_tpa=0.5)),
    (port.SiliconMRLiteral(), ref.SiliconMRLiteral()),
    (port.MackeyGlass(), ref.MackeyGlass()),
    (port.MZISine(), ref.MZISine()),
    (calibrated_twin(port.SiliconMR(), power_mw=1.0),
     jcalibrated_twin(ref.SiliconMR(), power_mw=1.0)),
]
IDS = ["mr", "mr_tpa", "literal", "mg", "mzi", "cmt"]
# Within the port, every period_update is bitwise its node_update chain but
# MackeyGlass's (a log-depth affine scan).
CHAIN_TOL = {"mg": 1e-6}


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 1.5, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_node_update_matches_reference(pair):
    pm, rm = pair
    u, s_tau, s_pn = _inputs(1, (256,))
    got = pm.node_update(*(torch.as_tensor(a) for a in (u, s_tau, s_pn)))
    want = rm.node_update(*(jnp.asarray(a) for a in (u, s_tau, s_pn)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("pair,name", zip(PAIRS, IDS), ids=IDS)
def test_period_update_chains_node_update(pair, name):
    """Within the port, period_update is the node_update chain: bitwise, or
    within CHAIN_TOL for a scan that rounds differently."""
    pm, rm = pair
    u, s_prev, _ = (torch.as_tensor(a) for a in _inputs(2, (4, 19)))
    s_last = s_prev[:, -1]
    got = pm.period_update(u, s_prev, s_last)
    s_pn, chain = s_last, []
    for i in range(u.shape[-1]):
        s_pn = pm.node_update(u[:, i], s_prev[:, i], s_pn)
        chain.append(s_pn)
    chain = torch.stack(chain, dim=-1)
    if name in CHAIN_TOL:
        torch.testing.assert_close(got, chain, rtol=0, atol=CHAIN_TOL[name])
    else:
        assert torch.equal(got, chain)
    want = rm.period_update(jnp.asarray(u.numpy()), jnp.asarray(s_prev.numpy()),
                            jnp.asarray(s_last.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pair,name", zip(PAIRS, IDS), ids=IDS)
def test_kernel_spec_rounds_constants_to_f32(pair, name):
    pm, _ = pair
    model_id, params = pm.kernel_spec()
    assert model_id in (port.KERNEL_SILICON_MR, port.KERNEL_SILICON_MR_LITERAL,
                        port.KERNEL_MACKEY_GLASS, port.KERNEL_MZI_SINE,
                        port.KERNEL_MR_CAVITY_CMT)
    assert len(params) == (16 if name == "cmt" else 4)
    assert all(float(np.float32(p)) == p for p in params)


def test_registry_and_names_match_reference():
    assert set(port.MODEL_REGISTRY) >= {"silicon_mr", "silicon_mr_literal",
                                        "mackey_glass", "mzi_sine"}
    for key, cls in port.MODEL_REGISTRY.items():
        if key in ref.MODEL_REGISTRY:
            assert cls.__name__ == ref.MODEL_REGISTRY[key].__name__
            assert cls().name == ref.MODEL_REGISTRY[key]().name
    assert port.register_model("silicon_mr", port.SiliconMR) is port.SiliconMR
    with pytest.raises(ValueError, match="already registered"):
        port.register_model("silicon_mr", port.MZISine)


@pytest.mark.parametrize("name", ["identity", "sat", "sin2"])
def test_link_nonlinearities_match_reference(name):
    p = np.linspace(-3, 3, 101).astype(np.float32)
    got = port.LINK_NONLINEARITIES[name](torch.as_tensor(p))
    want = ref.LINK_NONLINEARITIES[name](jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
