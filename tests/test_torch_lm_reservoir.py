"""The port's ReservoirMixer (``repro_torch.core.layer``) against the JAX
package's ``repro.core.layer``, on the same numpy weights and inputs.

The port runs the period recurrence through ``kernels.dfr_scan`` (K1 on
the card; its plain version, the sequential node chain, on these CPU
tensors), where the reference runs ``lax.scan`` over
``SiliconMR.period_update``: the same recurrence op for op, so states and
carries agree to f32 round-off (1e-6, SiliconMR's state tolerance in
tests/test_torch_reservoir.py), and the readout's y to 1e-5 (sums of
R·N ≤ 96 products of O(1) terms).  Every test uses a non-zero readout: the
reference initialises it at zero, where a broken mixer would pass.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.core import layer as jlayer
from repro.models import init_cache as jinit_cache
from repro.models import prefill as jprefill
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import layer as tlayer
from repro_torch.kernels.dfr_scan import ops as scan_ops

STATE_TOL = 1e-6
Y_TOL = 1e-5


def _cfgs(**kw):
    return (dataclasses.replace(smoke_config("reservoir_lm"), **kw),
            dataclasses.replace(jsmoke_config("reservoir_lm"), **kw))


def _params(cfg, seed):
    """Mixer weights: w_in as the reference draws it, a non-zero readout."""
    rng = np.random.default_rng(seed)
    d, n, r = cfg.d_model, cfg.reservoir_nodes, tlayer._n_channels(cfg)
    return {"w_in": rng.standard_normal((d, r), dtype=np.float32) / np.float32(np.sqrt(d)),
            "readout": rng.standard_normal((r * n, d), dtype=np.float32)
            / np.float32(np.sqrt(r * n)),
            "readout_bias": rng.standard_normal(d, dtype=np.float32) * np.float32(0.1)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.as_tensor(v) for k, v in p.items()})


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model), dtype=np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize("nodes,d_model", [(16, 64), (32, 96)])
def test_apply_reservoir_matches_reference_from_zero_and_from_a_carry(nodes, d_model):
    cfg, jcfg = _cfgs(reservoir_nodes=nodes, d_model=d_model)
    jp, tp = _both(_params(cfg, nodes))
    x = _x(cfg, 3, 12, 1)
    jy, (jsp, jsl) = jlayer.apply_reservoir(jcfg, jp, jnp.asarray(x[:, :7]))
    ty, (tsp, tsl) = tlayer.apply_reservoir(cfg, tp, torch.as_tensor(x[:, :7]))
    r = tlayer._n_channels(cfg)
    assert ty.shape == (3, 7, d_model) and tsp.shape == (3, r, nodes) and tsl.shape == (3, r)
    _close(ty, jy, Y_TOL)
    _close(tsp, jsp, STATE_TOL)
    _close(tsl, jsl, STATE_TOL)
    # resumed from the carry
    jy2, (jsp2, jsl2) = jlayer.apply_reservoir(jcfg, jp, jnp.asarray(x[:, 7:]), cache=(jsp, jsl))
    ty2, (tsp2, tsl2) = tlayer.apply_reservoir(cfg, tp, torch.as_tensor(x[:, 7:]),
                                               cache=(tsp, tsl))
    _close(ty2, jy2, Y_TOL)
    _close(tsp2, jsp2, STATE_TOL)
    _close(tsl2, jsl2, STATE_TOL)
    assert torch.equal(tsl2, tsp2[..., -1])


def test_apply_reservoir_one_call_equals_two_chunked_calls_bitwise():
    cfg, _ = _cfgs()
    _, tp = _both(_params(cfg, 3))
    x = torch.as_tensor(_x(cfg, 2, 11, 4))
    y, (sp, sl) = tlayer.apply_reservoir(cfg, tp, x)
    y1, c1 = tlayer.apply_reservoir(cfg, tp, x[:, :5])
    y2, (sp2, sl2) = tlayer.apply_reservoir(cfg, tp, x[:, 5:], cache=c1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(sp2, sp) and torch.equal(sl2, sl)


def test_apply_reservoir_is_causal():
    """Perturbing x_t must not change outputs before t (tests/test_models.py:130)."""
    cfg, _ = _cfgs()
    _, tp = _both(_params(cfg, 5))
    x = torch.as_tensor(_x(cfg, 1, 12, 6))
    base, _ = tlayer.apply_reservoir(cfg, tp, x)
    x2 = x.clone()
    x2[0, 8] += 1.0
    pert, _ = tlayer.apply_reservoir(cfg, tp, x2)
    assert torch.equal(base[:, :8], pert[:, :8])
    assert not torch.allclose(base[:, 8:], pert[:, 8:])


def test_apply_reservoir_is_one_scan_call_a_layer():
    """The recurrence runs through the scan kernel's wrapper, once a call,
    with the B·R (batch, channel) pairs as its lanes and one shared mask."""
    cfg, _ = _cfgs()
    _, tp = _both(_params(cfg, 7))
    seen = []
    real = scan_ops.dfr_scan

    def spy(model, j, mask, s0, **kw):
        seen.append((tuple(j.shape), tuple(mask.shape), kw.get("out_dtype")))
        return real(model, j, mask, s0, **kw)

    calls = scan_ops.dfr_scan.calls
    tlayer.apply_reservoir(cfg, tp, torch.as_tensor(_x(cfg, 2, 9, 8)))
    assert scan_ops.dfr_scan.calls == calls + 1
    orig = tlayer.dfr_scan
    tlayer.dfr_scan = spy
    try:
        tlayer.apply_reservoir(cfg, tp, torch.as_tensor(_x(cfg, 2, 9, 8)).to(torch.bfloat16))
    finally:
        tlayer.dfr_scan = orig
    r = tlayer._n_channels(cfg)
    assert seen == [((2 * r, 9), (cfg.reservoir_nodes,), torch.bfloat16)]


def test_apply_reservoir_bf16_states_are_the_f32_states_rounded():
    """In bf16 the scan emits bf16 states directly: the f32 states rounded,
    as the reference's ``states.astype(dt)``; its y within bf16 round-off of
    the reference's."""
    cfg, jcfg = _cfgs()
    jp, tp = _both(_params(cfg, 9))
    x = _x(cfg, 2, 10, 10)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    y16, (sp16, _) = tlayer.apply_reservoir(cfg, tp, xb)
    _, (sp32, _) = tlayer.apply_reservoir(cfg, tp, xb.to(torch.float32))
    assert y16.dtype == torch.bfloat16 and sp16.dtype == torch.float32
    assert torch.equal(sp16, sp32)
    jy16, _ = jlayer.apply_reservoir(jcfg, jp, jnp.asarray(xb.to(torch.float32).numpy(),
                                                           dtype=jnp.bfloat16))
    ref = np.asarray(jy16, dtype=np.float32)
    np.testing.assert_allclose(y16.to(torch.float32).numpy(), ref, atol=0.06, rtol=0.02)


def test_cache_from_reference_and_its_identity_raise():
    """A reference prefill cache carries across (pos a host int); a cache
    whose s_last is not s_prev's last node is refused."""
    cfg, jcfg = _cfgs()
    import jax
    from test_torch_lm_model import numpy_params

    p = numpy_params(cfg)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 6))
    _, jc = jprefill(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(toks, jnp.int32),
                     max_len=8)
    tc = convert.lm_cache_from_reference(cfg, jc, device="cpu")
    assert tc["pos"] == 6 and isinstance(tc["pos"], int)
    (sp, sl), = tc["units"]
    _close(sp, jc["units"][0][0], 0.0)
    fresh = convert.lm_cache_from_reference(cfg, jinit_cache(jcfg, 2, 8), device="cpu")
    assert fresh["pos"] == 0 and not fresh["units"][0][0].any()
    bad = {"pos": jc["pos"],
           "units": ((jc["units"][0][0], jc["units"][0][1] + 1.0),)}
    with pytest.raises(ValueError, match="s_last == s_prev"):
        convert.lm_cache_from_reference(cfg, bad, device="cpu")
