"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the same numpy weights and inputs.

Tolerances: f32 outputs to 2e-6 (O(1) values, sums over 64-128 terms in
another order), the aux loss to 1e-6; the dispatch positions exactly.  In
bf16, where both packages round each op's result (XLA may keep some in
f32), the outputs agree to 2^-6 of their scale: one or two ulps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

ARCH = "qwen3-moe-30b-a3b"


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _axes, _init) in sorted(moe.moe_defs(cfg).items()):
        out[name] = rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(shape[-2]))
    return out


def _run(cfg, jcfg, p, x, dtype="float32"):
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jy, jaux = jmoe.apply_moe(jcfg, jax.tree.map(jnp.asarray, p), jx)
    ty, taux = moe.apply_moe(cfg, {k: torch.as_tensor(v) for k, v in p.items()}, tx)
    return ty.float().numpy(), np.asarray(jy, np.float32), float(taux), float(jaux)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.5])
def test_apply_moe_matches_reference(capacity_factor):
    """Dropless (the smoke config's 8.0), the assigned 1.25 and a factor
    that overflows most experts: output and aux loss both."""
    cfg = dataclasses.replace(configs.smoke_config(ARCH), capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jsmoke_config(ARCH), capacity_factor=capacity_factor)
    p = _params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((3, 12, cfg.d_model), dtype=np.float32)
    ty, jy, taux, jaux = _run(cfg, jcfg, p, x)
    np.testing.assert_allclose(ty, jy, atol=2e-6, rtol=0)
    assert abs(taux - jaux) < 1e-6


def test_overflow_uses_the_scratch_row_and_drops_exactly_those_slots():
    """At capacity 1 every slot past an expert's first goes to the scratch
    row; the output equals the combine over the kept slots alone, and a
    token whose slots all overflow gets exactly zero."""
    cfg = dataclasses.replace(configs.smoke_config(ARCH), capacity_factor=0.25)
    s, k, e = 12, cfg.top_k, cfg.n_experts
    assert moe.capacity(cfg, s) == 1
    p = {key: torch.as_tensor(v) for key, v in _params(cfg, 2).items()}
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, s, cfg.d_model),
                                                                 dtype=np.float32))
    y, _ = moe.apply_moe(cfg, p, x)
    _, top_p, top_e = moe.route(cfg, p, x)
    pos = moe._group_positions(top_e.reshape(2, s * k), e).reshape(2, s, k)
    assert (pos >= 1).any()                               # some slot overflowed
    want = torch.zeros_like(x)
    for b in range(2):
        for t in range(s):
            for j in range(k):
                if pos[b, t, j] < 1:
                    ei = int(top_e[b, t, j])
                    h = x[b, t]
                    g = torch.nn.functional.silu(h @ p["wi_gate"][ei]) * (h @ p["wi_up"][ei])
                    want[b, t] += top_p[b, t, j] * (g @ p["wo"][ei])
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=2e-6, rtol=0)
    dropped = (pos >= 1).all(-1)
    assert dropped.any() and not y[dropped].any()


def test_group_positions_match_reference():
    rng = np.random.default_rng(4)
    flat_e = rng.integers(0, 8, (3, 40))
    want = np.asarray(jmoe._group_positions(jnp.asarray(flat_e, jnp.int32), 8))
    got = moe._group_positions(torch.as_tensor(flat_e), 8).numpy()
    np.testing.assert_array_equal(got, want)
    # the running count: each slot's position is the number of earlier
    # slots of its group routed to the same expert
    for b in range(3):
        for i in range(40):
            assert got[b, i] == int((flat_e[b, :i] == flat_e[b, i]).sum())


def test_apply_moe_bf16_matches_reference():
    cfg, jcfg = configs.smoke_config(ARCH), jsmoke_config(ARCH)
    p = _params(cfg, 5)
    x = np.random.default_rng(6).standard_normal((2, 10, cfg.d_model), dtype=np.float32) * 3
    ty, jy, taux, jaux = _run(cfg, jcfg, p, x, "bfloat16")
    np.testing.assert_allclose(ty, jy, atol=2 ** -6 * float(np.abs(jy).max()), rtol=0)
    assert abs(taux - jaux) < 1e-5
