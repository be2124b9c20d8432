"""The port's recurrent mixers (``repro_torch.models.mamba`` and
``repro_torch.models.xlstm``) against the JAX package's, on the same numpy
weights, inputs and caches, at smoke size.

Tolerances, f32: outputs to 1e-5 (O(1)-O(10) values through the scan,
the gates' exponentials and the D-matrix, sums in another order; the
reference's associative scan and the port's doubling scan associate the
products apart), states to 1e-5 of their scale.  bf16: outputs to 2^-6
of their scale (one or two ulps; both packages round each op, XLA may
keep some intermediates in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import mamba as jmamba
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.models import mamba, xlstm

TOL = 1e-5


def _draw(defs, seed):
    """Every leaf non-zero: a matrix normal/sqrt(fan-in), a vector normal × 0.1
    (the conv window too: its first axis is 4 taps)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _axes, _init) in sorted(defs.items()):
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) >= 2 else 0.1
        out[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return out


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.as_tensor, tree))


def _close(t, j, tol=TOL, scale=False):
    j = np.asarray(j, np.float32)
    atol = tol * max(1.0, float(np.abs(j).max())) if scale else tol
    np.testing.assert_allclose(t.float().numpy(), j, atol=atol, rtol=0)


def _x(cfg, b, s, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model),
                                                       dtype=np.float32) * np.float32(scale)


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"


def _mamba_cache(cfg, b, seed):
    """A non-zero incoming (conv window, h): what a prefill leaves."""
    rng = np.random.default_rng(seed)
    d_in = cfg.d_model * cfg.mamba_expand
    return (rng.standard_normal((b, cfg.mamba_d_conv - 1, d_in), dtype=np.float32),
            rng.standard_normal((b, d_in, cfg.mamba_d_state), dtype=np.float32) * 0.5)


def test_scan_affine_is_the_sequential_recurrence():
    rng = np.random.default_rng(0)
    for s in (1, 2, 5, 8, 13):
        a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, s, 3, 4)).astype(np.float32))
        b = torch.as_tensor(rng.standard_normal((2, s, 3, 4), dtype=np.float32))
        cum_a, hs = mamba.scan_affine(a, b)
        h, p = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
        for t in range(s):
            h, p = a[:, t] * h + b[:, t], a[:, t] * p
            np.testing.assert_allclose(hs[:, t].numpy(), h.numpy(), atol=1e-6, rtol=0)
            np.testing.assert_allclose(cum_a[:, t].numpy(), p.numpy(), atol=1e-6, rtol=0)


def test_apply_mamba_without_cache_matches_reference():
    cfg, jcfg = configs.smoke_config(JAMBA), jsmoke_config(JAMBA)
    jp, tp = _both(_draw(mamba.mamba_defs(cfg), 1))
    x = _x(cfg, 2, 11, 2)
    jy, jc = jmamba.apply_mamba(jcfg, jp, jnp.asarray(x))
    ty, tc = mamba.apply_mamba(cfg, tp, torch.as_tensor(x))
    assert jc is None and tc is None
    _close(ty, jy)


@pytest.mark.parametrize("s", [1, 6])
def test_apply_mamba_from_a_cache_folds_h0_as_the_reference(s):
    """A step (S = 1, decode) and a chunk (S = 6) from a non-zero state:
    h0 enters through the scan's ∏dA, the conv window through the pad."""
    cfg, jcfg = configs.smoke_config(JAMBA), jsmoke_config(JAMBA)
    jp, tp = _both(_draw(mamba.mamba_defs(cfg), 3))
    x = _x(cfg, 2, s, 4)
    cache = _mamba_cache(cfg, 2, 5)
    jy, jc = jmamba.apply_mamba(jcfg, jp, jnp.asarray(x), cache=tuple(map(jnp.asarray, cache)))
    ty, tc = mamba.apply_mamba(cfg, tp, torch.as_tensor(x),
                               cache=tuple(map(torch.as_tensor, cache)))
    _close(ty, jy)
    for t, j in zip(tc, jc, strict=True):
        assert t.dtype == torch.float32 and t.shape == j.shape
        _close(t, j, scale=True)


def test_mamba_prefill_then_decode_matches_reference():
    cfg, jcfg = configs.smoke_config(JAMBA), jsmoke_config(JAMBA)
    jp, tp = _both(_draw(mamba.mamba_defs(cfg), 6))
    x = _x(cfg, 2, 9, 7)
    jc = jmamba.init_mamba_cache(jcfg, 2)
    tc = mamba.init_mamba_cache(cfg, 2)
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jy, jc = jmamba.apply_mamba(jcfg, jp, jnp.asarray(x[:, lo:hi]), cache=jc)
        ty, tc = mamba.apply_mamba(cfg, tp, torch.as_tensor(x[:, lo:hi]), cache=tc)
        _close(ty, jy)
    for t, j in zip(tc, jc, strict=True):
        _close(t, j, scale=True)
    # the whole sequence at once gives the same outputs at the end
    full, _ = mamba.apply_mamba(cfg, tp, torch.as_tensor(x))
    _close(ty[:, -1], full[:, -1].numpy())


# --------------------------------------------------------------------------
# mLSTM / sLSTM
# --------------------------------------------------------------------------

XLSTM = "xlstm-1.3b"


def test_apply_mlstm_parallel_form_and_final_state_match_reference():
    cfg, jcfg = configs.smoke_config(XLSTM), jsmoke_config(XLSTM)
    jp, tp = _both(_draw(xlstm.mlstm_defs(cfg), 8))
    x = _x(cfg, 2, 10, 9)
    jy, _ = jxlstm.apply_mlstm(jcfg, jp, jnp.asarray(x))
    ty, tnone = xlstm.apply_mlstm(cfg, tp, torch.as_tensor(x))
    assert tnone is None
    _close(ty, jy)
    # with a cache (a prefill): the final (conv, C, n, m) state; the
    # incoming state is ignored, as the reference's
    jc0 = jxlstm.init_mlstm_cache(jcfg, 2)
    tc0 = tuple(torch.full_like(t, 7.0) for t in xlstm.init_mlstm_cache(cfg, 2))
    jy, jc = jxlstm.apply_mlstm(jcfg, jp, jnp.asarray(x), cache=jc0)
    ty, tc = xlstm.apply_mlstm(cfg, tp, torch.as_tensor(x), cache=tc0)
    _close(ty, jy)
    for t, j in zip(tc, jc, strict=True):
        assert t.dtype == torch.float32 and t.shape == j.shape
        _close(t, j, scale=True)


def test_mlstm_recurrent_steps_match_reference_and_the_parallel_form():
    cfg, jcfg = configs.smoke_config(XLSTM), jsmoke_config(XLSTM)
    jp, tp = _both(_draw(xlstm.mlstm_defs(cfg), 10))
    x = _x(cfg, 2, 9, 11)
    jy, jc = jxlstm.apply_mlstm(jcfg, jp, jnp.asarray(x[:, :6]),
                                cache=jxlstm.init_mlstm_cache(jcfg, 2))
    ty, tc = xlstm.apply_mlstm(cfg, tp, torch.as_tensor(x[:, :6]),
                               cache=xlstm.init_mlstm_cache(cfg, 2))
    for i in range(6, 9):
        jy, jc = jxlstm.apply_mlstm(jcfg, jp, jnp.asarray(x[:, i:i + 1]), cache=jc)
        ty, tc = xlstm.apply_mlstm(cfg, tp, torch.as_tensor(x[:, i:i + 1]), cache=tc)
        _close(ty, jy)
    for t, j in zip(tc, jc, strict=True):
        _close(t, j, scale=True)
    full, _ = xlstm.apply_mlstm(cfg, tp, torch.as_tensor(x))
    np.testing.assert_allclose(ty[:, 0].numpy(), full[:, -1].numpy(), atol=1e-4, rtol=1e-4)


def test_apply_slstm_over_s_and_resumed_from_a_cache_match_reference():
    cfg, jcfg = configs.smoke_config(XLSTM), jsmoke_config(XLSTM)
    jp, tp = _both(_draw(xlstm.slstm_defs(cfg), 12))
    x = _x(cfg, 2, 10, 13)
    jy, _ = jxlstm.apply_slstm(jcfg, jp, jnp.asarray(x))
    ty, tnone = xlstm.apply_slstm(cfg, tp, torch.as_tensor(x))
    assert tnone is None
    _close(ty, jy)
    jy1, jc = jxlstm.apply_slstm(jcfg, jp, jnp.asarray(x[:, :7]),
                                 cache=jxlstm.init_slstm_cache(jcfg, 2))
    ty1, tc = xlstm.apply_slstm(cfg, tp, torch.as_tensor(x[:, :7]),
                                cache=xlstm.init_slstm_cache(cfg, 2))
    _close(ty1, jy1)
    jy2, jc = jxlstm.apply_slstm(jcfg, jp, jnp.asarray(x[:, 7:]), cache=jc)
    ty2, tc = xlstm.apply_slstm(cfg, tp, torch.as_tensor(x[:, 7:]), cache=tc)
    _close(ty2, jy2)
    for t, j in zip(tc, jc, strict=True):
        _close(t, j, scale=True)
    # resuming from the cache continues the sequence exactly as one pass
    _close(torch.cat([ty1, ty2], dim=1), ty.numpy(), 1e-6)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixers_bf16_match_reference(kind):
    """Each mixer alone in bf16, from a zero state over 8 tokens then one
    decode step: outputs within 2^-6 of their scale, caches in the
    reference's dtypes (conv windows and states f32)."""
    arch = JAMBA if kind == "mamba" else XLSTM
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    tmod, jmod = (mamba, jmamba) if kind == "mamba" else (xlstm, jxlstm)
    jp, tp = _both(_draw(getattr(tmod, f"{kind}_defs")(cfg), 14))
    jinit, tinit = getattr(jmod, f"init_{kind}_cache"), getattr(tmod, f"init_{kind}_cache")
    jc, tc = jinit(jcfg, 2), tinit(cfg, 2)
    japply, tapply = getattr(jmod, f"apply_{kind}"), getattr(tmod, f"apply_{kind}")
    x = _x(cfg, 2, 9, 15, scale=3.0)
    for lo, hi in ((0, 8), (8, 9)):
        jy, jc = japply(jcfg, jp, jnp.asarray(x[:, lo:hi]).astype(jnp.bfloat16), cache=jc)
        ty, tc = tapply(cfg, tp, torch.as_tensor(x[:, lo:hi]).to(torch.bfloat16), cache=tc)
        assert ty.dtype == torch.bfloat16
        _close(ty, jy, 2 ** -6, scale=True)
    for t, j in zip(tc, jc, strict=True):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
