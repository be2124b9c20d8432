"""The port's transformer layers (``repro_torch.models.layers``) against the
JAX package's, on the same numpy inputs, in f32.

Tolerances: each op is the reference's op for op in f32; sums run in
another order on another library, so values agree to f32 round-off of
their magnitude (atol 2e-6 on O(1) attention outputs, as the reference's
own chunked-vs-dense bound; 1e-5 on products over 64-128 terms).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JConfig
from repro.models import layers as jl
from repro_torch.models import ModelConfig
from repro_torch.models import layers as tl

CFG = ModelConfig(name="t", d_model=64, n_heads=4, n_kv_heads=2, vocab_size=64)
JCFG = JConfig(name="t", d_model=64, n_heads=4, n_kv_heads=2, vocab_size=64)


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _qkv(seed, b, sq, skv, h, kv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh), dtype=np.float32),
            rng.standard_normal((b, skv, kv, dh), dtype=np.float32),
            rng.standard_normal((b, skv, kv, dh), dtype=np.float32))


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    scale = rng.standard_normal(64, dtype=np.float32) * 0.1
    (jx, tx), (js, ts) = _both(x), _both(scale)
    _close(tl.rmsnorm(tx, ts, 1e-6), jl.rmsnorm(jx, js, 1e-6), atol=2e-6, rtol=1e-6)


def test_rmsnorm_bf16_accumulates_bf16_squares_in_f32():
    """In bf16 the squares are bf16 and only their mean is f32, as the
    reference's ``jnp.mean(..., dtype=f32)``: not a widening of x."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((3, 64), dtype=np.float32)).to(torch.bfloat16)
    scale = torch.zeros(64)
    var = x.square().to(torch.float32).mean(-1, keepdim=True)
    want = x * torch.rsqrt(var + 1e-6).to(torch.bfloat16)
    assert torch.equal(tl.rmsnorm(x, scale, 1e-6), want)


def test_rope_matches_reference():
    pos = np.arange(3, 19)[None, :]
    x = np.random.default_rng(2).standard_normal((1, 16, 2, 32), dtype=np.float32)
    jc, js = jl.rope_freqs(32, 10_000.0, jnp.asarray(pos))
    tc, ts = tl.rope_freqs(32, 10_000.0, torch.as_tensor(pos))
    _close(tc, jc, atol=2e-6)
    _close(ts, js, atol=2e-6)
    _close(tl.apply_rope(torch.as_tensor(x), tc, ts),
           jl.apply_rope(jnp.asarray(x), jc, js), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_sdpa_dense_matches_reference(causal, softcap):
    cfg = dataclasses.replace(CFG, attn_logit_softcap=softcap)
    jcfg = dataclasses.replace(JCFG, attn_logit_softcap=softcap)
    q, k, v = _qkv(3, 2, 12, 12, 4, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(tl._sdpa_dense(cfg, tq, tk, tv, causal=causal),
           jl._sdpa_dense(jcfg, jq, jk, jv, causal=causal), atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_sdpa_chunked_equals_dense_and_reference(causal, chunk):
    q, k, v = _qkv(4 + chunk, 2, 32, 32, 4, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    chunked = tl._sdpa_chunked(CFG, tq, tk, tv, causal=causal, chunk=chunk)
    _close(chunked, tl._sdpa_dense(CFG, tq, tk, tv, causal=causal), atol=2e-6)
    _close(chunked, jl._sdpa_chunked(JCFG, jq, jk, jv, causal=causal, chunk=chunk), atol=2e-6)


def test_sdpa_chunked_offset_decode_window_and_masked_rows():
    """The reference's offset window; and a query window wholly before a
    chunk (every row of that chunk fully masked) stays finite and exact."""
    q, k, v = _qkv(5, 1, 16, 64, 4, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    chunked = tl._sdpa_chunked(CFG, tq, tk, tv, causal=True, q_offset=48, chunk=16)
    _close(chunked, tl._sdpa_dense(CFG, tq, tk, tv, causal=True, q_offset=48), atol=2e-6)
    _close(chunked, jl._sdpa_chunked(JCFG, jq, jk, jv, causal=True, q_offset=48, chunk=16),
           atol=2e-6)
    early = tl._sdpa_chunked(CFG, tq, tk, tv, causal=True, q_offset=0, chunk=16)
    assert torch.isfinite(early).all()
    _close(early, tl._sdpa_dense(CFG, tq, tk, tv, causal=True, q_offset=0), atol=2e-6)


def test_sdpa_gqa_equals_repeated_kv():
    q, k, v = _qkv(6, 2, 8, 8, 4, 2, 16)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    out = tl._sdpa_dense(CFG, tq, tk, tv, causal=True)
    rep = tl._sdpa_dense(CFG, tq, tk.repeat_interleave(2, dim=2), tv.repeat_interleave(2, dim=2),
                         causal=True)
    _close(out, rep.numpy(), atol=1e-6)


def test_sdpa_switches_to_chunked_above_the_threshold(monkeypatch):
    calls = []
    real = tl._sdpa_chunked
    monkeypatch.setattr(tl, "_sdpa_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw, chunk=1024))
    monkeypatch.setattr(tl, "_KV_CHUNK", 1024)
    monkeypatch.setattr(tl, "_CHUNK_THRESHOLD", 2048)
    q, k, v = (torch.as_tensor(a) for a in _qkv(7, 1, 2, 4096, 4, 2, 8))
    out = tl._sdpa(CFG, q, k, v, causal=True, q_offset=4094)
    assert calls == [1]
    _close(out, tl._sdpa_dense(CFG, q, k, v, causal=True, q_offset=4094).numpy(), atol=2e-6)
    tl._sdpa(CFG, q[:, :1], k, v, causal=True, q_offset=4095)   # decode: dense
    assert calls == [1]


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    p = {}
    for name, (shape, _a, _i) in tl.attn_defs(cfg).items():
        scale = 1 / np.sqrt(shape[0]) if len(shape) > 1 else 0.1
        p[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
    return p


@pytest.mark.parametrize("qk_norm", [False, True])
def test_apply_attn_without_and_with_cache(qk_norm):
    cfg = dataclasses.replace(CFG, qk_norm=qk_norm)
    jcfg = dataclasses.replace(JCFG, qk_norm=qk_norm)
    p = _attn_params(cfg, 8)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = np.random.default_rng(9).standard_normal((2, 6, 64), dtype=np.float32)
    pos = np.arange(6)[None, :]
    jy, _ = jl.apply_attn(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos))
    ty, none = tl.apply_attn(cfg, tp, torch.as_tensor(x), positions=torch.as_tensor(pos))
    assert none is None
    _close(ty, jy, atol=1e-5)
    # cached: the first 4 positions, then 2 more, into a 10-position buffer
    shape = (2, 10, cfg.n_kv_heads, cfg.head_dim)
    kb, vb = torch.zeros(shape), torch.zeros(shape)
    jkb, jvb = jnp.zeros(shape), jnp.zeros(shape)
    _, (kb2, vb2, idx) = tl.apply_attn(cfg, tp, torch.as_tensor(x[:, :4]),
                                       positions=torch.as_tensor(pos[:, :4]), cache=(kb, vb, 0))
    assert idx == 4 and kb2 is kb and vb2 is vb          # written in place
    _, (jkb, jvb, jidx) = jl.apply_attn(jcfg, jp, jnp.asarray(x[:, :4]),
                                        positions=jnp.asarray(pos[:, :4]), cache=(jkb, jvb, 0))
    ty2, (_, _, idx2) = tl.apply_attn(cfg, tp, torch.as_tensor(x[:, 4:]),
                                      positions=torch.as_tensor(pos[:, 4:]), cache=(kb, vb, 4))
    jy2, (jkb, _, _) = jl.apply_attn(jcfg, jp, jnp.asarray(x[:, 4:]),
                                     positions=jnp.asarray(pos[:, 4:]), cache=(jkb, jvb, jidx))
    assert idx2 == 6
    _close(ty2, jy2, atol=1e-5)
    _close(kb, jkb, atol=1e-5)
    _close(ty2, jy[:, 4:], atol=1e-5)                     # cached == uncached


def test_apply_attn_write_past_the_buffer_raises():
    """The reference clamps a write past max_len; the port raises."""
    p = {k: torch.as_tensor(v) for k, v in _attn_params(CFG, 10).items()}
    shape = (1, 4, CFG.n_kv_heads, CFG.head_dim)
    kb, vb = torch.zeros(shape), torch.zeros(shape)
    x = torch.randn((1, 2, 64), generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cannot take 2 more at position 3"):
        tl.apply_attn(CFG, p, x, positions=torch.arange(3, 5)[None], cache=(kb, vb, 3))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp_matches_reference(act):
    cfg = dataclasses.replace(CFG, mlp_act=act, d_ff=128)
    jcfg = dataclasses.replace(JCFG, mlp_act=act, d_ff=128)
    rng = np.random.default_rng(11)
    p = {name: rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(shape[0]))
         for name, (shape, _a, _i) in tl.mlp_defs(cfg).items()}
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    _close(tl.apply_mlp(cfg, {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x)),
           jl.apply_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
           atol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_logits_match_reference(tied):
    cfg = dataclasses.replace(CFG, tie_embeddings=tied, dtype="float32")
    jcfg = dataclasses.replace(JCFG, tie_embeddings=tied, dtype="float32")
    rng = np.random.default_rng(12)
    p = {name: rng.standard_normal(shape, dtype=np.float32) * 0.1
         for name, (shape, _a, _i) in tl.embed_defs(cfg).items()}
    assert ("lm_head" in p) == (not tied)
    toks = rng.integers(0, 64, (2, 7))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx = tl.embed_tokens(cfg, tp, torch.as_tensor(toks))
    jx = jl.embed_tokens(jcfg, jp, jnp.asarray(toks))
    _close(tx, jx, atol=1e-6)
    logits = tl.logits_from_hidden(cfg, tp, tx)
    assert logits.dtype == torch.float32 and logits.shape == (2, 7, 64)
    _close(logits, jl.logits_from_hidden(jcfg, jp, jx), atol=1e-5)


def test_init_from_defs_shapes_scales_and_generator():
    defs = {**tl.attn_defs(dataclasses.replace(CFG, qk_norm=True)), **tl.norm_defs(CFG)}
    p = tl.init_from_defs(defs, torch.Generator().manual_seed(0), lead=(3,), device="cpu")
    assert set(p) == set(defs)
    for name, (shape, _a, init) in defs.items():
        assert p[name].shape == (3, *shape) and p[name].dtype == torch.float32
        if init == "zeros":
            assert not p[name].any()
        else:
            lim = 2.0 / np.sqrt(shape[0])
            assert float(p[name].abs().max()) <= lim + 1e-7    # truncated at 2 sigma
            assert abs(float(p[name].std()) * np.sqrt(shape[0]) - 0.88) < 0.05
    again = tl.init_from_defs(defs, torch.Generator().manual_seed(0), lead=(3,), device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
