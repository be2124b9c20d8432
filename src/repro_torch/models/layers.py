"""Core transformer layers: norms, RoPE, GQA attention, gated MLPs, embeddings.

Port of ``repro/models/layers.py``.  Everything is functional on a params
dict: ``*_defs(cfg)`` tables declare parameter shapes together with their
logical sharding axes (kept for the port of ``parallel/``), ``init_from_defs``
builds tensors from the defs, and ``apply_*`` run the computation.  Params
are stored in float32 and cast to ``cfg.dtype`` at use, as in the reference.

Attention is plain PyTorch, op for op like the reference's jnp (it is no
TPU kernel there).  Two differences of the framework, kept small:

* the attention logits are f32 from bf16 q and k: the reference asks its
  einsum for an f32 result (``preferred_element_type``); PyTorch's bf16
  einsum returns bf16, so q and k are widened first;
* a KV cache is written in place at its position (the reference's
  ``dynamic_update_slice`` on a donated buffer), and a write past the
  buffer's end raises where the reference clamps it.

Cross-attention (the VLM and encoder-decoder families) attends to a
context's k, v computed once (``context_kv``) through a tanh-gated residual.

Under a plan (``plan``: ``parallel.sharding.Plan``) the blocks run
Megatron tensor-parallel over "model" on the leaves as the plan hands them
over, and tell a block of this rank from a whole leaf by its shape: q heads
and kv heads column-parallel, the out projection row-parallel and its
partial sums all-reduced (g); the dense MLP likewise; the embedding
vocab-parallel (a rank looks up the tokens of its rows, zeros elsewhere,
and the all-reduce adds one non-zero a token: exact).  Each input that
enters a rank's block of the compute passes Megatron's f, whose backward
sums its gradient over "model": x before the column-parallel products,
whole kv heads before a rank takes those its q heads group over, and the
q/k norm scales, which every rank applies to its own heads.  A serving
plan all-gathers the last position's vocab columns of the logits; a train
plan keeps the rank's vocab block of every position (``losses.lm_loss``).
A KV cache cut along its sequence (``seq``: ``SeqSlice``) is attended in
pieces, each rank's partial softmax over its slice combined over the
slice's axes.  Without a plan every function is as before.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_dtype

# --------------------------------------------------------------------------
# Param-def helpers
# --------------------------------------------------------------------------


def init_from_defs(defs: dict, generator: torch.Generator, *, lead: tuple = (),
                   device=None) -> dict:
    """Build a params dict from a defs table {name: (shape, axes, init)}.

    ``init`` is one of "fan_in" (truncated normal on [-2, 2], times
    1/sqrt(fan_in) with fan_in = the first axis of ``shape``), "zeros",
    "ones", or a callable ``(generator, shape, lead, device) -> tensor``.
    Each tensor is ``lead + shape`` (``lead`` = the unit repeats a stacked
    leaf carries), f32 on ``device``, drawn from ``generator`` (which must
    live on ``device``) in the sorted order of the names.  The draws are
    not the reference's ``jax.random`` bits: only their distribution is
    the same.
    """
    params = {}
    for name, (shape, _axes, init) in sorted(defs.items()):
        full = (*lead, *shape)
        if init == "fan_in":
            scale = 1.0 / math.sqrt(max(1, shape[0]))
            t = torch.empty(full, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            params[name] = t.mul_(scale)
        elif init == "zeros":
            params[name] = torch.zeros(full, dtype=torch.float32, device=device)
        elif init == "ones":
            params[name] = torch.ones(full, dtype=torch.float32, device=device)
        elif callable(init):
            params[name] = init(generator, shape, lead, device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return params


def axes_from_defs(defs: dict) -> dict:
    return {name: axes for name, (_s, axes, _i) in defs.items()}


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------


def rmsnorm(x, scale, eps):
    # f32 *accumulation* of the squares, which are taken in x's dtype: the
    # reference's jnp.mean(jnp.square(x), dtype=f32).
    var = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
    rs = torch.rsqrt(var + eps).to(x.dtype)
    return x * rs * (1.0 + scale).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, positions):
    """positions [...,] -> (cos, sin) [..., head_dim/2], f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin [..., S, D/2] broadcast over heads."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention (self, GQA, optional qk-norm / softcap; cross variant)
# --------------------------------------------------------------------------


def attn_defs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    defs = {
        "wq": ((d, cfg.n_heads, hd), ("embed", "heads", "hd"), "fan_in"),
        "wk": ((d, cfg.n_kv_heads, hd), ("embed", "kv", "hd"), "fan_in"),
        "wv": ((d, cfg.n_kv_heads, hd), ("embed", "kv", "hd"), "fan_in"),
        "wo": ((cfg.n_heads, hd, d), ("heads", "hd", "embed"), "fan_in"),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ((hd,), ("hd",), "zeros")
        defs["k_norm"] = ((hd,), ("hd",), "zeros")
    return defs


def cross_attn_defs(cfg) -> dict:
    d, hd, dc = cfg.d_model, cfg.head_dim, (cfg.d_context or cfg.d_model)
    return {
        "wq": ((d, cfg.n_heads, hd), ("embed", "heads", "hd"), "fan_in"),
        "wk": ((dc, cfg.n_kv_heads, hd), ("ctx", "kv", "hd"), "fan_in"),
        "wv": ((dc, cfg.n_kv_heads, hd), ("ctx", "kv", "hd"), "fan_in"),
        "wo": ((cfg.n_heads, hd, d), ("heads", "hd", "embed"), "fan_in"),
        "gate": ((1,), (None,), "zeros"),  # tanh-gated residual (llama-3.2 style)
    }


_CHUNK_THRESHOLD = 8192
_KV_CHUNK = 2048


def _sdpa(cfg, q, k, v, *, causal: bool, q_offset: int = 0):
    """q [B,Sq,H,D], k/v [B,Skv,KV,D] -> [B,Sq,H,D].  Softmax in f32.

    GQA: H query heads grouped over KV heads.  ``q_offset`` is the absolute
    position of q[0] for causal masking against a longer kv (decode).

    Long sequences (Skv > 8k with Sq > 1, i.e. 32k+ prefill) switch to the
    online-softmax KV-chunked path, which caps the f32 logits at
    [B,H,Sq,chunk] where the dense path holds [B,H,Sq,Skv].
    """
    sq, skv = q.shape[1], k.shape[1]
    if sq > 1 and skv > _CHUNK_THRESHOLD and skv % _KV_CHUNK == 0:
        return _sdpa_chunked(cfg, q, k, v, causal=causal, q_offset=q_offset)
    return _sdpa_dense(cfg, q, k, v, causal=causal, q_offset=q_offset)


def _chunk_logits(cfg, qg, ks, dh):
    logits = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32), ks.to(torch.float32))
    logits = logits * (1.0 / math.sqrt(dh))
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _positions(n: int, offset: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) + offset


def _sdpa_dense(cfg, q, k, v, *, causal: bool, q_offset: int = 0):
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    logits = _chunk_logits(cfg, qg, k, dh)
    if causal:
        mask = _positions(sq, q_offset, q.device)[:, None] >= _positions(skv, 0, q.device)[None, :]
        logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, dh)


def _sdpa_chunked(cfg, q, k, v, *, causal: bool, q_offset: int = 0, chunk: int = _KV_CHUNK):
    """Flash-style online softmax over KV chunks (exact, plain torch)."""
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, sq, kvh, group, dh)
    qpos = _positions(sq, q_offset, q.device)
    f32 = torch.float32

    acc = torch.zeros((b, kvh, group, sq, dh), dtype=f32, device=q.device)
    mx = torch.full((b, kvh, group, sq), -math.inf, dtype=f32, device=q.device)
    den = torch.zeros((b, kvh, group, sq), dtype=f32, device=q.device)
    for idx in range(skv // chunk):
        ks = k[:, idx * chunk:(idx + 1) * chunk]
        vs = v[:, idx * chunk:(idx + 1) * chunk]
        logits = _chunk_logits(cfg, qg, ks, dh)                # [b,kv,g,sq,chunk]
        if causal:
            kpos = _positions(chunk, idx * chunk, q.device)
            mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
        else:
            mask = torch.ones((1, 1, 1, sq, chunk), dtype=torch.bool, device=q.device)
        chunk_mx = torch.amax(torch.where(mask, logits, -math.inf), dim=-1)
        new_mx = torch.maximum(mx, chunk_mx)
        safe_mx = torch.where(torch.isneginf(new_mx), 0.0, new_mx)  # fully-masked rows
        p = torch.where(mask, torch.exp(logits - safe_mx[..., None]), 0.0)
        corr = torch.where(torch.isneginf(mx), 0.0, torch.exp(mx - safe_mx))
        den = den * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), vs)
        acc = acc * corr[..., None] + pv.to(f32)
        mx = new_mx
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1)                             # [b,sq,kv,g,dh]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _tp(plan, t, block: bool):
    """``t`` through Megatron's f where it enters a rank's block of the
    compute (``block``) under a plan, else ``t``."""
    return plan.copy_to_model(t) if plan is not None and block else t


def _qkv(cfg, p, x, positions, plan=None):
    """q, k, v [B, S, heads, hd] of x, qk-normed and rotated; under a plan
    this rank's q heads (and kv heads, where "model" divides them)."""
    dt = x.dtype
    q_block = p["wq"].shape[1] < cfg.n_heads
    kv_block = p["wk"].shape[1] < cfg.n_kv_heads
    x_tp = _tp(plan, x, q_block or kv_block)
    q = torch.einsum("bsd,dhk->bshk", x_tp, p["wq"].to(dt))
    xkv = x_tp if kv_block else x
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(q, _tp(plan, p["q_norm"], q_block), cfg.norm_eps)
        k = rmsnorm(k, _tp(plan, p["k_norm"], kv_block), cfg.norm_eps)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _check_room(idx: int, s: int, length: int) -> None:
    if idx + s > length:
        raise ValueError(f"KV cache of {length} positions cannot take {s} more "
                         f"at position {idx} (the reference clamps the write; the port "
                         "raises)")


def apply_attn(cfg, p, x, *, positions, cache=None, causal=True, plan=None, seq=None):
    """Self-attention.  With ``cache=(k_buf, v_buf, index)`` (``index`` a
    host int) writes k, v into the buffers in place at ``index`` and
    attends over the whole buffer.  Returns (out, new_cache); raises if the
    write would run past the buffer.

    Under a serving plan (module doc) the buffers are this rank's cache
    block and ``seq`` the slice of the sequence they hold (None: all of
    it).  A sequence-cut cache takes each new position on the rank whose
    slice holds it; a prefill (from position 0) attends over the k, v it
    just computed, a later step over every rank's slice (``_sdpa_sliced``).
    """
    dt = x.dtype
    q, k, v = _qkv(cfg, p, x, positions, plan)

    new_cache = None
    if cache is None:
        out = _sdpa_heads(cfg, plan, q, k, v, causal=causal)
    elif seq is None or not seq.axes:
        k_buf, v_buf, idx = cache
        s = x.shape[1]
        _check_room(idx, s, k_buf.shape[1])
        k_buf[:, idx:idx + s] = k.to(k_buf.dtype)
        v_buf[:, idx:idx + s] = v.to(v_buf.dtype)
        new_cache = (k_buf, v_buf, idx + s)
        out = _sdpa_heads(cfg, plan, q, k_buf.to(dt), v_buf.to(dt), causal=causal,
                          q_offset=idx)
    else:
        k_buf, v_buf, idx = cache
        s, span = x.shape[1], k_buf.shape[1]
        _check_room(idx, s, span * math.prod(plan.sizes[a] for a in seq.axes))
        lo, hi = max(idx, seq.offset), min(idx + s, seq.offset + span)
        if lo < hi:
            k_buf[:, lo - seq.offset:hi - seq.offset] = k[:, lo - idx:hi - idx].to(k_buf.dtype)
            v_buf[:, lo - seq.offset:hi - seq.offset] = v[:, lo - idx:hi - idx].to(v_buf.dtype)
        new_cache = (k_buf, v_buf, idx + s)
        if idx == 0:
            out = _sdpa_heads(cfg, plan, q, k, v, causal=causal)
        else:
            out = _sdpa_sliced(cfg, plan, q, k_buf.to(dt), v_buf.to(dt), seq, causal=causal,
                               q_offset=idx)
    return _out_proj(cfg, p, out, plan), new_cache


def apply_cross_attn(cfg, p, x, *, context_kv, plan=None, seq=None):
    """Cross-attention to a precomputed (k, v) of the context (image patches /
    encoder frames).  Tanh-gated residual contribution.  Under a serving
    plan ``context_kv`` is this rank's cache block (its slice ``seq`` of
    the context positions) or, at prefill, the whole context's k, v."""
    dt = x.dtype
    k, v = context_kv
    q = torch.einsum("bsd,dhk->bshk", _tp(plan, x, p["wq"].shape[1] < cfg.n_heads),
                     p["wq"].to(dt))
    if seq is not None and seq.axes:
        out = _sdpa_sliced(cfg, plan, q, k.to(dt), v.to(dt), seq, causal=False)
    else:
        out = _sdpa_heads(cfg, plan, q, k.to(dt), v.to(dt), causal=False)
    y = _out_proj(cfg, p, out, plan)
    return torch.tanh(p["gate"].to(torch.float32)).to(dt) * y


def context_kv(cfg, p, context, plan=None):
    """Cross-attention k, v [B, T, KV, hd] from context embeddings
    [B, T, d_ctx], in the context's dtype; under a plan this rank's kv
    heads where "model" divides them."""
    dt = context.dtype
    context = _tp(plan, context, p["wk"].shape[1] < cfg.n_kv_heads)
    k = torch.einsum("btd,dhk->bthk", context, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", context, p["wv"].to(dt))
    return k, v


# --------------------------------------------------------------------------
# Attention on this rank's heads and cache block (serving plan)
# --------------------------------------------------------------------------


class SeqSlice(NamedTuple):
    """The slice of a KV cache's sequence a rank holds: the mesh axes the
    sequence is cut over (row-major) and the absolute position of the
    slice's first slot."""

    axes: tuple
    offset: int


def _out_proj(cfg, p, out, plan):
    """out [B, S, heads, hd] @ wo; a block of the heads' rows is summed over
    "model"."""
    wo = p["wo"]
    y = torch.einsum("bshk,hkd->bsd", out, wo.to(out.dtype))
    if plan is not None and wo.shape[0] < cfg.n_heads:
        y = plan.sum_model(y)
    return y


def _sdpa_heads(cfg, plan, q, k, v, *, causal: bool, q_offset: int = 0):
    """``_sdpa`` for this rank's q heads: where k, v hold every kv head and
    q a block of the heads, the kv heads that block's heads group over
    (after f: each rank's gradient reaches only those)."""
    hq, kvh = q.shape[2], k.shape[2]
    if hq < cfg.n_heads and kvh == cfg.n_kv_heads:
        g = cfg.n_heads // cfg.n_kv_heads
        if hq % g and g % hq:
            raise NotImplementedError(f"{hq} q heads a rank do not group over whole kv heads "
                                      f"({cfg.n_heads} heads, {cfg.n_kv_heads} kv heads)")
        q0 = plan.tp_rank * hq
        lo, hi = q0 // g, (q0 + hq - 1) // g + 1
        k, v = plan.copy_to_model(k)[:, :, lo:hi], plan.copy_to_model(v)[:, :, lo:hi]
    return _sdpa(cfg, q, k, v, causal=causal, q_offset=q_offset)


def _sdpa_sliced(cfg, plan, q, k, v, seq: SeqSlice, *, causal: bool, q_offset: int = 0):
    """Attention of q over the keys of every rank's slice of a sequence-cut
    cache, k, v [B, L_local, KV, hd] this rank's slice.  Where the slices
    are cut over "model" and q holds a block of the heads, the heads are
    all-gathered first (every rank's slice needs every head) and each rank
    keeps its own after the combine.  Each rank takes the max, the sum of
    exponentials and the weighted v of its slice (a slice wholly past the
    query weighs zero, not NaN); the max is all-reduced over the slice's
    axes, each piece rescaled to it, and the sums all-reduced."""
    b, sq, hq, dh = q.shape
    gathered = "model" in seq.axes and hq < cfg.n_heads
    if gathered:
        q = plan.gather_model(q, dim=2, backward="reduce-scatter")
    h, kvh = q.shape[2], k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    logits = _chunk_logits(cfg, qg, k, dh)                       # [b,kv,g,sq,L]
    if causal:
        mask = (_positions(sq, q_offset, q.device)[:, None]
                >= _positions(k.shape[1], seq.offset, q.device)[None, :])
        logits = torch.where(mask[None, None, None], logits, -math.inf)
    mx = torch.amax(logits, dim=-1)
    safe_mx = torch.where(torch.isneginf(mx), 0.0, mx)
    p = torch.exp(logits - safe_mx[..., None])
    den = torch.sum(p, dim=-1)
    acc = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), v).to(f32)
    top = plan.reduce(mx.clone(), seq.axes, op="max")
    scale = torch.where(torch.isneginf(mx), 0.0, torch.exp(mx - top))
    both = torch.cat([(acc * scale[..., None]).flatten(), (den * scale).flatten()])
    plan.reduce(both, seq.axes)
    acc, den = both[:acc.numel()].view_as(acc), both[acc.numel():].view_as(den)
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    out = torch.movedim(out, 3, 1).reshape(b, sq, h, dh).to(q.dtype)
    if gathered:
        out = out[:, :, plan.tp_rank * hq:(plan.tp_rank + 1) * hq]
    return out


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------


def mlp_defs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ((d, f), ("embed", "mlp"), "fan_in"),
        "wi_up": ((d, f), ("embed", "mlp"), "fan_in"),
        "wo": ((f, d), ("mlp", "embed"), "fan_in"),
    }


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p, x, *, plan=None):
    """The gated MLP; under a plan a block of its columns (``wi_*``) and
    rows (``wo``): x through f, the partial sums added over "model" (g)."""
    dt = x.dtype
    act = F.silu if cfg.mlp_act == "silu" else _gelu
    block = p["wo"].shape[0] < cfg.d_ff
    x = _tp(plan, x, block)
    g = act(x @ p["wi_gate"].to(dt))
    u = x @ p["wi_up"].to(dt)
    y = (g * u) @ p["wo"].to(dt)
    if plan is not None and block:
        y = plan.sum_model(y)
    return y


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------


def embed_defs(cfg) -> dict:
    defs = {"embedding": ((cfg.vocab_size, cfg.d_model), ("vocab", None), "fan_in")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((cfg.d_model, cfg.vocab_size), (None, "vocab"), "fan_in")
    return defs


def embed_tokens(cfg, p, tokens, *, plan=None):
    """Token embeddings; under a plan a block of the vocab rows: this
    rank's rows looked up, zeros elsewhere, summed over "model" (g)."""
    table = p["embedding"]
    if plan is None or table.shape[0] == cfg.vocab_size:
        x = table[tokens]
    else:
        rows = table.shape[0]
        local = tokens - plan.tp_rank * rows
        own = (local >= 0) & (local < rows)
        x = plan.sum_model(torch.where(own[..., None], table[local.clamp(0, rows - 1)], 0.0))
    return x.to(resolve_dtype(cfg.dtype)) * math.sqrt(cfg.d_model)


def logits_from_hidden(cfg, p, x, *, plan=None):
    """Logits [B, S, V] of hidden states x [B, S, d].  Under a serving plan
    only the last position's [B, 1, V], a block of the vocab columns a rank
    all-gathered over "model"; under a train plan this rank's block of the
    vocab columns [B, S, V_local], x through f."""
    dt = x.dtype
    table = p["lm_head"].to(dt) if "lm_head" in p else p["embedding"].to(dt).T
    block = table.shape[1] < cfg.vocab_size
    if plan is not None and plan.train:
        x = _tp(plan, x, block)
    logits = (x @ table).to(resolve_dtype(cfg.logit_dtype))
    if plan is None or plan.train:
        return logits
    logits = logits[:, -1:]
    return plan.gather_model(logits, dim=-1, backward="slice") if block else logits


def norm_defs(cfg, name: str = "scale") -> dict:
    return {name: ((cfg.d_model,), ("embed",), "zeros")}
