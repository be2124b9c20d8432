"""xLSTM blocks — mLSTM (matrix memory) and sLSTM (scalar memory) mixers
[Beck et al., arXiv:2405.04517].  xlstm-1.3b stacks them 7:1.

Port of ``repro/models/xlstm.py``, op for op in plain PyTorch.

mLSTM: the parallel (attention-like) form for a forward and for any
S > 1 (a prefill starts from a zero state, as in the reference: an
incoming cache only sets the dtype of the conv state it returns); the
O(1) (C, n, m) matrix-memory recurrence for one-token decode steps.

sLSTM: inherently sequential (recurrent R matrices, block-diagonal per
head); the reference's ``lax.scan`` over the sequence is a Python loop over
S here, one cell step a token.

Blocks carry their own projections (d_ff = 0): mLSTM up-projects by
``mlstm_expand`` before mixing and down-projects after, sLSTM is followed by
a gated ~4/3 projection.  The score products of the parallel form widen q
and k to f32 first, where the reference asks its einsum for an f32 result
(as the port's attention does).

Under a plan (``parallel.sharding.Plan``) both blocks run tensor-parallel
over "model" on the blocks ``param_pspecs`` and ``cache_pspecs`` give a
rank (Megatron's f and g and the gathers' backwards: ``parallel/sharding.py``):

mLSTM, where "model" divides d_in: ``up_proj``'s sharded dim is the
concatenation [x | z], so x enters through f, the product is all-gathered
over "model" and each rank keeps x and z of its own channels (the gather's
backward a reduce-scatter), as Mamba's ``in_proj``.  The conv, its window,
``skip_scale``, ``out_norm`` and ``down_proj``'s rows are the rank's
channels.  ``wq``/``wk``/``wv``/``w_i``/``w_f`` are row-parallel: their
partial sums are added over "model" in one all-reduce a dtype (g), the
gate biases (gathered whole) added once after, and each result enters
through f, since every rank runs the parallel form on the whole q, k, v.
The rmsnorm of the output takes every channel's square (the output is
whole on each rank), and each rank keeps its own channels of it;
``down_proj``'s partial sums are added by g.  Where "model" divides
head_dim too, the cache's C and n hold this rank's rows of the k index:
its rows of k (with the whole v) update them, and the partial sums of
q·C and q·n are added over "model" before the denominator's abs/max;
``m`` is computed alike on every rank.  Where "model" does not divide d_in
the block's leaves are gathered whole and it runs replicated.

sLSTM: ``w_in``'s and ``bias``'s columns straddle [i | f | z | o] like
``up_proj``'s: x enters through f, each rank adds its bias block to its
product block (each bias element once) and the pre-activations are
all-gathered.  Where "model" divides the heads (``r_rec`` a block of
them) the cell runs on the rank's heads, with no collective inside the
loop over S: c, n and h are the rank's channels (each head's stabiliser
sees the head's whole channels), and its whole output y and the cache's
``m`` [B, H] are all-gathered once a step; elsewhere the cell runs
replicated, its c, n, h cache blocks gathered for the step and cut back
after.  ``out_norm`` takes the whole y; the gated projection runs as the
dense MLP's columns and rows (f, then g) where "model" divides f, else on
its leaves gathered whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _gelu, rmsnorm

# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def _full(value: float):
    """A callable init: every element ``value``."""

    def init(_generator, shape, lead, device):
        return torch.full((*lead, *shape), value, dtype=torch.float32, device=device)

    return init


def mlstm_defs(cfg) -> dict:
    d = cfg.d_model
    d_in = d * cfg.mlstm_expand
    h = cfg.n_heads
    hd = d_in // h
    return {
        "up_proj": ((d, 2 * d_in), ("embed", "mlp"), "fan_in"),
        "conv_w": ((4, d_in), (None, "mlp"), "fan_in"),
        "conv_b": ((d_in,), ("mlp",), "zeros"),
        "wq": ((d_in, h, hd), ("mlp", "heads", None), "fan_in"),
        "wk": ((d_in, h, hd), ("mlp", "heads", None), "fan_in"),
        "wv": ((d_in, h, hd), ("mlp", "heads", None), "fan_in"),
        "w_i": ((d_in, h), ("mlp", "heads"), "zeros"),
        "w_f": ((d_in, h), ("mlp", "heads"), "zeros"),
        "b_i": ((h,), ("heads",), "zeros"),
        "b_f": ((h,), ("heads",), _full(3.0)),  # open forget gates
        "skip_scale": ((d_in,), ("mlp",), "ones"),
        "out_norm": ((d_in,), ("mlp",), "zeros"),
        "down_proj": ((d_in, d), ("mlp", "embed"), "fan_in"),
    }


def _row_parallel(plan, parts, biases):
    """Row-parallel products ``parts`` ([B, S, ...] partial sums over this
    rank's channels) added over "model" in one all-reduce a dtype (g), each
    bias of ``biases`` (or None) added once after, every result through f
    (each rank computes on the whole of it)."""
    out = [None] * len(parts)
    for dtype in dict.fromkeys(t.dtype for t in parts):
        idx = [i for i, t in enumerate(parts) if t.dtype == dtype]
        flat = [parts[i].flatten(2) for i in idx]
        total = plan.sum_model(torch.cat(flat, dim=-1))
        if any(biases[i] is not None for i in idx):
            total = total + torch.cat([
                torch.zeros(t.shape[-1], dtype=dtype, device=t.device) if biases[i] is None
                else biases[i].to(dtype) for i, t in zip(idx, flat, strict=True)])
        total = plan.copy_to_model(total)
        for i, t in zip(idx, total.split([t.shape[-1] for t in flat], dim=-1), strict=True):
            out[i] = t.view(parts[i].shape)
    return out


def _mlstm_inputs(p, xc, plan=None):
    """q, k, v [B,S,H,hd] (k scaled by 1/sqrt(hd)) in xc's dtype, and the
    log input / forget gate pre-activations [B,S,H] f32, of xc [B,S,d_in];
    under a plan xc is this rank's channels (module doc)."""
    dt = xc.dtype
    q = torch.einsum("bsd,dhk->bshk", xc, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xc, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xc, p["wv"].to(dt))
    x32 = xc.to(torch.float32)
    i_pre, f_pre = x32 @ p["w_i"], x32 @ p["w_f"]              # [B,S,H]
    if plan is None:
        i_pre, f_pre = i_pre + p["b_i"], f_pre + p["b_f"]
    else:
        q, k, v, i_pre, f_pre = _row_parallel(plan, (q, k, v, i_pre, f_pre),
                                              (None, None, None, p["b_i"], p["b_f"]))
    log_f = -F.softplus(-f_pre)                                  # log sigmoid(f)
    return q, k / math.sqrt(q.shape[-1]), v, i_pre, log_f


def _k_rows(plan, rows: int, hd: int):
    """This rank's rows of the k index in a cache whose C holds ``rows`` of
    ``hd`` (all of them: None)."""
    return None if rows == hd else slice(plan.tp_rank * rows, (plan.tp_rank + 1) * rows)


def _conv_taps(p, xp, s: int):
    """The depthwise causal conv over a left-padded xp [B, kw-1+S, d_in]:
    the reference's Python ``sum`` of taps, in its order."""
    kw = p["conv_w"].shape[0]
    return sum(xp[:, i:i + s, :] * p["conv_w"][i].to(xp.dtype) for i in range(kw))


def _causal_conv4(p, x):
    kw = p["conv_w"].shape[0]
    pad = torch.zeros((x.shape[0], kw - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    out = _conv_taps(p, torch.cat([pad, x], dim=1), x.shape[1])
    return F.silu(out + p["conv_b"].to(x.dtype))


def _mlstm_parallel(cfg, p, xr, cache, plan=None):
    """The parallel form over xr [B, S, d_in]: (out [B,S,H,hd], xc, the
    final (conv, C, n, m) state or None).  Under a plan xr is this rank's
    channels, and the state's C and n the rows of k its cache holds."""
    dt = xr.dtype
    b, s = xr.shape[0], xr.shape[1]
    xc = _causal_conv4(p, xr)
    q, k, v, i_pre, log_f = _mlstm_inputs(p, xc, plan)
    # D matrix: d[t,s] = exp(Σ_{r=s+1..t} log_f_r + i_s − m_t), s ≤ t
    cum_f = torch.cumsum(log_f, dim=1)                           # [B,S,H]
    lse = cum_f[:, :, None, :] - cum_f[:, None, :, :] + i_pre[:, None, :, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=xr.device))
    lse = torch.where(mask[None, :, :, None], lse, -math.inf)   # [B,T,S,H]
    m = torch.amax(lse, dim=2, keepdim=True)                     # stabiliser
    dmat = torch.exp(lse - m)                                    # [B,T,S,H]
    scores = torch.einsum("bthk,bshk->bhts", q.to(torch.float32), k.to(torch.float32))
    w = scores * torch.movedim(dmat, -1, 1)                      # [B,H,T,S]
    denom = torch.maximum(torch.abs(torch.sum(w, dim=-1)),
                          torch.exp(-m[:, :, 0, :]).transpose(1, 2))
    out = torch.einsum("bhts,bshk->bthk", (w / denom[..., None]).to(dt), v)
    if cache is None:
        return out, xc, None
    # Final (C, n, m) state for subsequent decode steps.
    st_lse = cum_f[:, -1:, :] - cum_f + i_pre                    # [B,S,H]
    m_state = torch.amax(st_lse, dim=1)                          # [B,H]
    w_state = torch.exp(st_lse - m_state[:, None, :])            # [B,S,H]
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    rows = None if plan is None else _k_rows(plan, cache[1].shape[2], k.shape[-1])
    if rows is not None:
        k32 = k32[..., rows]
    c_state = torch.einsum("bshk,bshv->bhkv", w_state[..., None] * k32, v32)
    n_state = torch.einsum("bsh,bshk->bhk", w_state, k32)
    kw = p["conv_w"].shape[0]
    pad = torch.zeros((b, kw - 1, xr.shape[-1]), dtype=dt, device=xr.device)
    conv = torch.cat([pad, xr], dim=1)[:, -(kw - 1):, :].to(cache[0].dtype)
    return out, xc, (conv, c_state, n_state, m_state)


def _mlstm_step(p, xr, cache, plan=None):
    """One recurrent step from cache (conv, C, n, m): (out [B,1,H,hd], xc,
    the new state).  Under a plan xr is this rank's channels, and C and n
    may hold a block of the k index (module doc)."""
    dt = xr.dtype
    conv_state, c_mem, n_mem, m_mem = cache
    kw = p["conv_w"].shape[0]
    xp = torch.cat([conv_state.to(dt), xr], dim=1)
    xc = F.silu(_conv_taps(p, xp, 1) + p["conv_b"].to(dt))
    q, k, v, i_pre, log_f = _mlstm_inputs(p, xc, plan)           # [B,1,H,hd], [B,1,H]
    i_t, f_t = i_pre[:, 0], log_f[:, 0]                          # [B,H]
    m_new = torch.maximum(f_t + m_mem, i_t)
    a = torch.exp(f_t + m_mem - m_new)[..., None]
    bb = torch.exp(i_t - m_new)[..., None]
    k0, v0, q0 = (t[:, 0].to(torch.float32) for t in (k, v, q))  # [B,H,hd]
    rows = None if plan is None else _k_rows(plan, c_mem.shape[2], k0.shape[-1])
    if rows is not None:
        k0, q0 = k0[..., rows], q0[..., rows]
    c_new = a[..., None] * c_mem + bb[..., None] * torch.einsum("bhk,bhv->bhkv", k0, v0)
    n_new = a * n_mem + bb * k0
    num = torch.einsum("bhk,bhkv->bhv", q0, c_new)
    qn = torch.sum(q0 * n_new, dim=-1)
    if rows is not None:                    # partial sums over the k rows
        both = plan.sum_model(torch.cat([num, qn[..., None]], dim=-1))
        num, qn = both[..., :-1], both[..., -1]
    den = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    out = (num / den[..., None]).to(dt)[:, None]                 # [B,1,H,hd]
    return out, xc, (xp[:, -(kw - 1):, :].to(conv_state.dtype), c_new, n_new, m_new)


def apply_mlstm(cfg, p, x, *, cache=None, plan=None):
    """x [B,S,d].  cache=(conv_state, C [B,H,hd,hd], n [B,H,hd], m [B,H]).

    Returns (y [B,S,d], new_cache); cache=None -> no state returned.
    Under a plan (module doc) the leaves and the cache are this rank's
    blocks where "model" divides d_in."""
    dt = x.dtype
    d_in = cfg.d_model * cfg.mlstm_expand
    n = p["conv_b"].shape[0]
    tp = plan if plan is not None and n < d_in else None       # this rank's channels
    if tp is None:
        xz = x @ p["up_proj"].to(dt)
    else:
        xz = tp.gather_model(tp.copy_to_model(x) @ p["up_proj"].to(dt), dim=-1,
                             backward="reduce-scatter")
    xr, z = torch.chunk(xz, 2, dim=-1)
    if tp is not None:
        own = slice(tp.tp_rank * n, (tp.tp_rank + 1) * n)
        xr, z = xr[..., own], z[..., own]
    if cache is None or x.shape[1] > 1:
        out, xc, new_cache = _mlstm_parallel(cfg, p, xr, cache, tp)
    else:
        out, xc, new_cache = _mlstm_step(p, xr, cache, tp)
    out = out.reshape(x.shape[0], x.shape[1], d_in)
    if tp is None:
        out = rmsnorm(out, p["out_norm"], cfg.norm_eps)
    else:                                   # rmsnorm's, on this rank's channels
        var = torch.mean(out.square(), dim=-1, keepdim=True, dtype=torch.float32)
        rs = torch.rsqrt(var + cfg.norm_eps).to(dt)
        out = out[..., own] * rs * (1.0 + p["out_norm"]).to(dt)
    out = out + xc * p["skip_scale"].to(dt)
    out = out * F.silu(z)
    out = out @ p["down_proj"].to(dt)
    return (out if tp is None else tp.sum_model(out)), new_cache


def mlstm_cache_defs(cfg, batch: int, dtype=torch.float32) -> tuple:
    """The cache's buffers as (shape, dtype, fill): conv window, C, n, m."""
    d_in = cfg.d_model * cfg.mlstm_expand
    h = cfg.n_heads
    hd = d_in // h
    f32 = torch.float32
    return (((batch, 3, d_in), dtype, 0.0), ((batch, h, hd, hd), f32, 0.0),
            ((batch, h, hd), f32, 0.0), ((batch, h), f32, -1e30))


def init_mlstm_cache(cfg, batch: int, dtype=torch.float32, *, device=None):
    return tuple(torch.full(shape, fill, dtype=dt, device=device)
                 for shape, dt, fill in mlstm_cache_defs(cfg, batch, dtype))


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_defs(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    f = int(d * cfg.slstm_proj)
    return {
        "w_in": ((d, 4 * d), ("embed", "mlp"), "fan_in"),     # i,f,z,o pre-acts
        "r_rec": ((h, hd, 4 * hd), ("heads", None, None), "fan_in"),  # block-diag recurrence
        "bias": ((4 * d,), ("mlp",), "zeros"),
        "out_norm": ((d,), ("embed",), "zeros"),
        "up_gate": ((d, f), ("embed", "mlp"), "fan_in"),
        "up_proj": ((d, f), ("embed", "mlp"), "fan_in"),
        "down_proj": ((f, d), ("mlp", "embed"), "fan_in"),
    }


def _interleave(rec, d):
    """[B,H,4hd] -> [B,4d] matching the i,f,z,o split layout."""
    b = rec.shape[0]
    return torch.cat([pt.reshape(b, -1) for pt in torch.chunk(rec, 4, dim=-1)], dim=-1)


def _slstm_cell(p, carry, x_pre):
    """One sLSTM step on the heads of ``r_rec``.  carry = (c, n, m, h_prev),
    each [B, d] f32 (m [B, H]); x_pre [B, 4d] in the i, f, z, o layout."""
    h_heads, hd = p["r_rec"].shape[:2]
    d = h_heads * hd
    c, n, m, h_prev = carry
    hp = h_prev.reshape(-1, h_heads, hd)
    rec = torch.einsum("bhk,hkj->bhj", hp, p["r_rec"])          # [B,H,4hd]
    pre = x_pre + _interleave(rec, d)
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre, 4, dim=-1)    # [B,d]
    log_f = -F.softplus(-f_pre)
    i_h = i_pre.reshape(-1, h_heads, hd)
    f_h = log_f.reshape(-1, h_heads, hd)
    m_new = torch.amax(torch.maximum(f_h + m[..., None], i_h), dim=-1)  # per-head stabiliser
    scale_f = torch.exp(f_h + m[..., None] - m_new[..., None]).reshape(-1, d)
    scale_i = torch.exp(i_h - m_new[..., None]).reshape(-1, d)
    c_new = scale_f * c + scale_i * torch.tanh(z_pre)
    n_new = scale_f * n + scale_i
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new)


def apply_slstm(cfg, p, x, *, cache=None, plan=None):
    """x [B,S,d]; cache = (c, n, m, h) -> a cell step a token from the cache
    (a zero state without one).  Returns (y [B,S,d], new_cache or None).
    Under a plan (module doc) the leaves and the cache's c, n, h are this
    rank's blocks where "model" divides their sharded dims."""
    dt = x.dtype
    d = cfg.d_model
    f32 = torch.float32
    heads = plan is not None and p["r_rec"].shape[0] < cfg.n_heads   # head-parallel cell
    if plan is not None and p["w_in"].shape[1] < 4 * d:
        x_pre = (plan.copy_to_model(x) @ p["w_in"].to(dt)).to(f32) + p["bias"]
        x_pre = plan.gather_model(x_pre, dim=-1,
                                  backward="reduce-scatter" if heads else "slice")
    else:
        x_pre = (x @ p["w_in"].to(dt)).to(f32) + p["bias"]
    width = d if not heads else p["r_rec"].shape[0] * p["r_rec"].shape[1]
    carry = cache
    if cache is None:
        c, n, m, h = init_slstm_cache(cfg, x.shape[0], device=x.device)
        carry = (c[:, :width], n[:, :width], m, h[:, :width])
    if heads:
        own = slice(plan.tp_rank * width, (plan.tp_rank + 1) * width)
        x_pre = x_pre.unflatten(-1, (4, d))[..., own].flatten(-2)
        hl = p["r_rec"].shape[0]
        c, n, m, h = carry
        carry = (c, n, m[:, plan.tp_rank * hl:(plan.tp_rank + 1) * hl], h)
    cut = cache is not None and not heads and cache[0].shape[-1] < d
    if cut:                                 # a replicated cell: the blocks gathered
        c, n, m, h = carry
        c, n, h = (plan.gather_model(t, dim=-1, backward="slice") for t in (c, n, h))
        carry = (c, n, m, h)
    hs = []
    for t in range(x.shape[1]):
        carry = _slstm_cell(p, carry, x_pre[:, t])
        hs.append(carry[3])
    y = torch.stack(hs, dim=1)                                   # [B,S,d] f32
    new_cache = None if cache is None else carry
    if heads and cache is None:
        y = plan.gather_model(y, dim=-1, backward="slice")
    elif heads:                             # the whole y, and the whole m, in one gather
        c, n, m, h = carry
        y, m = plan.gather_models((y, m), dims=(2, 1), backward="slice")
        new_cache = (c, n, m, h)
    elif cut:
        own = slice(plan.tp_rank * cache[0].shape[-1], (plan.tp_rank + 1) * cache[0].shape[-1])
        c, n, m, h = carry
        new_cache = (c[:, own], n[:, own], m, h[:, own])
    y = rmsnorm(y.to(dt), p["out_norm"], cfg.norm_eps)
    block = plan is not None and p["down_proj"].shape[0] < int(d * cfg.slstm_proj)
    if block:
        y = plan.copy_to_model(y)
    g = _gelu(y @ p["up_gate"].to(dt))
    u = y @ p["up_proj"].to(dt)
    out = (g * u) @ p["down_proj"].to(dt)
    return (plan.sum_model(out) if block else out), new_cache


def slstm_cache_defs(cfg, batch: int) -> tuple:
    """The cache's buffers as (shape, dtype, fill): c, n, m, h."""
    d = cfg.d_model
    f32 = torch.float32
    return (((batch, d), f32, 0.0), ((batch, d), f32, 0.0),
            ((batch, cfg.n_heads), f32, -1e30), ((batch, d), f32, 0.0))


def init_slstm_cache(cfg, batch: int, *, device=None):
    return tuple(torch.full(shape, fill, dtype=dt, device=device)
                 for shape, dt, fill in slstm_cache_defs(cfg, batch))
