"""Mamba (S6 selective-state-space) sequence mixer — Jamba's non-attention
layers [Lieber et al., arXiv:2403.19887; Gu & Dao, arXiv:2312.00752].

Port of ``repro/models/mamba.py`` in plain PyTorch.  The selective scan
h_t = Ā_t·h_{t-1} + B̄_t·x_t composes elementwise affine maps,
(a₂, b₂) ∘ (a₁, b₁) = (a₂a₁, a₂b₁ + b₂).  The reference evaluates it with
``jax.lax.associative_scan``; PyTorch has no public counterpart, so the port
runs the same composition as a log-depth doubling scan over S (⌈log₂ S⌉
steps of whole-tensor ops), whose first component ∏dA folds the initial
state h0 in exactly as the reference does.  Sums associate in another
tree, so values agree to f32 round-off.  Decode is the same path at S = 1.

Under a plan (``parallel.sharding.Plan``) the block is channel-parallel
over ``d_in``: the conv, ``dt_proj``, ``dt_bias``, ``a_log``, ``d_skip``,
the scan and the cache blocks (conv window and h) are this rank's
channels; ``x_proj`` and ``out_proj`` are row-parallel, their partial sums
added over "model" (Megatron's g; ``x_proj``'s sum then enters the rank's
channels again through f).  ``in_proj``'s sharded dim is the concatenation
[x | z], so a contiguous block of it does not hold x and z of the same
channels: x enters through f, the product is all-gathered over "model",
and each rank keeps x and z of its own channels, so the gather's backward
is a reduce-scatter (each rank's gradient reaches only its channels).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dt_rank(cfg) -> int:
    return max(16, cfg.d_model // 16)


def mamba_defs(cfg) -> dict:
    d = cfg.d_model
    d_in = d * cfg.mamba_expand
    n = cfg.mamba_d_state
    r = _dt_rank(cfg)

    def a_log_init(_generator, shape, lead, device):
        # S4D-real initialisation: A = -(1..n) per channel.
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(*lead, *shape).clone()

    def dt_bias_init(_generator, shape, lead, device):
        return torch.full((*lead, *shape), math.log(math.e - 1) - 2.0, dtype=torch.float32,
                          device=device)

    return {
        "in_proj": ((d, 2 * d_in), ("embed", "mlp"), "fan_in"),
        "conv_w": ((cfg.mamba_d_conv, d_in), (None, "mlp"), "fan_in"),
        "conv_b": ((d_in,), ("mlp",), "zeros"),
        "x_proj": ((d_in, r + 2 * n), ("mlp", None), "fan_in"),
        "dt_proj": ((r, d_in), (None, "mlp"), "fan_in"),
        "dt_bias": ((d_in,), ("mlp",), dt_bias_init),
        "a_log": ((d_in, n), ("mlp", None), a_log_init),
        "d_skip": ((d_in,), ("mlp",), "ones"),
        "out_proj": ((d_in, d), ("mlp", "embed"), "fan_in"),
    }


def _ssm_inputs(cfg, p, xc, plan=None):
    """Per-step discretised (dA, dB·x, C).

    xc [B, S, d_in] (post-conv, post-silu) -> dA [B,S,d_in,N], dBx same,
    c [B,S,N], all f32.  Under a plan xc is this rank's channels, and
    ``x_proj``'s partial sums are added over "model" (g, then f).
    """
    n = cfg.mamba_d_state
    r = _dt_rank(cfg)
    proj = xc @ p["x_proj"].to(xc.dtype)                         # [B,S,r+2N]
    if plan is not None and xc.shape[-1] < cfg.d_model * cfg.mamba_expand:
        proj = plan.copy_to_model(plan.sum_model(proj))
    dt_in, b_ssm, c_ssm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"].to(xc.dtype)).to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])                                   # [d_in, N] f32
    da = torch.exp(dt[..., None] * a)                            # [B,S,d_in,N]
    dbx = (dt * xc.to(torch.float32))[..., None] * b_ssm.to(torch.float32)[..., None, :]
    return da, dbx, c_ssm.to(torch.float32)


def scan_affine(a, b):
    """Inclusive scan over dim 1 of the affine maps h -> a·h + b:
    (∏_{r≤t} a_r, h_t from h = 0), by log-depth doubling."""
    shift, s = 1, a.shape[1]
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return a, b


def apply_mamba(cfg, p, x, *, cache=None, plan=None):
    """x [B, S, d]; cache=(conv_state [B, d_conv-1, d_in], h [B, d_in, N]).

    Returns (y [B, S, d], new_cache); cache=None -> no state returned.
    Under a plan (module doc) d_in is this rank's channels.
    """
    dt_ = x.dtype
    d_in = cfg.d_model * cfg.mamba_expand
    split = plan is not None and p["conv_b"].shape[0] < d_in
    if plan is not None and p["in_proj"].shape[1] < 2 * d_in:
        xz = plan.copy_to_model(x) @ p["in_proj"].to(dt_)
        xz = plan.gather_model(xz, dim=-1, backward="reduce-scatter" if split else "slice")
    else:
        xz = x @ p["in_proj"].to(dt_)
    xr, z = torch.chunk(xz, 2, dim=-1)                           # [B,S,d_in] each
    if split:
        d_in = p["conv_b"].shape[0]
        own = slice(plan.tp_rank * d_in, (plan.tp_rank + 1) * d_in)
        xr, z = xr[..., own], z[..., own]

    # -- causal depthwise conv --------------------------------------------------
    kw = cfg.mamba_d_conv
    if cache is None:
        pad = torch.zeros((x.shape[0], kw - 1, d_in), dtype=dt_, device=x.device)
    else:
        conv_state, h0 = cache
        pad = conv_state.to(dt_)
    xp = torch.cat([pad, xr], dim=1)
    s = xr.shape[1]
    xc = sum(xp[:, i:i + s, :] * p["conv_w"][i].to(dt_) for i in range(kw))
    xc = F.silu(xc + p["conv_b"].to(dt_))

    da, dbx, c_ssm = _ssm_inputs(cfg, p, xc, plan)
    cum_a, hs = scan_affine(da, dbx)
    if cache is None:
        new_cache = None
    else:
        hs = hs + cum_a * h0[:, None]
        new_cache = (xp[:, -(kw - 1):, :].to(conv_state.dtype), hs[:, -1])

    y = torch.einsum("bsdn,bsn->bsd", hs, c_ssm).to(dt_)
    y = y + xc * p["d_skip"].to(dt_)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(dt_)
    if plan is not None and p["out_proj"].shape[0] < cfg.d_model * cfg.mamba_expand:
        out = plan.sum_model(out)
    return out, new_cache


def mamba_cache_defs(cfg, batch: int, dtype=torch.float32) -> tuple:
    """The cache's buffers as (shape, dtype, fill): conv window, h."""
    d_in = cfg.d_model * cfg.mamba_expand
    return (((batch, cfg.mamba_d_conv - 1, d_in), dtype, 0.0),
            ((batch, d_in, cfg.mamba_d_state), torch.float32, 0.0))


def init_mamba_cache(cfg, batch: int, dtype=torch.float32, *, device=None):
    return tuple(torch.full(shape, fill, dtype=dt, device=device)
                 for shape, dt, fill in mamba_cache_defs(cfg, batch, dtype))
