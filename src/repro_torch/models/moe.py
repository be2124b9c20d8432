"""Mixture-of-Experts channel mixer (qwen3-MoE / Jamba style top-k routing).

Port of ``repro/models/moe.py``.  Token-choice top-k routing with
GShard-style *groups*: each sequence (batch element) dispatches
independently with capacity C = cf·k·S/E, its slots beyond C written to a
scratch row C that the combine weighs by zero (Switch/GShard drop).  The
position of a slot in its expert's queue is a per-group one-hot running
count, as in the reference (not a sort).

Two routes, chosen as the reference chooses them:

* ``_moe_dense_tokens`` → ``_moe_block_dense`` (no plan, or a plan whose
  model axis divides neither the experts nor their FFN width): every
  expert's FFN runs densely over the whole [B, E, C+1, d] capacity buffer;
* ``_own_experts`` under a plan (``plan``: ``parallel.sharding.Plan``;
  serving and the train step alike) whose expert weights are this rank's
  block: its E/tp experts (expert parallelism, where "model" divides E;
  ``repro/models/moe.py:87-125``), else every expert's block of the FFN
  columns and rows (where "model" divides only moe_d_ff).  Each rank runs
  its block over the buffer of its rows, combines its slots per token,
  sums the k slots, and one token-sized all-reduce over "model" (g)
  completes the combine.  The tokens it dispatches and the combine
  weights pass Megatron's f, so the backward sums their gradients over
  "model" (each rank's reaches only its own slots); the weights'
  gradients stay the rank's blocks.  The router, gathered whole, routes
  every token over all experts on every rank.

Returns the Switch load-balance aux loss beside the output, as the
reference does.  Under a train plan its two per-expert means are the whole
batch's: averaged over the ranks that cut the rows (one all-reduce, and
one in the backward), so every rank's aux is the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _gelu


def moe_defs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": ((d, e), ("embed", "expert"), "fan_in"),
        "wi_gate": ((e, d, f), ("expert", "embed", "mlp"), "fan_in"),
        "wi_up": ((e, d, f), ("expert", "embed", "mlp"), "fan_in"),
        "wo": ((e, f, d), ("expert", "mlp", "embed"), "fan_in"),
    }


def _group_positions(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each slot within its expert's queue, per group.

    flat_e [B, S·k] int -> pos [B, S·k] via a one-hot running count."""
    onehot = F.one_hot(flat_e, n_experts)                        # [B, S·k, E]
    running = torch.cumsum(onehot, dim=1) - 1
    return torch.gather(running, -1, flat_e[..., None])[..., 0]


def _expert_ffn(cfg, buf, wg, wu, wo):
    """buf [..., E, C, d] batched-expert FFN."""
    dt = buf.dtype
    act = F.silu if cfg.mlp_act == "silu" else _gelu
    g = act(torch.einsum("...ecd,edf->...ecf", buf, wg.to(dt)))
    u = torch.einsum("...ecd,edf->...ecf", buf, wu.to(dt))
    return torch.einsum("...ecf,efd->...ecd", g * u, wo.to(dt))


def _combine_local(out_e, flat_e, safe_pos, w, e_start, e_count, cap):
    """Per-group combine of the experts' outputs.

    out_e [G, E_loc, C+1, d]; flat_e/safe_pos/w [G, S·k] -> [G, S·k, d].
    Slots routed outside [e_start, e_start + e_count) or to the scratch row
    contribute zero."""
    local_e = flat_e - e_start
    own = (local_e >= 0) & (local_e < e_count) & (safe_pos < cap)
    idx_e = torch.clamp(local_e, 0, e_count - 1)
    g = torch.arange(out_e.shape[0], device=out_e.device)[:, None]
    vals = out_e[g, idx_e, safe_pos]                             # [G, S·k, d]
    return vals * (w * own)[..., None].to(vals.dtype)


def _moe_block_dense(cfg, buf, params, flat_e, safe_pos, w, cap):
    """Single-device route: all experts local."""
    out = _expert_ffn(cfg, buf, params["wi_gate"], params["wi_up"], params["wo"])
    return _combine_local(out, flat_e, safe_pos, w, 0, cfg.n_experts, cap)


def _own_experts(cfg, buf, wg, wu, wo, j, flat_e, safe_pos, w, cap):
    """Block ``j`` of the experts (weights ``wg``/``wu``/``wo``, E_loc of
    them, each whole or a block of its FFN width): their FFN over their
    slice of the buffer, the combine of their slots, the k slots summed per
    token: y [G, S, d], this rank's part."""
    e_loc = wg.shape[0]
    own = slice(j * e_loc, (j + 1) * e_loc)
    out_e = _expert_ffn(cfg, buf[:, own], wg, wu, wo)
    y = _combine_local(out_e, flat_e, safe_pos, w, j * e_loc, e_loc, cap)
    # Sum the k slots per token BEFORE the all-reduce: the wire then carries
    # [G, S, d] (token-sized) instead of [G, S·k, d].
    g_loc, sk, dd = y.shape
    return torch.sum(y.reshape(g_loc, sk // cfg.top_k, cfg.top_k, dd), dim=2)


def _moe_dense_tokens(cfg, buf, params, flat_e, safe_pos, w, cap):
    """The dense route, token-major [B, S, d]."""
    slots = _moe_block_dense(cfg, buf, params, flat_e, safe_pos, w, cap)
    b, sk, d = slots.shape
    return torch.sum(slots.reshape(b, sk // cfg.top_k, cfg.top_k, d), dim=2)


def capacity(cfg, s: int) -> int:
    """Slots an expert takes per group of ``s`` tokens."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * s // cfg.n_experts))


def route(cfg, p, x):
    """The f32 router on x [B, S, d]: (probs [B, S, E], top_p [B, S, k]
    renormalised, top_e [B, S, k])."""
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def apply_moe(cfg, p, x, *, plan=None):
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar f32).  ``plan``: a
    plan, whose expert leaves may be this rank's block (module doc)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype

    # -- routing (f32) and the Switch load-balance loss -------------------------
    probs, top_p, top_e = route(cfg, p, x)
    me = torch.mean(probs, dim=(0, 1))                           # mean router prob [E]
    dispatched = F.one_hot(top_e, e).to(torch.float32)           # [B, S, k, E]
    ce = torch.mean(torch.sum(dispatched, dim=2), dim=(0, 1)) / k
    if plan is not None and plan.train:
        me, ce = plan.mean_rows(torch.stack([me, ce]))          # the whole batch's means
    aux = e * torch.sum(me * ce)

    # -- per-group dispatch positions -------------------------------------------
    cap = capacity(cfg, s)
    flat_e = top_e.reshape(b, s * k)
    pos = _group_positions(flat_e, e)                            # [B, S·k]
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap)                       # overflow -> scratch row
    tok_idx = torch.arange(s, device=x.device).repeat_interleave(k)  # [S·k]

    # -- dispatch: group-local scatter into [B, E, C+1, d].  Overflowed slots
    # all write the scratch row, in no set order; the combine weighs it by 0.
    w = (top_p.reshape(b, s * k) * keep).to(dt)
    block = plan is not None and (p["wi_gate"].shape[0] < e or p["wo"].shape[1] < cfg.moe_d_ff)
    if block:
        x, w = plan.copy_to_model(x), plan.copy_to_model(w)
    buf = torch.zeros((b, e, cap + 1, d), dtype=dt, device=x.device)
    g = torch.arange(b, device=x.device)[:, None]
    buf[g, flat_e, safe_pos] = x[:, tok_idx]

    # -- expert FFNs + combine ---------------------------------------------------
    if not block:
        return _moe_dense_tokens(cfg, buf, p, flat_e, safe_pos, w, cap), aux
    j = plan.tp_rank if p["wi_gate"].shape[0] < e else 0
    y = _own_experts(cfg, buf, p["wi_gate"], p["wi_up"], p["wo"], j, flat_e, safe_pos, w, cap)
    return plan.sum_model(y), aux
