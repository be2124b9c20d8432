"""Training losses: causal-LM cross entropy with z-loss and MoE aux.

Port of ``repro/models/losses.py``.
"""

from __future__ import annotations

import torch


def lm_loss(cfg, logits, labels, *, mask=None, z_loss: float = 1e-4, moe_aux=0.0):
    """Next-token CE.  logits [B, S, V] (f32), labels [B, S] (already shifted
    by the data pipeline).  Returns (loss, metrics dict)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    ce = logz - gold
    if mask is None:
        mask = torch.ones_like(ce)
    mask = mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce_mean = torch.sum(ce * mask) / denom
    zl = z_loss * torch.sum((logz * mask) ** 2) / denom
    aux = cfg.router_aux_weight * moe_aux if cfg.n_experts else 0.0
    loss = ce_mean + zl + aux
    metrics = {
        "loss": loss,
        "ce": ce_mean,
        "z_loss": zl,
        "moe_aux": torch.as_tensor(moe_aux, dtype=torch.float32, device=logits.device),
        "tokens": denom,
    }
    return loss, metrics
