"""Training losses: causal-LM cross entropy with z-loss and MoE aux.

Port of ``repro/models/losses.py``.  Under a train plan whose logits are
this rank's block of the vocab columns (``layers.logits_from_hidden``) the
loss is vocab-parallel: log Z is a max over the blocks (detached, all-
reduced by max) plus the log of the exponentials' sum, and the gold logit
a masked pick from the block that holds it; both sums pass Megatron's g
(one all-reduce over "model"), so every model rank computes the same
loss, bit for bit, and each rank's logits take the gradient of their own
columns.
"""

from __future__ import annotations

import torch


def _logz_gold(logits, labels, plan):
    """(log Z, the gold logit) [B, S] of f32 logits [B, S, V]: the
    reference's ``logsumexp`` and pick on whole logits, the vocab-parallel
    sums (module doc) on a rank's block."""
    if plan is None or logits.shape[-1] == plan.cfg.vocab_size:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
        return logz, gold
    v_loc = logits.shape[-1]
    top = plan.reduce(torch.amax(logits.detach(), dim=-1), "model", op="max")
    sumexp = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
    local = labels.long() - plan.tp_rank * v_loc
    own = (local >= 0) & (local < v_loc)
    picked = torch.take_along_dim(logits, local.clamp(0, v_loc - 1)[..., None], dim=-1)[..., 0]
    sumexp, gold = plan.sum_model(torch.stack([sumexp, torch.where(own, picked, 0.0)]))
    return top + torch.log(sumexp), gold


def lm_loss(cfg, logits, labels, *, mask=None, z_loss: float = 1e-4, moe_aux=0.0, plan=None):
    """Next-token CE.  logits [B, S, V] (f32), labels [B, S] (already shifted
    by the data pipeline).  Returns (loss, metrics dict).  ``plan``: a train
    plan, under which ``logits`` may be this rank's vocab block (module
    doc)."""
    logits = logits.to(torch.float32)
    logz, gold = _logz_gold(logits, labels, plan)
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
