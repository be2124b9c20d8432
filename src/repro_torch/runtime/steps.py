"""Pure step functions: the microbatched training step and the serving steps.

Port of ``repro/runtime/steps.py``.  ``train_step`` is one optimizer step:
gradient accumulation over ``cfg.microbatches`` (one microbatch's
activations live at a time), global-norm clipping, AdamW, loss metrics.
The reference's step is a pure function whose launcher donates the state;
the port's updates the state in place and returns it (``optim.adamw``),
once every microbatch's gradient exists, so a step that raises before its
update leaves the state bitwise as it was.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import decode_step as model_decode
from ..models import forward, init_params, lm_loss
from ..models import prefill as model_prefill
from ..optim import AdamWConfig, apply_updates, init_opt_state
from ..optim.adamw import tree_leaves

_METRICS = ("loss", "ce", "z_loss", "moe_aux", "tokens")


def init_train_state(cfg, generator: torch.Generator, *, device=None) -> dict:
    """``{"params", "opt": {"m", "v"}, "step"}`` on ``device`` (default
    ``cuda``): params drawn from ``generator`` (``models.init_params``),
    zero f32 moments, step a device int32 scalar."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, device=dev)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_fn(cfg, params, batch):
    logits, aux = forward(cfg, params, batch["tokens"], context=batch.get("context"))
    return lm_loss(cfg, logits, batch["labels"], moe_aux=aux)


def train_step(cfg, opt_cfg: AdamWConfig, state: dict, batch: dict):
    """One optimizer step with gradient accumulation, in place.

    batch: {"tokens" [B, S], "labels" [B, S], "context"? [B, T, d]} on the
    state's device, B = cfg.microbatches · per-microbatch batch; microbatch
    i is rows ``x.reshape(m, -1, ...)[i]``, as in the reference.  The f32
    gradients are summed in microbatch order, then divided by m.  Returns
    (state, metrics): the same state dict, its params, moments and step
    updated where they lie, and device scalars ``loss``, ``ce``,
    ``z_loss``, ``moe_aux``, ``tokens``, ``grad_norm``, ``lr``.  The step
    turns ``requires_grad`` on for the params itself, so a state restored
    from a checkpoint trains.
    """
    m = cfg.microbatches
    params = state["params"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def microbatch(i):
        return {k: v.reshape(m, -1, *v.shape[1:])[i] for k, v in batch.items()}

    f32 = torch.float32
    grads = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in leaves]
    sums = {k: torch.zeros((), dtype=f32, device=leaves[0].device) for k in _METRICS}
    for i in range(m):
        loss, metrics = loss_fn(cfg, params, microbatch(i))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(gi.to(f32))
            for k in _METRICS:
                sums[k] = sums[k] + metrics[k].detach()
    with torch.no_grad():
        grads = [g / m for g in grads]
        metrics = {k: v / m for k, v in sums.items()}
        metrics["tokens"] = metrics["tokens"] * m
        metrics.update(apply_updates(opt_cfg, params, state["opt"], grads, state["step"]))
        state["step"].add_(1)
    return state, metrics


def serve_prefill(cfg, params, tokens, context=None, *, max_len: int | None = None):
    """Prefill: returns (last-position logits [B, V], cache)."""
    max_len = max_len or tokens.shape[1]
    logits, cache = model_prefill(cfg, params, tokens, max_len=max_len, context=context)
    return logits[:, -1, :], cache


def serve_decode(cfg, params, cache, tokens):
    """One decode step: (logits [B, V], new cache)."""
    logits, cache = model_decode(cfg, params, cache, tokens)
    return logits[:, -1, :], cache
