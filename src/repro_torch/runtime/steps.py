"""Pure step functions: the microbatched training step and the serving steps.

Port of ``repro/runtime/steps.py``.  ``train_step`` is one optimizer step:
gradient accumulation over ``cfg.microbatches`` (one microbatch's
activations live at a time), global-norm clipping, AdamW, loss metrics.
The reference's step is a pure function whose launcher donates the state;
the port's updates the state in place and returns it (``optim.adamw``),
once every microbatch's gradient exists, so a step that raises before its
update leaves the state bitwise as it was.

Under an active mesh (``parallel.sharding.use_mesh``) the step is ZeRO-3
over ``torch.distributed``, the reference's GSPMD step as explicit
collectives (DESIGN.md §5):

* the state is stored sharded by ``state_pspecs`` (params and AdamW
  moments by ``param_pspecs``), each leaf this rank's block;
* the params are gathered whole for the step;
* each microbatch's rows are cut per rank over the batch axes (the anchor
  of ``repro/runtime/steps.py:45-55``), so microbatch i of the reference's
  reshape is split across the data ranks;
* the f32 gradients are summed over the batch axes, each rank's weighted
  by its share of the step's tokens (``lm_loss`` divides by the mask's
  sum); the metrics likewise;
* the global norm is the reduced full gradient's, and AdamW updates each
  rank's shard of params and moments, exact because AdamW is elementwise.

Ranks along "model" see the same rows and compute the same step; the one
explicit compute split over "model" is the MoE expert block
(``models/moe.py``).  Megatron tensor-parallel compute over "model" and
per-unit gathering are not ported to the train step (ROADMAP.md Queue 1
item 13e).

The serving steps under an active mesh run on this rank's blocks
(``parallel.sharding.ServePlan``): the params as stored by
``param_pspecs``, each block gathering its own leaves; the cache as laid
out by ``cache_pspecs``, allocated as such; tensor-parallel compute over
"model"; each rank its rows of the batch (``sharding.serve_rows``).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import decode_step as model_decode
from ..models import forward, init_params, lm_loss
from ..models import prefill as model_prefill
from ..models.model import _shard_activations, activation_axes
from ..optim import AdamWConfig, apply_updates, global_norm, init_opt_state
from ..optim.adamw import tree_leaves
from ..parallel import sharding

_METRICS = ("loss", "ce", "z_loss", "moe_aux", "tokens")


def init_train_state(cfg, generator: torch.Generator, *, device=None) -> dict:
    """``{"params", "opt": {"m", "v"}, "step"}`` on ``device`` (default
    ``cuda``): params drawn from ``generator`` (``models.init_params``),
    zero f32 moments, step a device int32 scalar."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, device=dev)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_pspecs(cfg, mesh) -> dict:
    """The train state's spec tree: params and both moments by
    ``param_pspecs``, the step replicated."""
    pspecs = sharding.param_pspecs(cfg, mesh)
    return {"params": pspecs, "opt": {"m": pspecs, "v": pspecs}, "step": sharding.P()}


def loss_fn(cfg, params, batch):
    logits, aux = forward(cfg, params, batch["tokens"], context=batch.get("context"))
    return lm_loss(cfg, logits, batch["labels"], moe_aux=aux)


def _accumulate(cfg, params, batch: dict, cut):
    """The f32 gradients (a list in ``tree_leaves(params)`` order, zeros
    where the loss does not reach a leaf) and the metrics of the step's
    microbatches, each microbatch's rows ``cut`` from the reference's
    reshape; summed in microbatch order, then divided by m."""
    m = cfg.microbatches
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    f32 = torch.float32
    grads = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in leaves]
    sums = {k: torch.zeros((), dtype=f32, device=leaves[0].device) for k in _METRICS}
    for i in range(m):
        mb = {k: cut(v.reshape(m, -1, *v.shape[1:])[i]) for k, v in batch.items()}
        loss, metrics = loss_fn(cfg, params, mb)
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
    return grads, metrics


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

    Under an active mesh the state holds this rank's shards
    (``state_pspecs``; ``parallel.sharding.tree_shard`` makes them) and
    ``batch`` is the whole global batch on every rank: the step is the
    ZeRO-3 step of the module doc, and its metrics are the global batch's.
    """
    mesh = sharding.active_mesh()
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, state, batch, mesh)
    grads, metrics = _accumulate(cfg, state["params"], batch, lambda x: x)
    with torch.no_grad():
        metrics.update(apply_updates(opt_cfg, state["params"], state["opt"], grads,
                                     state["step"]))
        state["step"].add_(1)
    return state, metrics


def _sharded_train_step(cfg, opt_cfg, state, batch, mesh):
    pspecs = sharding.param_pspecs(cfg, mesh)
    specs = sharding.spec_leaves(pspecs)
    with torch.no_grad():
        full = sharding.tree_gather(state["params"], pspecs, mesh)
    grads, metrics = _accumulate(cfg, full, batch, lambda x: _shard_activations(x, cfg))
    rows = next(iter(batch.values())).shape[0] // cfg.microbatches
    axes = sharding.entry_axes(
        sharding.fit_spec(mesh, (rows,), activation_axes(cfg))[0])
    with torch.no_grad():
        # each rank's gradients and metrics weighted by its share of the tokens
        local = metrics["tokens"]
        total = sharding.all_reduce(local.clone(), axes, mesh)
        share = local / total
        for g in grads:
            sharding.all_reduce(g.mul_(share), axes, mesh)
        names = [k for k in _METRICS if k != "tokens"]
        vec = torch.stack([metrics[k] * share for k in names])
        sharding.all_reduce(vec, axes, mesh)
        metrics = dict(zip(names, vec.unbind()))
        metrics["tokens"] = total
        gnorm = global_norm(grads)
        local_grads = [sharding.shard(g, spec, mesh) for g, spec in zip(grads, specs,
                                                                         strict=True)]
        del full, grads
        metrics.update(apply_updates(opt_cfg, state["params"], state["opt"], local_grads,
                                     state["step"], gnorm=gnorm))
        state["step"].add_(1)
    return state, metrics


def _serve_plan(cfg):
    mesh = sharding.active_mesh()
    return None if mesh is None else sharding.ServePlan(cfg, mesh)


def serve_prefill(cfg, params, tokens, context=None, *, max_len: int | None = None,
                  batch: int | None = None):
    """Prefill: returns (last-position logits [B, V], cache).

    Under an active mesh: ``params`` this rank's stored blocks, ``tokens``
    (and ``context``) its rows of a global batch of ``batch`` rows
    (``sharding.serve_rows``; default the rows given times the batch axes'
    size), and the cache returned this rank's blocks; logits [B_local, V]
    with every vocab column."""
    max_len = max_len or tokens.shape[1]
    logits, cache = model_prefill(cfg, params, tokens, max_len=max_len, context=context,
                                  plan=_serve_plan(cfg), batch=batch)
    return logits[:, -1, :], cache


def serve_decode(cfg, params, cache, tokens):
    """One decode step: (logits [B, V], new cache).  Under an active mesh on
    this rank's blocks and rows, as ``serve_prefill``."""
    logits, cache = model_decode(cfg, params, cache, tokens, plan=_serve_plan(cfg))
    return logits[:, -1, :], cache
