"""Pure step functions: the microbatched training step and the serving steps.

Port of ``repro/runtime/steps.py``.  ``train_step`` is one optimizer step:
gradient accumulation over ``cfg.microbatches`` (one microbatch's
activations live at a time), global-norm clipping, AdamW, loss metrics.
The reference's step is a pure function whose launcher donates the state;
the port's updates the state in place and returns it (``optim.adamw``),
once every microbatch's gradient exists, so a step that raises before its
update leaves the state bitwise as it was.

Under an active mesh (``parallel.sharding.use_mesh``) the step is the
reference's GSPMD step as explicit collectives over ``torch.distributed``
(DESIGN.md §5), on each rank's local blocks (``parallel.sharding.Plan``
with ``train=True``):

* the state is stored sharded by ``state_pspecs`` (params and AdamW
  moments by ``param_pspecs``), each leaf this rank's block, and nothing
  gathers the whole tree;
* each microbatch's rows are cut per rank over the batch axes (the anchor
  of ``repro/runtime/steps.py:45-55``), so microbatch i of the reference's
  reshape is split across the data ranks; ranks along "model" see the same
  rows and run Megatron tensor-parallel compute over "model" (attention
  heads, MLP columns and rows, Mamba's channels, MoE experts, the vocab of
  the embedding, the logits and the loss), with f and g and their backward
  collectives (``models/layers.py``);
* each unit gathers its leaves as it runs, over the axes their use does
  not keep, and a ``"full"`` recompute gathers them again; a gather over
  an axis that cuts the rows reduce-scatters its gradient, so the
  gradients arrive as this rank's blocks;
* each rank's token share of the step is known before the first
  microbatch (one scalar all-reduce of the counts), and each microbatch's
  loss is scaled by it and by 1/m, so the reduce-scatters sum gradients
  already weighted as the reference's batch mean weighs them; the
  gradients accumulate in the local blocks in microbatch order; a leaf
  whose spec does not name an axis that cuts the rows has its gradient
  all-reduced over that axis once a step; the metrics are weighted alike;
* the global norm is computed from the local blocks (each leaf counted
  once, ``Plan.global_norm``), and AdamW updates each rank's blocks of
  params and moments, exact because AdamW is elementwise.

The serving steps under an active mesh run on this rank's blocks by the
same plan: the params as stored by ``param_pspecs``, each block gathering
its own leaves; the cache as laid out by ``cache_pspecs``, allocated as
such; tensor-parallel compute over "model"; each rank its rows of the
batch (``sharding.serve_rows``).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models import decode_step as model_decode
from ..models import forward, init_params, lm_loss
from ..models import prefill as model_prefill
from ..optim import AdamWConfig, apply_updates, init_opt_state
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


def loss_fn(cfg, params, batch, plan=None):
    logits, aux = forward(cfg, params, batch["tokens"], context=batch.get("context"),
                          plan=plan)
    return lm_loss(cfg, logits, batch["labels"], moe_aux=aux, plan=plan)


def _accumulate(cfg, params, batch: dict, *, cut=None, plan=None, scale=None):
    """The f32 gradients (a list in ``tree_leaves(params)`` order, zeros
    where the loss does not reach a leaf) and the metrics' sums over the
    step's microbatches, each microbatch's rows ``cut`` from the
    reference's reshape (all of them by default); summed in microbatch
    order.  ``scale``: each microbatch's loss scaled by it before its
    backward (default: the gradients summed unscaled)."""
    m = cfg.microbatches
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    f32 = torch.float32
    grads = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in leaves]
    sums = {k: torch.zeros((), dtype=f32, device=leaves[0].device) for k in _METRICS}
    for i in range(m):
        mb = {k: v.reshape(m, -1, *v.shape[1:])[i] for k, v in batch.items()}
        if cut is not None:
            mb = {k: cut(v) for k, v in mb.items()}
        loss, metrics = loss_fn(cfg, params, mb, plan)
        g = torch.autograd.grad(loss if scale is None else loss * scale, leaves,
                                allow_unused=True)
        with torch.no_grad():
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(gi.to(f32))
            for k in _METRICS:
                sums[k] = sums[k] + metrics[k].detach()
    return grads, sums


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
    sharded step of the module doc, and its metrics are the global
    batch's, the same on every rank.
    """
    mesh = sharding.active_mesh()
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, state, batch, mesh)
    m = cfg.microbatches
    grads, sums = _accumulate(cfg, state["params"], batch)
    with torch.no_grad():
        grads = [g / m for g in grads]
        metrics = {k: v / m for k, v in sums.items()}
        metrics["tokens"] = sums["tokens"]
        metrics.update(apply_updates(opt_cfg, state["params"], state["opt"], grads,
                                     state["step"]))
        state["step"].add_(1)
    return state, metrics


def _sharded_train_step(cfg, opt_cfg, state, batch, mesh):
    m = cfg.microbatches
    labels = batch["labels"]
    plan = sharding.Plan(cfg, mesh, train=True, rows=labels.shape[0] // m)
    row_spec = sharding.P(plan.row_axes)
    with torch.no_grad():
        # this rank's share of the step's tokens (every label counts: the
        # loss takes no mask), known from the batch before any microbatch
        blocks = sharding.shard_count(row_spec[0], mesh)
        local = torch.full((), labels.numel() // blocks, dtype=torch.float32,
                           device=labels.device)
        total = plan.reduce(local.clone(), plan.row_axes)
        share = local / total
    grads, sums = _accumulate(cfg, state["params"], batch, plan=plan, scale=share / m,
                              cut=lambda x: sharding.shard(x, row_spec, mesh))
    with torch.no_grad():
        _reduce_replicated(plan, grads)
        names = [k for k in _METRICS if k != "tokens"]
        vec = torch.stack([sums[k] * (share / m) for k in names])
        metrics = dict(zip(names, plan.reduce(vec, plan.row_axes).unbind()))
        metrics["tokens"] = total
        metrics.update(apply_updates(opt_cfg, state["params"], state["opt"], grads,
                                     state["step"], gnorm=plan.global_norm(grads)))
        state["step"].add_(1)
    return state, metrics


def _reduce_replicated(plan, grads: list) -> None:
    """Sum, in place, each gradient block over the axes that cut the rows
    and that its leaf's spec does not name (its reduce-scatters covered the
    others): one all-reduce a set of such axes, over the blocks flattened
    together."""
    groups: dict[tuple, list] = {}
    for g, spec in zip(grads, sharding.spec_leaves(plan.pspecs), strict=True):
        named = {a for e in spec for a in sharding.entry_axes(e)}
        axes = tuple(a for a in plan.row_axes if a not in named)
        if axes:
            groups.setdefault(axes, []).append(g)
    for axes, gs in groups.items():
        flat = plan.reduce(torch.cat([g.reshape(-1) for g in gs]), axes)
        for g, part in zip(gs, flat.split([g.numel() for g in gs]), strict=True):
            g.copy_(part.view_as(g))


def _serve_plan(cfg):
    mesh = sharding.active_mesh()
    return None if mesh is None else sharding.Plan(cfg, mesh)


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
