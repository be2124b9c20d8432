"""The rank side of tests/test_torch_parallel_train_archs.py and
tests/test_torch_parallel_functions.py: a module that imports torch and the
port only, so each spawned rank starts without the JAX package."""

import dataclasses

import torch

from repro_torch import configs, convert
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import losses
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import sharding
from repro_torch.runtime import steps

AXES = ("data", "model")


def _refuse(*_args, **_kw):
    raise AssertionError("the train step gathered the whole param tree")


def _mesh(shape):
    return make_mesh(shape, AXES[-len(shape):], device_type="cpu")


def train_rank(rank, shape, cases, opt):
    """Each case (arch, remat, numpy train state, numpy batch) trained one
    step on this rank of a ("data", "model") mesh of ``shape``: its state
    blocks, the global batch, ``sharding.tree_gather`` refusing while it
    steps.  Returns a case its metrics, the moments and params gathered
    whole, the recorded collectives and the elements it stores."""
    mesh = _mesh(shape)
    out = []
    for arch, remat, host, batch in cases:
        cfg = dataclasses.replace(configs.smoke_config(arch), remat=remat)
        specs = steps.state_pspecs(cfg, mesh)
        state = sharding.tree_shard(convert.train_state_from_reference(host, device="cpu"),
                                    specs, mesh)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        whole, sharding.tree_gather = sharding.tree_gather, _refuse
        try:
            with sharding.use_mesh(mesh), sharding.record_collectives() as events:
                state, metrics = steps.train_step(cfg, AdamWConfig(**opt), state, tb)
        finally:
            sharding.tree_gather = whole
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "m": sharding.tree_gather(state["opt"]["m"], specs["params"], mesh),
                    "v": sharding.tree_gather(state["opt"]["v"], specs["params"], mesh),
                    "params": sharding.tree_gather(state["params"], specs["params"], mesh),
                    "events": [dict(e) for e in events],
                    "local_numel": sum(t.numel() for t in
                                       tree_leaves(state["params"]))})
    return out


# ---------------------------------------------------------------------------
# Megatron's f and g, and the gathers' two backwards
# ---------------------------------------------------------------------------


def _plan(shape, rows=None):
    mesh = _mesh(shape)
    return sharding.Plan(configs.smoke_config("granite-8b"), mesh, train=True, rows=rows)


def _rows(plan, x):
    """This rank's rows of ``x`` over the axes that cut them."""
    return sharding.shard(torch.as_tensor(x), sharding.P(plan.row_axes), plan.mesh)


def megatron_mlp_rank(rank, shape, x, w1, w2, r):
    """act(f(x) @ w1[:, block]) @ w2[block, :] summed by g over "model", on
    this rank's rows of x: the output and the gradients of sum(out · r) for
    x and this rank's blocks of w1 and w2."""
    plan = _plan(shape, rows=x.shape[0])
    f = w1.shape[1] // plan.tp
    xs = _rows(plan, x).requires_grad_(True)
    b1 = torch.as_tensor(w1)[:, plan.tp_rank * f:(plan.tp_rank + 1) * f].clone()
    b2 = torch.as_tensor(w2)[plan.tp_rank * f:(plan.tp_rank + 1) * f].clone()
    b1.requires_grad_(True)
    b2.requires_grad_(True)
    out = plan.sum_model(torch.tanh(plan.copy_to_model(xs) @ b1) @ b2)
    gx, g1, g2 = torch.autograd.grad((out * _rows(plan, r)).sum(), (xs, b1, b2))
    return out.detach(), gx, g1, g2


def gather_rank(rank, shape, w, xs, cases):
    """``w`` cut by the spec ``(("data", "model"),)`` (a 2-D mesh) or
    ``("model",)``, gathered in each case by ``Plan.gather_to`` (``None``:
    the plan's choice of backwards) or by one gather an axis with the given
    backwards, then used as ``sum(w_full · xs[rank's data coordinate or
    rank])``: a case its gathered values and the gradient of this rank's
    block."""
    plan = _plan(shape, rows=len(xs) if len(shape) == 2 else None)
    spec = sharding.P(tuple(AXES[-len(shape):]))
    who = plan.coords["data"] if len(shape) == 2 else rank
    out = []
    for kinds in cases:
        block = sharding.shard(torch.as_tensor(w), spec, plan.mesh).requires_grad_(True)
        if kinds is None:
            full = plan.gather_to(block, spec, sharding.P(None))
        else:
            full = block
            for axis, kind in zip(reversed(AXES[-len(shape):]), kinds, strict=True):
                (full,) = sharding._Gather.apply(axis, (0,), kind, plan, full)
        (g,) = torch.autograd.grad((full * torch.as_tensor(xs[who])).sum(), (block,))
        out.append((full.detach(), g))
    return out


def vocab_loss_rank(rank, shape, logits, labels, mask):
    """``losses.lm_loss`` on this rank's vocab block of ``logits`` (and its
    rows, on a 2-D mesh), with ``mask`` and the default z-loss: the
    metrics and the gradient of the loss for the block."""
    plan = _plan(shape, rows=logits.shape[0])
    v = plan.cfg.vocab_size // plan.tp
    rows = _rows(plan, logits)
    block = rows[..., plan.tp_rank * v:(plan.tp_rank + 1) * v].clone().requires_grad_(True)
    loss, metrics = losses.lm_loss(plan.cfg, block, _rows(plan, labels),
                                   mask=_rows(plan, mask), plan=plan)
    (g,) = torch.autograd.grad(loss, (block,))
    return {k: float(t) for k, t in metrics.items()}, g
