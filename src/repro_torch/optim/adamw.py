"""AdamW with global-norm clipping and schedules: self-contained, f32
moments whatever the parameter dtype.

Port of ``repro/optim/adamw.py``.  Params, gradients and moments are the
LM's params trees (dicts and tuples of tensors; ``None`` holds no leaf),
walked in the reference's leaf order: dict keys sorted, tuples in order.

Everything stays on the device: the learning rate is computed from the
state's step tensor, and the clip scale ``min(1, clip / max(‖g‖, 1e-12))``
from the norm tensor, so a step reads nothing back to the host.

``apply_updates`` updates params and moments in place under
``torch.no_grad()`` (the reference's train step donates its state); call
it only once every gradient exists, so that a step that raises before it
leaves the state as it was.  A ``None`` gradient (a leaf the loss does not
reach, such as the reservoir's detached ``w_in``) is a zero gradient, as
the reference's ``stop_gradient`` gives: its moments stay zero, and weight
decay still moves the leaf.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # "cosine" | "constant"


def tree_leaves_with_path(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) of every leaf of a params tree in the reference's order,
    each path as ``jax.tree_util.keystr`` writes it (``['units'][0]['norm_mixer']``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += tree_leaves_with_path(item, f"{path}[{i}]")
        return out
    return [(path, tree)]


def tree_leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn, tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params) -> dict:
    """Zero f32 moments ``{"m", "v"}`` shaped as ``params``."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a device scalar tensor), an f32 tensor
    on its device."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``tree`` (``None`` leaves are zero)."""
    leaves = [leaf for leaf in tree_leaves(tree) if leaf is not None]
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _decay_mask(path: str) -> bool:
    """No weight decay on norms / biases / gates / 1-d params."""
    needle = path.lower()
    return not any(s in needle for s in ("norm", "bias", "gate", "scale", "a_log", "d_skip"))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, opt_state: dict, grads: list, step: torch.Tensor,
                  *, gnorm: torch.Tensor | None = None):
    """One AdamW step, in place: ``params`` and ``opt_state``'s moments are
    updated where they lie.  ``grads`` is a list in ``tree_leaves(params)``
    order (a ``None`` entry is a zero gradient).  ``gnorm`` is the global
    norm the clip takes (default: that of ``grads``; a sharded step passes
    the full gradient's, its ``params`` and ``grads`` being one rank's
    shards: the update is elementwise, so a shard's is the full update's
    block).  Returns the metrics ``{"grad_norm", "lr"}`` as device
    scalars."""
    named = tree_leaves_with_path(params)
    flat_m, flat_v = tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])
    if not len(named) == len(grads) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(named)} params, {len(grads)} gradients, {len(flat_m)} and "
                         f"{len(flat_v)} moments")
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) if g is None else g
             for (_, p), g in zip(named, grads)]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for (path, p), g, m, v in zip(named, grads, flat_m, flat_v):
        g32 = g.to(torch.float32) * scale
        m.copy_(b1 * m + (1.0 - b1) * g32)
        v.copy_(b2 * v + (1.0 - b2) * g32 * g32)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
