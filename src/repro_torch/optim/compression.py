"""Error-feedback int8 gradient compression for cross-pod reduction.

Port of ``repro/optim/compression.py``: blocked int8 quantisation (a
per-block absmax scale, blocks of 256) whose residual is fed back into the
next step's gradient.  ``compressed_psum`` and ``tree_compressed_psum``
reduce over a mesh axis and wait for the port of ``parallel/`` (ROADMAP.md
Queue 1, item 13d): they raise NotImplementedError.
"""

from __future__ import annotations

import torch

from .adamw import tree_map

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = -flat.shape[0] % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), pad


def quantize(g: torch.Tensor):
    """g (any shape, f32) -> (int8 codes [blocks, 256], per-block scales
    [blocks, 1] f32, residual g - dequantised, shaped as g)."""
    g32 = g.to(torch.float32)
    flat, _pad = _pad_to_block(g32)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.to(torch.float32) * scale).reshape(-1)[: g.numel()].reshape(g.shape)
    residual = g32 - deq
    return q, scale, residual


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def dequantize_from_grid(grid: torch.Tensor, shape) -> torch.Tensor:
    flat = grid.reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_psum(g, err, axis_name: str):
    """Error-feedback int8 reduction over a mesh axis: waits for
    ``parallel/`` (ROADMAP.md Queue 1, item 13d)."""
    raise NotImplementedError("compressed_psum reduces over a mesh axis: it waits for the "
                              "port of parallel/ (ROADMAP.md Queue 1, item 13d)")


def tree_compressed_psum(grads, err_state, axis_name: str):
    """``compressed_psum`` over a gradient tree: waits for ``parallel/``
    (ROADMAP.md Queue 1, item 13d)."""
    raise NotImplementedError("tree_compressed_psum reduces over a mesh axis: it waits for "
                              "the port of parallel/ (ROADMAP.md Queue 1, item 13d)")


def init_error_state(params):
    """Zero f32 error-feedback state shaped as ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
