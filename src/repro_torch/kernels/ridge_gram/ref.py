"""Plain PyTorch oracle for the Gram accumulation kernel.

X [T, F], Y [T, C] -> G = XᵀX [F, F], c = XᵀY [F, C], in f32 — the port of
``repro/kernels/ridge_gram/ref.py``.  ``gram_ref_batched`` is the
per-instance [B, ...] form.
"""

from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor, y: torch.Tensor):
    x32 = x.to(torch.float32)
    y32 = y.to(torch.float32)
    return x32.T @ x32, x32.T @ y32


def gram_ref_batched(x: torch.Tensor, y: torch.Tensor):
    x32 = x.to(torch.float32)
    y32 = y.to(torch.float32)
    return (torch.einsum("btf,btg->bfg", x32, x32),
            torch.einsum("btf,btc->bfc", x32, y32))
