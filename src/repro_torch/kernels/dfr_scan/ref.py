"""Plain PyTorch oracle for the DFR scan kernel.

Masks the sample series and chains ``model.node_update`` strictly
sequentially over (periods × nodes) — the physical device evolution, in the
op order of the reference oracle ``repro/kernels/dfr_scan/ref.py``.
Shapes: j [B, K], mask [N] or per-lane [B, N], s0 [B, N] -> states
[B, K, N] (and the final state [B, N] with ``return_final``), all f32.
"""

from __future__ import annotations

import torch

from ...core.reservoir import _states_ref


def dfr_scan_ref(model, j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor,
                 *, return_final: bool = False):
    j = j.to(torch.float32)
    mask = mask.to(device=j.device, dtype=torch.float32)
    s0 = s0.to(device=j.device, dtype=torch.float32)
    u = j[..., :, None] * (mask[:, None, :] if mask.ndim == 2 else mask)
    states = _states_ref(model, u, s0)
    if not return_final:
        return states
    return states, (states[:, -1] if states.shape[1] else s0).clone()
