"""Delayed-feedback reservoir (DFR) state generation.

Port of ``repro/core/reservoir.py``.  Produces the N virtual-node states for
every input period (paper Fig. 2(b), Eq. (1-2)) along three interchangeable
paths:

* ``method="ref"``    — periods × nodes strictly sequentially
  (``node_update``): the oracle every other path is tested against;
* ``method="fast"``   — a loop over periods, each a whole-period
  ``period_update`` (the per-node drive for all N at once, then the node
  chain);
* ``method="kernel"`` — the CUDA scan kernel (``kernels/dfr_scan``), which
  fuses masking and the recurrence; on CPU tensors its plain version.

All paths take the *unmasked* sample series ``j`` [..., K] plus the mask
[N] and return states [..., K, N].  ``generate_states`` runs on ``cuda``
unless the caller passes ``device="cpu"``.

``generate_channel_states`` (WDM ensembles) is ROADMAP Queue 1 item 6, and
``dev_params`` (swept device parameters) is item 11.
"""

from __future__ import annotations

import torch

from ..device import resolve_device, resolve_dtype
from .masking import masked_input
from .nonlinear import NLModel


def init_state(model: NLModel, batch_shape: tuple[int, ...], n_nodes: int,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Zero initial reservoir state (dark waveguide / discharged node)."""
    del model
    return torch.zeros((*batch_shape, n_nodes), dtype=dtype, device=device)


def _states_ref(model: NLModel, u: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """u: [B, K, N], s0: [B, N] -> [B, K, N].  Sequential oracle."""
    b, k_periods, n_nodes = u.shape
    states = torch.empty((b, k_periods, n_nodes), dtype=u.dtype, device=u.device)
    s_prev, s_last = s0, s0[:, -1]
    for k in range(k_periods):
        for i in range(n_nodes):
            s_last = model.node_update(u[:, k, i], s_prev[:, i], s_last)
            states[:, k, i] = s_last
        s_prev = states[:, k]
    return states


def _states_fast(model: NLModel, u: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """u: [B, K, N], s0: [B, N] -> [B, K, N].  Whole-period updates."""
    out = []
    s_prev = s0
    for k in range(u.shape[1]):
        s_prev = model.period_update(u[:, k], s_prev, s_prev[:, -1])
        out.append(s_prev)
    return torch.stack(out, dim=1) if out else u.new_empty(u.shape)


def _canon(j: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Canonicalise j to [B, K]; report whether a batch dim was added."""
    if j.ndim == 1:
        return j[None, :], True
    if j.ndim == 2:
        return j, False
    raise ValueError(f"j must be [K] or [B, K], got shape {tuple(j.shape)}")


def generate_states(
    model: NLModel,
    j,
    mask,
    *,
    s0=None,
    method: str = "fast",
    block_s: int | None = None,
    return_final: bool = False,
    state_dtype=None,
    dev_params=None,
    device=None,
):
    """DFR states for sample series ``j`` [..., K] -> [..., K, N].

    ``method``: "fast" (default), "ref" (sequential oracle) or "kernel"
    (CUDA kernel; its plain version on the CPU).  ``block_s`` is the TPU
    kernel's sublane tile, validated and otherwise unused
    (kernels/dfr_scan/ops.py).  ``return_final=True`` also returns the
    final state [..., N]; feed it back as ``s0`` to resume.
    ``state_dtype`` narrows only the emitted states; the carry and all
    compute stay in the input dtype.  Inputs are moved to ``device``
    (default ``cuda``).
    """
    if dev_params is not None:
        raise NotImplementedError(
            "dev_params (swept per-lane device parameters) are ROADMAP "
            "Queue 1 item 11 (the device subsystem)")
    dev = resolve_device(device)
    jb, squeeze = _canon(torch.as_tensor(j, device=dev))
    if not jb.is_floating_point():
        jb = jb.to(torch.float32)
    mask = torch.as_tensor(mask, device=dev).to(jb.dtype)
    n_nodes = int(mask.shape[-1])
    if s0 is None:
        s0b = init_state(model, (jb.shape[0],), n_nodes, dtype=jb.dtype, device=dev)
    else:
        s0b = torch.as_tensor(s0, device=dev).to(jb.dtype)
        if s0b.ndim == 1:
            s0b = s0b[None].expand(jb.shape[0], n_nodes)

    if method == "kernel":
        from ..kernels.dfr_scan import ops as dfr_ops

        states, s_final = dfr_ops.dfr_scan(model, jb, mask, s0b, block_s=block_s,
                                           return_final=True, out_dtype=state_dtype)
    else:
        u = masked_input(jb, mask)
        if method == "ref":
            states = _states_ref(model, u, s0b)
        elif method == "fast":
            states = _states_fast(model, u, s0b)
        else:
            raise ValueError(f"unknown method {method!r}")
        s_final = states[:, -1, :] if states.shape[1] else s0b
        if state_dtype is not None:
            states = states.to(resolve_dtype(state_dtype))
    if squeeze:
        states, s_final = states[0], s_final[0]
    return (states, s_final) if return_final else states
