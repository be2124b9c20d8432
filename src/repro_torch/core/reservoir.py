"""Delayed-feedback reservoir (DFR) state generation.

Port of ``repro/core/reservoir.py``.  Produces the N virtual-node states for
every input period (paper Fig. 2(b), Eq. (1-2)) along three interchangeable
paths:

* ``method="ref"``    — periods × nodes strictly sequentially
  (``node_update``): the oracle every other path is tested against;
* ``method="fast"``   — a loop over periods, each a whole-period
  ``period_update`` (the per-node drive for all N at once, then the node
  chain: log-depth for SiliconMRLiteral and MackeyGlass, sequential for
  SiliconMR and the CMT cavity);
* ``method="kernel"`` — the CUDA scan kernel (``kernels/dfr_scan``), which
  fuses masking and the recurrence; on CPU tensors its plain version.

All paths take the *unmasked* sample series ``j`` [..., K] plus the mask
[N] and return states [..., K, N].  ``generate_channel_states`` is the WDM
form: per-channel masks [R, N] over per-channel series [R, K], the channels
riding the batch axis (on the kernel path, the scan kernel's per-lane mask
mode: ONE launch for all R channels).  Both run on ``cuda`` unless the
caller passes ``device="cpu"``.

``dev_params`` sweeps a device's operating point over the batch lanes (a
``devices.cmt.CMTSweepParams``, leaves scalar or [B]) through the model's
``node_update_p``/``period_update_p``, on the ``ref`` and ``fast`` paths
only, as in the reference.
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve_device, resolve_dtype
from .masking import masked_input
from .nonlinear import NLModel


def init_state(model: NLModel, batch_shape: tuple[int, ...], n_nodes: int,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Zero initial reservoir state (dark waveguide / discharged node)."""
    del model
    return torch.zeros((*batch_shape, n_nodes), dtype=dtype, device=device)


def _states_ref(model: NLModel, u: torch.Tensor, s0: torch.Tensor, node=None) -> torch.Tensor:
    """u: [B, K, N], s0: [B, N] -> [B, K, N].  Sequential oracle over
    ``node`` (default ``model.node_update``)."""
    node = node or model.node_update
    b, k_periods, n_nodes = u.shape
    states = torch.empty((b, k_periods, n_nodes), dtype=u.dtype, device=u.device)
    s_prev, s_last = s0, s0[:, -1]
    for k in range(k_periods):
        for i in range(n_nodes):
            s_last = node(u[:, k, i], s_prev[:, i], s_last)
            states[:, k, i] = s_last
        s_prev = states[:, k]
    return states


def _states_fast(model: NLModel, u: torch.Tensor, s0: torch.Tensor, period=None) -> torch.Tensor:
    """u: [B, K, N], s0: [B, N] -> [B, K, N].  Whole-period updates with
    ``period`` (default ``model.period_update``)."""
    period = period or model.period_update
    out = []
    s_prev = s0
    for k in range(u.shape[1]):
        s_prev = period(u[:, k], s_prev, s_prev[:, -1])
        out.append(s_prev)
    return torch.stack(out, dim=1) if out else u.new_empty(u.shape)


def _states_ref_p(model, p, u: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Sequential oracle at per-lane device parameters ``p``."""
    return _states_ref(model, u, s0, functools.partial(model.node_update_p, p))


def _states_fast_p(model, p, u: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Whole-period path at per-lane device parameters ``p``."""
    return _states_fast(model, u, s0, functools.partial(model.period_update_p, p))


def _params_on(model, dev_params, dev: torch.device):
    """``dev_params`` with each leaf an f32 tensor on ``dev``; TypeError for
    a model without the swept-parameter contract."""
    if not hasattr(model, "period_update_p"):
        raise TypeError(f"{type(model).__name__} takes no swept device parameters "
                        "(dev_params needs node_update_p/period_update_p)")
    return type(dev_params)(*(torch.as_tensor(leaf, dtype=torch.float32, device=dev)
                              for leaf in dev_params))


def _canon(j: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Canonicalise j to [B, K]; report whether a batch dim was added."""
    if j.ndim == 1:
        return j[None, :], True
    if j.ndim == 2:
        return j, False
    raise ValueError(f"j must be [K] or [B, K], got shape {tuple(j.shape)}")


def _run_states(model: NLModel, j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor,
                method: str, block_s: int | None, state_dtype, dev_params=None):
    """(states [B, K, N], final state [B, N]) of ``j`` [B, K] under one
    mask [N] or per-lane masks [B, N], along ``method``."""
    if method == "kernel":
        from ..kernels.dfr_scan import ops as dfr_ops

        return dfr_ops.dfr_scan(model, j, mask, s0, block_s=block_s,
                                return_final=True, out_dtype=state_dtype)
    u = masked_input(j, mask) if mask.ndim == 1 else j[:, :, None] * mask[:, None, :]
    if method == "ref":
        states = (_states_ref(model, u, s0) if dev_params is None
                  else _states_ref_p(model, dev_params, u, s0))
    elif method == "fast":
        states = (_states_fast(model, u, s0) if dev_params is None
                  else _states_fast_p(model, dev_params, u, s0))
    else:
        raise ValueError(f"unknown method {method!r}")
    s_final = states[:, -1, :] if states.shape[1] else s0
    if state_dtype is not None:
        states = states.to(resolve_dtype(state_dtype))
    return states, s_final


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
    compute stay in the input dtype.  ``dev_params`` (leaves scalar or [B])
    sweeps the model's operating point over the lanes; the kernel path
    raises NotImplementedError for it.  Inputs are moved to ``device``
    (default ``cuda``).
    """
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

    if dev_params is not None:
        if method == "kernel":
            raise NotImplementedError(
                "dev_params (per-lane device parameters) are not supported on the "
                "kernel path; sweep with method='fast' or 'ref'")
        dev_params = _params_on(model, dev_params, dev)
    states, s_final = _run_states(model, jb, mask, s0b, method, block_s, state_dtype,
                                  dev_params)
    if squeeze:
        states, s_final = states[0], s_final[0]
    return (states, s_final) if return_final else states


def generate_channel_states(
    model: NLModel,
    j,
    masks,
    *,
    s0=None,
    method: str = "fast",
    block_s: int | None = None,
    return_final: bool = False,
    state_dtype=None,
    device=None,
):
    """WDM ensemble states: ``j`` [R, K] with per-channel ``masks`` [R, N]
    -> states [R, K, N] (R wavelength channels sharing one ring and delay
    loop, each with its own mask and input series).

    Same knobs as ``generate_states``: ``s0`` [R, N] resumes each channel,
    ``return_final=True`` adds the [R, N] f32 carry, ``state_dtype``
    narrows only the emitted states.  ``method="kernel"`` is ONE scan-kernel
    launch in its per-lane mask mode; ``ref``/``fast`` take the channel axis
    as their batch axis.
    """
    dev = resolve_device(device)
    j = torch.as_tensor(j, device=dev).to(torch.float32)
    masks = torch.as_tensor(masks, device=dev).to(torch.float32)
    if j.ndim != 2 or masks.ndim != 2 or j.shape[0] != masks.shape[0]:
        raise ValueError(f"channels mismatch: j {tuple(j.shape)} vs masks "
                         f"{tuple(masks.shape)}")
    s0 = (torch.zeros(masks.shape, dtype=torch.float32, device=dev) if s0 is None
          else torch.as_tensor(s0, device=dev).to(torch.float32))

    states, s_final = _run_states(model, j, masks, s0, method, block_s, state_dtype)
    return (states, s_final) if return_final else states
