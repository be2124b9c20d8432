"""ReservoirMixer: the paper's DFRC dynamics as an LM sequence mixer.

Port of ``repro/core/layer.py``.  The paper's accelerator processes a
scalar time series through one MR node + delay loop; the LM stack lifts it
into a sequence mixer:

  x [B, S, d]  --fixed random w_in-->  R scalar drive series  (R "wavelengths")
               --SiliconMR DFR-->      R×N virtual-node states per step
               --trained readout-->    y [B, S, d]

R parallel reservoirs model WDM multiplexing (R wavelength channels sharing
one MR + waveguide).  The reservoir is fixed: ``w_in`` is a non-trainable
random projection and only the readout is learned.  The mixer is causal and
O(S·N·R).

The period recurrence runs on the scan kernel K1 (``kernels.dfr_scan``),
which computes exactly the reference's ``lax.scan`` of
``SiliconMR.period_update``: the B·R (batch, channel) pairs are K1's lanes,
the S tokens its periods, one shared mask.  One call a layer, for a
forward, a prefill or a decode step alike; K1 emits the states in the
model's dtype.  On CPU tensors the wrapper runs its plain version.

Training differentiates the mixer as the reference's ``jax.grad`` does its
``lax.scan``: ``w_in`` is detached (its gradient is None, the reference's
exact zero), and the gradient to ``x`` flows back through the states.
When grad is enabled and the drive needs it, K1 runs inside ``_Scan``, a
``torch.autograd.Function``: K1 emits f32 states, which the Function saves
(with j, the mask and s0) and the mixer then casts to the model's dtype,
as the reference casts ``states.astype(dt)``.  Its backward is the adjoint
scan K1ᵀ (``kernels.dfr_scan.dfr_scan_grad``), which recomputes the branch
bits from those f32 states.  Without grad the serving path is as before.

Decode carries ``(s_prev [B,R,N], s_last [B,R])``, the reference's cache.
K1's carry is the last period's state row alone: node 0's neighbour is
``s_prev[..., -1]``.  The reference's ``s_last`` always equals
``s_prev[..., -1]`` (zeros at the start, the last node after each period),
so the port reads ``s_prev`` only and returns ``s_last`` as the new
state's last node; ``convert.lm_cache_from_reference`` refuses a cache
that breaks the identity.
"""

from __future__ import annotations

import functools
import math

import torch

from ..kernels.dfr_scan import dfr_scan, dfr_scan_grad
from .masking import make_mask
from .nonlinear import SiliconMR


def reservoir_defs(cfg) -> dict:
    d, n, r = cfg.d_model, cfg.reservoir_nodes, _n_channels(cfg)

    def w_in_init(generator, shape, lead, device):
        w = torch.randn((*lead, *shape), generator=generator, dtype=torch.float32, device=device)
        return w / math.sqrt(shape[0])

    return {
        "w_in": ((d, r), ("embed", None), w_in_init),         # fixed (not trained)
        "readout": ((r * n, d), (None, "embed"), "zeros"),    # the trained W_out
        "readout_bias": ((d,), ("embed",), "zeros"),
    }


def _n_channels(cfg) -> int:
    return max(1, cfg.d_model // cfg.reservoir_nodes)


def _model(cfg) -> SiliconMR:
    return SiliconMR(
        theta_ps=50.0,
        tau_ph_ps=50.0 / cfg.reservoir_alpha_ratio,
        gamma=cfg.reservoir_gamma,
    )


@functools.lru_cache(maxsize=16)
def _mask(n: int, device: torch.device) -> torch.Tensor:
    """The mixer's mask (MLS, seed 1) on ``device``, made once: a fresh
    host-to-device copy in every call would wait for the stream.  The one
    copy is non-blocking, so the first step that needs the mask (a train
    step, a prefill) does not wait for the device either."""
    return make_mask(n, seed=1).to(device, non_blocking=True)


class _Scan(torch.autograd.Function):
    """K1 with K1ᵀ as its backward: (j [B, K], s0 [B, N]) -> (f32 states
    [B, K, N], final state [B, N]).  The scan and its adjoint are looked
    up in this module when called, so a caller may route both through
    their plain versions."""

    @staticmethod
    def forward(ctx, j, s0, model, mask):
        states, fin = dfr_scan(model, j, mask, s0, return_final=True, out_dtype=torch.float32)
        ctx.model = model
        ctx.save_for_backward(j, mask, s0, states)
        return states, fin

    @staticmethod
    def backward(ctx, g_states, g_fin):
        j, mask, s0, states = ctx.saved_tensors
        dj, ds0 = dfr_scan_grad(ctx.model, j, mask, s0, states, g_states, g_fin)
        return dj, ds0, None, None


def apply_reservoir(cfg, p, x, *, cache=None):
    """x [B,S,d] -> (y [B,S,d], new_cache).  cache=(s_prev [B,R,N], s_last [B,R])."""
    dt = x.dtype
    n, r = cfg.reservoir_nodes, _n_channels(cfg)
    b, s, _ = x.shape

    # Fixed random drive; squash to the optical intensity range [0, 1].
    j = torch.sigmoid(x.to(torch.float32) @ p["w_in"].detach())   # [B,S,R]
    if cache is None:
        s_prev = torch.zeros((b, r, n), dtype=torch.float32, device=x.device)
    else:
        s_prev = cache[0]

    lanes = j.permute(0, 2, 1).reshape(b * r, s)                    # lane b·R + r
    s0 = s_prev.reshape(b * r, n)
    if torch.is_grad_enabled() and (lanes.requires_grad or s0.requires_grad):
        states, fin = _Scan.apply(lanes, s0, _model(cfg), _mask(n, x.device))
        states = states.to(dt)
    else:
        states, fin = dfr_scan(_model(cfg), lanes, _mask(n, x.device), s0,
                               return_final=True, out_dtype=dt)
    # [B·R, S, N] -> [B, S, R·N] in the reference's (r, n) feature order
    states = states.view(b, r, s, n).permute(0, 2, 1, 3).reshape(b, s, r * n)
    s_new = fin.view(b, r, n)

    y = (states @ p["readout"].to(dt)) + p["readout_bias"].to(dt)
    return y, (s_new, s_new[..., -1])
