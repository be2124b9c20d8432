"""Small-signal calibration: recover ``SiliconMR`` from the CMT cavity —
port of ``repro/devices/calibrate.py``.

At zero power one tick of either branch of the calibrated cavity is the
affine map of SiliconMR's θ-corrected Eq. (6-7), for any substep count.
:func:`calibrated_twin` builds that cavity, :func:`small_signal_gains`
measures a model's per-branch (∂s'/∂P, ∂s'/∂E₀) by exact finite
differences, and :func:`node_parity` bounds the per-tick deviation of two
models over the [0, 1]³ operating box.  Each evaluates on the device the
caller names (default ``cuda``).
"""

from __future__ import annotations

import torch

from ..core.nonlinear import SiliconMR
from ..device import resolve_device
from .cmt import MRCavityCMT


def calibrated_twin(mr: SiliconMR, *, n_substeps: int = 4, **overrides) -> MRCavityCMT:
    """The MRCavityCMT whose zero-power limit is ``mr``'s tick map: τ_ph →
    τ_L, θ and γ copied, on resonance at unit loss and zero power, κ
    auto-calibrated; ``overrides`` then move single fields (e.g.
    ``power_mw=1.0``).  Requires ``mr.beta_tpa == 0``."""
    if mr.beta_tpa:
        raise ValueError(
            f"calibrated_twin requires beta_tpa == 0 (the paper's headline "
            f"configs); got beta_tpa={mr.beta_tpa}")
    kw = dict(theta_ps=mr.theta_ps, tau_l_ps=mr.tau_ph_ps, gamma=mr.gamma,
              detune=0.0, loss_scale=1.0, power_mw=0.0, n_substeps=n_substeps)
    kw.update(overrides)
    return MRCavityCMT(**kw)


def small_signal_gains(model, *, charging: bool, h: float = 2 ** -12, device=None) -> dict:
    """``{"drive": ∂s'/∂P, "state": ∂s'/∂E₀}`` of one branch by finite
    differences at branch-safe probes (``s_tau = 0``, so the drive is u);
    ``h`` is a power of two, so the probe arithmetic is exact."""
    dev = resolve_device(device)
    u0, sp = (0.75, 0.125) if charging else (0.125, 0.75)

    def f(u, s_tau, s_prev):
        args = (torch.tensor(v, dtype=torch.float32, device=dev) for v in (u, s_tau, s_prev))
        return float(model.node_update(*args))

    g_drive = (f(u0 + h, 0.0, sp) - f(u0, 0.0, sp)) / h
    g_state = (f(u0, 0.0, sp + h) - f(u0, 0.0, sp)) / h
    return {"drive": g_drive, "state": g_state}


def calibration_report(mr: SiliconMR, cmt: MRCavityCMT, *, device=None) -> dict:
    """Per-branch gain deltas between ``mr`` and ``cmt`` (floats)."""
    out = {}
    for branch in ("charge", "discharge"):
        gm = small_signal_gains(mr, charging=branch == "charge", device=device)
        gc = small_signal_gains(cmt, charging=branch == "charge", device=device)
        out[branch] = {
            "mr_drive": gm["drive"], "cmt_drive": gc["drive"],
            "mr_state": gm["state"], "cmt_state": gc["state"],
            "max_abs_delta": max(abs(gm["drive"] - gc["drive"]),
                                 abs(gm["state"] - gc["state"])),
        }
    return out


def node_parity(a, b, *, n: int = 9, lo: float = 0.0, hi: float = 1.0, device=None) -> float:
    """Worst-case |a.node_update − b.node_update| over an n³ (u, s_τ, s_θ)
    grid of [lo, hi]³."""
    g = torch.linspace(lo, hi, n, dtype=torch.float32, device=resolve_device(device))
    u, st, sp = torch.meshgrid(g, g, g, indexing="ij")
    return float(torch.max(torch.abs(a.node_update(u, st, sp) - b.node_update(u, st, sp))))
