"""Coupled-mode-theory (CMT) microring cavity model — port of
``repro/devices/cmt.py`` (see its docstring for the physics).

:class:`MRCavityCMT` integrates the intracavity energy E, with the
free-carrier density N and the mode temperature T closed adiabatically at
tick start from the carried E, over ``n_substeps`` exact-exponential
substeps inside each virtual-node tick of length θ.  Per substep of length
dt = θ/n_substeps:

    δ_eff = δ − fcd·N + th_shift·T
    L(δ)  = 1 / (1 + δ_eff²)
    r     = r_lin·[discharging] + tpa·pw·E + fca·N
    E    ←  E·e^{−r·dt} + κ·L(δ)·P·dt·φ1(r·dt)
    N    ←  N + (1 − e^{−dt/τ_fc})·(fc_gain·(pw·E)² − N)
    T    ←  T + (1 − e^{−dt/τ_th})·(th_gain·pw·E − T)

with P = max(u + γ·s(t−τ), 0).  The carry stays one f32 per node, so every
state path (``ref``, ``fast``, the CUDA scan kernel, streaming) takes the
model unchanged.

Rounding follows the reference op by op: each Python-float constant meets
an f32 operand as a weak type, so it rounds to f32 at its use; ``g_fc`` and
``g_th`` are computed in float64 and rounded once; ``lin`` is
f32(loss_scale)·f32(1/τ_L) in f32; ``(pw·E)²`` is one f32 product.

``CMTSweepParams`` is the swept operating point: leaves are floats or [B]
tensors (one grid point per batch lane), taken by the ``*_p`` methods.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.nonlinear import KERNEL_MR_CAVITY_CMT, _f32


class CMTSweepParams(NamedTuple):
    """Swept operating-point parameters: scalars or per-lane [B] tensors."""

    detune: object = 0.0       # normalised detuning δ = 2(ω_p − ω_0)/Δω_FWHM
    loss_scale: object = 1.0   # linear loss multiplier on 1/τ_L
    power: object = 0.0        # input power scale (mW) — drives all NL terms


def _bparam(x, like: torch.Tensor) -> torch.Tensor:
    """A sweep-parameter leaf as ``like``'s dtype and device: a scalar
    stays 0-dim; a [B] leaf gains trailing singleton dims to ride the
    leading batch axis of ``like``."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if x.ndim == 0 or x.ndim >= like.ndim:
        return x
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _phi1(x: torch.Tensor) -> torch.Tensor:
    """φ1(x) = (1 − e^{−x})/x, the exponential-integrator pump weight, with
    the reference's guard: 1 − x/2 at x ≤ 1e-6."""
    small = x <= 1e-6
    safe = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - 0.5 * x, -torch.expm1(-safe) / safe)


class _Point(NamedTuple):
    """An operating point's per-lane tensors, broadcast once for a period."""

    det: torch.Tensor
    lin: torch.Tensor
    pw: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MRCavityCMT:
    """CMT microring cavity neuron (fields and defaults as the reference's).

    ``kappa_charge``/``kappa_discharge`` default to the auto-calibration that
    makes the zero-power tick map SiliconMR's θ-corrected Eq. (6-7):
    κ_d = loss_scale·(1 + δ²)/τ_L, κ_c = α·(1 + δ²)/θ with
    α = 1 − exp(−θ·loss_scale/τ_L).
    """

    theta_ps: float = 50.0
    tau_l_ps: float = 50.0
    gamma: float = 0.9
    detune: float = 0.0
    loss_scale: float = 1.0
    power_mw: float = 1.0
    n_substeps: int = 4
    kappa_charge: float | None = None
    kappa_discharge: float | None = None
    tpa: float = 0.01
    fca: float = 0.05
    fcd: float = 4.0
    th_shift: float = 0.4
    fc_gain: float = 0.2
    th_gain: float = 0.5
    tau_fc_ps: float = 1000.0
    tau_th_ps: float = 10000.0

    name: str = dataclasses.field(default="MR cavity (CMT)", repr=False)

    def __post_init__(self):
        if self.n_substeps < 1:
            raise ValueError(f"n_substeps must be >= 1, got {self.n_substeps}")
        for f in ("theta_ps", "tau_l_ps", "tau_fc_ps", "tau_th_ps"):
            if getattr(self, f) <= 0.0:
                raise ValueError(f"{f} must be positive, got {getattr(self, f)}")
        if self.loss_scale < 0.0 or self.power_mw < 0.0:
            raise ValueError("loss_scale and power_mw must be non-negative")

    @property
    def alpha(self) -> float:
        """Zero-power per-tick linear response 1 − exp(−θ·loss_scale/τ_L)."""
        return 1.0 - math.exp(-self.theta_ps * self.loss_scale / self.tau_l_ps)

    @property
    def kappa_d(self) -> float:
        if self.kappa_discharge is not None:
            return self.kappa_discharge
        return (1.0 + self.detune ** 2) * self.loss_scale / self.tau_l_ps

    @property
    def kappa_c(self) -> float:
        if self.kappa_charge is not None:
            return self.kappa_charge
        return self.alpha * (1.0 + self.detune ** 2) / self.theta_ps

    @property
    def _dt(self) -> float:
        return self.theta_ps / self.n_substeps

    @property
    def _relax(self) -> tuple[float, float]:
        """(g_fc, g_th) = 1 − e^{−dt/τ}: computed in float64, rounded once."""
        return (_f32(-math.expm1(-self._dt / self.tau_fc_ps)),
                _f32(-math.expm1(-self._dt / self.tau_th_ps)))

    def sweep_point(self) -> CMTSweepParams:
        """The dataclass operating point as a (float-leaf) sweep point."""
        return CMTSweepParams(detune=self.detune, loss_scale=self.loss_scale,
                              power=self.power_mw)

    def _point(self, p: CMTSweepParams, like: torch.Tensor) -> _Point:
        lin = _bparam(p.loss_scale, like) * _f32(1.0 / self.tau_l_ps)
        return _Point(_bparam(p.detune, like), lin, _bparam(p.power, like))

    def _drive(self, u, s_tau):
        return torch.clamp_min(u + _f32(self.gamma) * s_tau, 0.0)

    def _tick(self, pt: _Point, u, drive, s_pn):
        """One tick from the chain-free ``drive``: everything that needs
        s_pn, in the reference's op order.  The last substep's N and T
        updates (and its pw·E) feed nothing, so they are not computed."""
        dt = _f32(self._dt)
        charging = u > s_pn
        kap = torch.where(charging, _f32(self.kappa_c), _f32(self.kappa_d))
        # carrier-injection gain cancels the linear loss while charging
        lin_eff = torch.where(charging, 0.0, pt.lin)
        e = torch.clamp_min(s_pn, 0.0)
        # slow states closed adiabatically at tick start from the carried E₀
        pe = pt.pw * e
        n_fc = _f32(self.fc_gain) * (pe * pe)
        t_th = _f32(self.th_gain) * pe
        g_fc, g_th = self._relax
        for step in range(self.n_substeps):
            delta = pt.det - _f32(self.fcd) * n_fc + _f32(self.th_shift) * t_th
            lor = torch.reciprocal(1.0 + delta * delta)
            r = lin_eff + _f32(self.tpa) * pe + _f32(self.fca) * n_fc
            x = r * dt
            e = e * torch.exp(-x) + (kap * lor * drive) * (dt * _phi1(x))
            if step + 1 < self.n_substeps:
                pe = pt.pw * e
                n_fc = n_fc + g_fc * (_f32(self.fc_gain) * (pe * pe) - n_fc)
                t_th = t_th + g_th * (_f32(self.th_gain) * pe - t_th)
        return e

    # -- swept-parameter contract ---------------------------------------------
    def node_update_p(self, p: CMTSweepParams, u, s_tau, s_prev_node):
        """One virtual-node tick at operating point ``p`` (leaves broadcast
        against the leading batch axis)."""
        return self._tick(self._point(p, u), u, self._drive(u, s_tau), s_prev_node)

    def period_update_p(self, p: CMTSweepParams, u_k, s_prev, s_last):
        """A whole period at ``p``: sequential over nodes (the realised
        energy feeds the next node's branch).  The point's broadcasts and
        the drive of all N nodes are computed once, outside the node loop."""
        pt = self._point(p, u_k[..., 0])
        drive = self._drive(u_k, s_prev)
        s_pn, out = s_last, []
        for i in range(u_k.shape[-1]):
            s_pn = self._tick(pt, u_k[..., i], drive[..., i], s_pn)
            out.append(s_pn)
        return torch.stack(out, dim=-1)

    # -- the core/nonlinear.py model contract ---------------------------------
    def node_update(self, u, s_tau, s_prev_node):
        return self.node_update_p(self.sweep_point(), u, s_tau, s_prev_node)

    def period_update(self, u_k, s_prev, s_last):
        return self.period_update_p(self.sweep_point(), u_k, s_prev, s_last)

    def kernel_spec(self) -> tuple[int, tuple[float, ...]]:
        """The CUDA scan kernel's CMT form (``Form::CMT`` in dfr_scan.cu):
        16 f32 values at the dataclass operating point, in the order of its
        ``CmtParam`` enum, ``n_substeps`` last (exact as a float)."""
        return KERNEL_MR_CAVITY_CMT, (
            _f32(self.gamma), _f32(self.kappa_c), _f32(self.kappa_d), _f32(self.detune),
            float(np.float32(self.loss_scale) * np.float32(1.0 / self.tau_l_ps)),
            _f32(self.power_mw), _f32(self.fc_gain), _f32(self.th_gain), *self._relax,
            _f32(self.fcd), _f32(self.th_shift), _f32(self.tpa), _f32(self.fca),
            _f32(self._dt), float(self.n_substeps))
