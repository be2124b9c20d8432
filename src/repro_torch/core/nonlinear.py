"""Nonlinear (NL) node models for delayed-feedback reservoirs.

Port of ``repro/core/nonlinear.py`` — see its docstring for the physics and
for the θ-corrected reading of paper Eq. (6-7).  The models keep the
reference's interface over virtual nodes:

``node_update(u, s_tau, s_prev_node)``
    One virtual node: ``u`` the masked input, ``s_tau`` the same node one τ
    earlier, ``s_prev_node`` the preceding node (θ earlier).  The sequential
    oracle.
``period_update(u_k, s_prev, s_last)``
    A whole period [..., N], exactly equal to chaining ``node_update`` over
    the node axis.  The reference evaluates MackeyGlass and SiliconMRLiteral
    with ``lax.associative_scan``; here the node chain is a plain sequential
    loop (the per-node drive is still computed for the whole period at once).
``kernel_spec()``
    ``(model_id, params)`` for the CUDA scan kernel
    (``kernels/csrc/dfr_scan.cu``): four float32 values, each rounded to f32
    here exactly as the reference rounds its constants.

Rounding follows the reference op by op: device constants are rounded to
f32 once (``alpha``, ``decay``), derived constants such as ``1 - alpha`` are
computed in f32 from the rounded value, and every product and sum is its
own f32 operation.  That keeps the port within f32 round-off of the JAX
oracle over K·N dependent steps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Model ids of the CUDA scan kernel (``enum ModelId`` in dfr_scan.cu).
KERNEL_SILICON_MR = 0
KERNEL_SILICON_MR_LITERAL = 1
KERNEL_MACKEY_GLASS = 2
KERNEL_MZI_SINE = 3


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in f32)."""
    return float(np.float32(x))


def _one_minus_f32(x: float) -> float:
    """1 − f32(x), evaluated in f32 (the reference's ``1.0 - a``)."""
    return float(np.float32(1.0) - np.float32(x))


@dataclasses.dataclass(frozen=True)
class SiliconMR:
    """Active microring TPA charging/discharging map — paper Eq. (6-7),
    θ-corrected reading.  Defaults are the paper's operating point
    (τ_ph = θ = 50 ps); β_tpa ≥ 0 adds TPA saturation of the drive."""

    theta_ps: float = 50.0
    tau_ph_ps: float = 50.0
    gamma: float = 0.9
    beta_tpa: float = 0.0

    name: str = dataclasses.field(default="Silicon MR", repr=False)

    @property
    def alpha(self) -> float:
        return 1.0 - math.exp(-self.theta_ps / self.tau_ph_ps)

    def _drive(self, u, s_tau):
        p = u + self.gamma * s_tau
        if self.beta_tpa:
            p = p / (1.0 + self.beta_tpa * p)
        return _f32(self.alpha) * p

    def node_update(self, u, s_tau, s_prev_node):
        pre = self._drive(u, s_tau)
        charge = pre + s_prev_node                                  # Eq. (6)
        discharge = pre + s_prev_node * _one_minus_f32(self.alpha)  # Eq. (7)
        return torch.where(u > s_prev_node, charge, discharge)

    def period_update(self, u_k, s_prev, s_last):
        pre = self._drive(u_k, s_prev)          # [..., N], parallel over nodes
        keep = _one_minus_f32(self.alpha)
        s_pn = s_last
        out = []
        for i in range(u_k.shape[-1]):
            u_i, pre_i = u_k[..., i], pre[..., i]
            s_pn = torch.where(u_i > s_pn, pre_i + s_pn, pre_i + s_pn * keep)
            out.append(s_pn)
        return torch.stack(out, dim=-1)

    def kernel_spec(self) -> tuple[int, tuple[float, float, float, float]]:
        return KERNEL_SILICON_MR, (_f32(self.alpha), _f32(self.gamma),
                                   _f32(self.beta_tpa), 0.0)


@dataclasses.dataclass(frozen=True)
class SiliconMRLiteral:
    """Paper Eq. (6-7) exactly as printed (relaxation from s(t−τ)).

    Unstable for every useful γ; kept for the faithfulness ablation.
    """

    theta_ps: float = 50.0
    tau_ph_ps: float = 50.0
    gamma: float = 0.9

    name: str = dataclasses.field(default="Silicon MR (literal)", repr=False)

    @property
    def alpha(self) -> float:
        return 1.0 - math.exp(-self.theta_ps / self.tau_ph_ps)

    def _candidates(self, u, s_tau):
        pre = (u + self.gamma * s_tau) * _f32(self.alpha)
        charge = pre + s_tau                                   # Eq. (6) as printed
        discharge = pre + s_tau * _one_minus_f32(self.alpha)   # Eq. (7) as printed
        return charge, discharge

    def node_update(self, u, s_tau, s_prev_node):
        charge, discharge = self._candidates(u, s_tau)
        return torch.where(u > s_prev_node, charge, discharge)

    def period_update(self, u_k, s_prev, s_last):
        charge, discharge = self._candidates(u_k, s_prev)
        s_pn = s_last
        out = []
        for i in range(u_k.shape[-1]):
            s_pn = torch.where(u_k[..., i] > s_pn, charge[..., i], discharge[..., i])
            out.append(s_pn)
        return torch.stack(out, dim=-1)

    def kernel_spec(self) -> tuple[int, tuple[float, float, float, float]]:
        return KERNEL_SILICON_MR_LITERAL, (_f32(self.alpha), _f32(self.gamma),
                                           0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class MackeyGlass:
    """Appeltant et al. (2011) single-node electronic DFR ('Electronic (MG)'):
    x_i(k) = e^{-θ/T}·x_{i-1}(k) + (1 − e^{-θ/T})·η·X/(1 + |X|^p),
    X = x_i(k−1) + γ·J."""

    eta: float = 0.75
    gamma_in: float = 0.15
    p: float = 7.0
    theta_over_T: float = 0.2

    name: str = dataclasses.field(default="Electronic (MG)", repr=False)

    @property
    def decay(self) -> float:
        return math.exp(-self.theta_over_T)

    def _drive(self, u, s_tau):
        x = s_tau + self.gamma_in * u
        return self.eta * x / (1.0 + torch.abs(x) ** self.p)

    def node_update(self, u, s_tau, s_prev_node):
        c = _f32(self.decay)
        return c * s_prev_node + _one_minus_f32(self.decay) * self._drive(u, s_tau)

    def period_update(self, u_k, s_prev, s_last):
        c = _f32(self.decay)
        a = _one_minus_f32(self.decay) * self._drive(u_k, s_prev)
        x = s_last
        out = []
        for i in range(u_k.shape[-1]):
            x = c * x + a[..., i]
            out.append(x)
        return torch.stack(out, dim=-1)

    def kernel_spec(self) -> tuple[int, tuple[float, float, float, float]]:
        return KERNEL_MACKEY_GLASS, (_f32(self.decay), _f32(self.eta),
                                     _f32(self.gamma_in), _f32(self.p))


@dataclasses.dataclass(frozen=True)
class MZISine:
    """Duport et al. (2016) analogue photonic DFR ('All Optical (MZI)'):
    x_i(k) = sin²(φ + β·u_i(k) + α·x_i(k−1)); no θ coupling."""

    alpha_fb: float = 0.8
    beta_in: float = 0.1
    phi: float = 0.1 * math.pi

    name: str = dataclasses.field(default="All Optical (MZI)", repr=False)

    def node_update(self, u, s_tau, s_prev_node):
        del s_prev_node
        return torch.sin(self.phi + self.beta_in * u + self.alpha_fb * s_tau) ** 2

    def period_update(self, u_k, s_prev, s_last):
        del s_last
        return self.node_update(u_k, s_prev, None)

    def kernel_spec(self) -> tuple[int, tuple[float, float, float, float]]:
        return KERNEL_MZI_SINE, (_f32(self.phi), _f32(self.beta_in),
                                 _f32(self.alpha_fb), 0.0)


NLModel = SiliconMR | SiliconMRLiteral | MackeyGlass | MZISine


# Every reservoir device model, by stable string id.  The reference's
# devices subsystem registers "mr_cavity_cmt" here; its port is ROADMAP
# Queue 1 item 11.
MODEL_REGISTRY: dict[str, type] = {
    "silicon_mr": SiliconMR,
    "silicon_mr_literal": SiliconMRLiteral,
    "mackey_glass": MackeyGlass,
    "mzi_sine": MZISine,
}


def register_model(model_id: str, cls: type) -> type:
    """Register a model class under a stable id; idempotent for the same
    class, raises for a different class under an existing id."""
    prev = MODEL_REGISTRY.get(model_id)
    if prev is not None and prev is not cls:
        raise ValueError(
            f"model id {model_id!r} already registered to {prev.__name__}")
    MODEL_REGISTRY[model_id] = cls
    return cls


# Inter-stage link nonlinearities of composed reservoir graphs (reference
# DESIGN.md §13), referenced by name.


def link_identity(p: torch.Tensor) -> torch.Tensor:
    """Transparent link."""
    return p


def link_saturable(p: torch.Tensor) -> torch.Tensor:
    """TPA-style saturable absorber, p / (1 + |p|)."""
    return p / (1.0 + torch.abs(p))


def link_sin2(p: torch.Tensor) -> torch.Tensor:
    """MZI intensity response, sin²(p)."""
    return torch.sin(p) ** 2


LINK_NONLINEARITIES = {
    "identity": link_identity,
    "sat": link_saturable,
    "sin2": link_sin2,
}
