"""Nonlinear (NL) node models for delayed-feedback reservoirs.

Port of ``repro/core/nonlinear.py`` — see its docstring for the physics and
for the θ-corrected reading of paper Eq. (6-7).  The models keep the
reference's interface over virtual nodes:

``node_update(u, s_tau, s_prev_node)``
    One virtual node: ``u`` the masked input, ``s_tau`` the same node one τ
    earlier, ``s_prev_node`` the preceding node (θ earlier).  The sequential
    oracle.
``period_update(u_k, s_prev, s_last)``
    A whole period [..., N], equal to chaining ``node_update`` over the node
    axis.  As in the reference, SiliconMRLiteral and MackeyGlass run it in
    ⌈log₂ N⌉ steps: a Hillis–Steele doubling over the node axis of boolean
    transition functions (Literal; its states are selections of the same
    candidates, so bitwise the chain) and of affine maps (MackeyGlass; it
    rounds differently from the chain).  SiliconMR keeps a sequential node
    chain, as the reference's ``lax.scan`` does; MZISine has no chain.
``kernel_spec()``
    ``(model_id, params)`` for the CUDA scan kernel
    (``kernels/csrc/dfr_scan.cu``): float32 values, each rounded to f32 here
    exactly as the reference rounds its constants.

Rounding follows the reference op by op: device constants are rounded to
f32 once (``alpha``, ``decay``), derived constants such as ``1 - alpha`` are
computed in f32 from the rounded value, and every product and sum is its
own f32 operation.  That keeps the port within f32 round-off of the JAX
oracle over K·N dependent steps.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

# Model ids of the CUDA scan kernel (``enum ModelId`` in dfr_scan.cu).
KERNEL_SILICON_MR = 0
KERNEL_SILICON_MR_LITERAL = 1
KERNEL_MACKEY_GLASS = 2
KERNEL_MZI_SINE = 3
KERNEL_MR_CAVITY_CMT = 4


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in f32)."""
    return float(np.float32(x))


def _one_minus_f32(x: float) -> float:
    """1 − f32(x), evaluated in f32 (the reference's ``1.0 - a``)."""
    return float(np.float32(1.0) - np.float32(x))


def _doubling_strides(n: int) -> list[int]:
    """1, 2, 4, … below ``n``: the ⌈log₂ n⌉ steps of a Hillis–Steele scan."""
    return [1 << k for k in range(max(n - 1, 0).bit_length())]


@functools.lru_cache(maxsize=16)
def _affine_scan_factors(c: float, n: int, dtype: torch.dtype,
                         device: torch.device) -> tuple[torch.Tensor, ...]:
    """The multipliers of a doubling scan of x_i = a_i + c·x_{i-1} over n
    nodes: for each step of stride d, the [n] factor it applies (the prefix
    products m before it, zero below d) and, last, the prefix products
    m_i ≈ c^(i+1).  They depend on c and n alone, so one evaluation serves
    every period; callers only read them."""
    m = torch.full((n,), c, dtype=dtype, device=device)
    out = []
    for d in _doubling_strides(n):
        out.append(torch.cat([torch.zeros(d, dtype=dtype, device=device), m[d:]]))
        m = torch.cat([m[:d], m[:-d] * m[d:]])
    return (*out, m)


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
        # Node i's branch bit as a function of node i-1's: (bit if it
        # discharged, bit if it charged).  Node 0 sees s_last in both slots, a
        # constant function, so every prefix composition is one too.
        head = s_last[..., None]
        bit_if_0 = u_k > torch.cat([head, discharge[..., :-1]], dim=-1)
        bit_if_1 = u_k > torch.cat([head, charge[..., :-1]], dim=-1)
        for d in _doubling_strides(u_k.shape[-1]):
            # compose node i's function after the prefix ending at node i-d
            bit_if_0, bit_if_1 = (
                torch.cat([bit_if_0[..., :d], torch.where(bit_if_0[..., :-d], bit_if_1[..., d:],
                                                          bit_if_0[..., d:])], dim=-1),
                torch.cat([bit_if_1[..., :d], torch.where(bit_if_1[..., :-d], bit_if_1[..., d:],
                                                          bit_if_0[..., d:])], dim=-1))
        return torch.where(bit_if_0, charge, discharge)

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
        # x_i = a_i + c·x_{i-1}: prefix compositions of the affine maps
        # (c, a_i), the later map after the earlier, (m₁·m₂, a₂ + m₂·a₁).
        a = _one_minus_f32(self.decay) * self._drive(u_k, s_prev)
        n = u_k.shape[-1]
        *steps, m = _affine_scan_factors(_f32(self.decay), n, a.dtype, a.device)
        for d, m_d in zip(_doubling_strides(n), steps):
            # a_i += m_i·a_{i-d} for i ≥ d; m_d is 0 below d, where a_{i-d} is a pad
            a = a + m_d * torch.nn.functional.pad(a[..., :-d], (d, 0))
        return a + m * s_last[..., None]

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


# Every reservoir device model, by stable string id.  ``repro_torch.devices``
# registers its CMT cavity here under "mr_cavity_cmt" on import, as the
# reference's devices subsystem does.
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
