"""Seedable fault injection for DFR serving (DESIGN.md §12).

Port of ``repro/robustness/faults.py``.  The fault models are pure
transforms of the step's inputs and carry: nothing inside
``pipeline/session`` or the kernels changes.  A :class:`FaultSpec` holds
one value a slot ([B] tensors), so faults target single sessions of the
continuously batched slab, and clean and faulted runs share one code path:
the neutral spec is a bitwise identity.

===================  =====================================================
``nan_prob``         per-period probability a drive sample becomes NaN
                     (ADC glitch / dropped host tick)
``inf_prob``         per-period probability a drive sample becomes +Inf
                     (TIA rail / overflow)
``corrupt_prob``     per-tick probability the reservoir carry row is
                     poisoned with NaN (SEU in the state memory)
``stuck_node``       virtual-node index held at ``stuck_value`` at every
                     tick boundary (-1 = none) — a dead MR tap
``detune_amp/period``MR thermal-detuning drift: slow sinusoidal
                     multiplicative gain on the drive (period in reservoir
                     periods)
``droop_rate``       laser power droop: ``exp(-rate · t)`` gain decay over
                     absolute periods
``sat_level``        digitizer saturation: drive clipped to ±``sat_level``
===================  =====================================================

**Replayable draws.**  The stochastic faults draw their uniforms from a
counter-based integer hash of (seed, fault tag, tick, element index),
computed on the device in 64-bit integers that never overflow.  The same
(seed, tag, tick) give the same bits on every device and in every run, so
a restored server re-injects exactly the faults of the run it resumes.
The reference draws from ``jax.random.fold_in`` keys, whose bits the port
does not reproduce: stochastic faults agree with it in distribution.

**Neutral-spec bitwise identity.**  :func:`no_faults` sets the
probabilities to 0 (``u < 0`` never fires), ``stuck_node`` to -1 (never a
node index), ``detune_amp`` and ``droop_rate`` to 0 (the gain is exactly
1.0, and ``x * 1.0`` is exact) and ``sat_level`` to +Inf (``clamp`` at
±inf returns x): under it :func:`faulty_session_step` is bitwise the
guarded ``session_step``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..pipeline.session import (SessionConfig, SessionState, _as_rows, _copy,
                                _session_step, _zero_rows_)

__all__ = ["FaultSpec", "no_faults", "on_rows", "faulted_rows",
           "inject_inputs", "inject_carry", "faulty_session_step",
           "faulty_step"]

_INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF


class FaultSpec(NamedTuple):
    """Per-slot fault intensities: [B] tensors on the slab's device."""

    nan_prob: torch.Tensor       # [B] f32 — P(drive sample -> NaN) per period
    inf_prob: torch.Tensor       # [B] f32 — P(drive sample -> +Inf) per period
    corrupt_prob: torch.Tensor   # [B] f32 — P(carry row -> NaN) per tick
    stuck_node: torch.Tensor     # [B] i32 — node held at stuck_value (-1 = none)
    stuck_value: torch.Tensor    # [B] f32 — the stuck-at level
    detune_amp: torch.Tensor     # [B] f32 — thermal-drift gain amplitude
    detune_period: torch.Tensor  # [B] f32 — drift period in periods (> 0)
    droop_rate: torch.Tensor     # [B] f32 — laser droop rate per period
    sat_level: torch.Tensor      # [B] f32 — digitizer full-scale (clip ±sat)
    from_tick: torch.Tensor      # [B] i32 — faults active from this tick …
    until_tick: torch.Tensor     # [B] i32 — … up to (excluding) this tick

    @property
    def batch(self) -> int:
        return self.nan_prob.shape[0]

    def active(self, tick: int) -> torch.Tensor:
        """[B] bool — slots whose fault window covers ``tick``.  Outside the
        window every transform leaves its input untouched."""
        return (self.from_tick <= tick) & (self.until_tick > tick)


def no_faults(batch: int, *, device=None) -> FaultSpec:
    """The neutral spec on ``device`` (default ``cuda``): a bitwise identity
    on every transform."""
    dev = resolve_device(device)

    def full(value, dtype=torch.float32):
        return torch.full((batch,), value, dtype=dtype, device=dev)

    return FaultSpec(
        nan_prob=full(0.0), inf_prob=full(0.0), corrupt_prob=full(0.0),
        stuck_node=full(-1, torch.int32), stuck_value=full(0.0),
        detune_amp=full(0.0), detune_period=full(1.0), droop_rate=full(0.0),
        sat_level=full(math.inf), from_tick=full(0, torch.int32),
        until_tick=full(_INT32_MAX, torch.int32))


def on_rows(spec: FaultSpec, rows, **fields) -> FaultSpec:
    """``spec`` with ``fields`` set on the given slot indices.

    ``on_rows(no_faults(8), [2, 5], nan_prob=0.2)`` arms a NaN-tick fault
    on slots 2 and 5 and leaves every other slot neutral.
    """
    idx = torch.as_tensor(rows, dtype=torch.long, device=spec.nan_prob.device)
    upd = {}
    for name, value in fields.items():
        leaf = getattr(spec, name).clone()
        leaf[idx] = torch.as_tensor(value, dtype=leaf.dtype, device=leaf.device)
        upd[name] = leaf
    return spec._replace(**upd)


def faulted_rows(spec: FaultSpec) -> torch.Tensor:
    """[B] bool — True where the slot's spec deviates from neutral."""
    return ((spec.nan_prob > 0) | (spec.inf_prob > 0)
            | (spec.corrupt_prob > 0) | (spec.stuck_node >= 0)
            | (spec.detune_amp != 0) | (spec.droop_rate != 0)
            | torch.isfinite(spec.sat_level))


def _mul32(x, c: int):
    """(x · c) mod 2³² for int64 tensors x in [0, 2³²), exactly: c is split
    into 16-bit halves so that no product leaves 48 bits."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """A 32-bit integer hash (a bijection of [0, 2³²)) of Python ints or
    int64 tensors in that range."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(seed: int, tag: int, tick: int, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1) (f32, 24-bit grid) for every element of ``shape``,
    a pure function of (seed, tag, tick, element index)."""
    key = _mix32(_mix32(_mix32(seed & _M32) ^ tag) ^ (tick & _M32))
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    h = _mix32(_mix32(idx) ^ key)
    return ((h >> 8).to(torch.float32) * 2.0 ** -24).reshape(shape)


def inject_inputs(spec: FaultSpec, j_chunk: torch.Tensor, tick: int, *,
                  seed: int = 0) -> torch.Tensor:
    """Apply the drive-side fault models to one [B, K] input chunk.

    Order follows the signal path: thermal detuning and laser droop scale
    the optical drive (gains over the absolute period ``tick·K + k``), the
    digital link then drops or overflows samples (NaN/Inf), and the
    digitizer clips last.  Slots outside their fault window pass through
    bitwise untouched.
    """
    j0 = torch.as_tensor(j_chunk, device=spec.nan_prob.device).to(torch.float32)
    b, k = j0.shape
    t_abs = (tick * k + torch.arange(k, dtype=torch.int32, device=j0.device))[None, :].to(
        torch.float32)
    gain = 1.0 + spec.detune_amp[:, None] * torch.sin(
        (2.0 * math.pi) * t_abs / spec.detune_period[:, None])
    gain = gain * torch.exp(-spec.droop_rate[:, None] * t_abs)
    j = j0 * gain
    u = _uniform(seed, 0, tick, (b, k), j0.device)
    nanp = spec.nan_prob[:, None]
    j = torch.where(u < nanp, math.nan, j)
    j = torch.where((u >= nanp) & (u < nanp + spec.inf_prob[:, None]), math.inf, j)
    j = torch.clamp(j, -spec.sat_level[:, None], spec.sat_level[:, None])
    return torch.where(spec.active(tick)[:, None], j, j0)


def inject_carry(spec: FaultSpec, s: torch.Tensor, tick: int, *,
                 seed: int = 0) -> torch.Tensor:
    """Apply the state-side fault models to one [B, N] reservoir carry.

    The stuck-at node is pinned at every tick boundary; carry corruption
    poisons the whole row with NaN with per-tick probability
    ``corrupt_prob``.  Slots outside their fault window pass through
    bitwise untouched.
    """
    b, n = s.shape
    node = torch.arange(n, dtype=torch.int32, device=s.device)[None, :]
    out = torch.where(node == spec.stuck_node[:, None],
                      spec.stuck_value[:, None].to(s.dtype), s)
    u = _uniform(seed, 1, tick, (b,), s.device)
    out = torch.where((u < spec.corrupt_prob)[:, None], math.nan, out)
    return torch.where(spec.active(tick)[:, None], out, s)


def faulty_session_step(cfg: SessionConfig, mask, spec: FaultSpec, state: SessionState,
                        j_chunk, y_chunk, tick: int, *, seed: int = 0,
                        refresh: bool = False, n_valid=None, reset=None):
    """``_session_step`` with the fault models wrapped around its inputs.

    Slot resets land first (where the clean step applies them), then the
    carry- and drive-side injections, then the unmodified serving tick,
    whose health guard the faults exercise.  ``tick`` is the host's tick
    count.  Like ``_session_step`` it updates the slab it is handed in
    place; ``faulty_step`` keeps its input.  Under the neutral spec it is
    bitwise invisible.
    """
    if reset is not None:
        state = _zero_rows_(state, _as_rows(state, reset))
    tick = int(tick)
    state = state._replace(s=inject_carry(spec, state.s, tick, seed=seed))
    j = inject_inputs(spec, j_chunk, tick, seed=seed)
    return _session_step(cfg, mask, state, j, y_chunk, refresh=refresh, n_valid=n_valid)


def faulty_step(cfg: SessionConfig, mask, spec: FaultSpec, state: SessionState,
                j_chunk, y_chunk, tick: int, *, seed: int = 0, refresh: bool = False,
                n_valid=None, reset=None):
    """``faulty_session_step`` on a copy of ``state``: ``state`` is left
    unchanged."""
    return faulty_session_step(cfg, mask, spec, _copy(state), j_chunk, y_chunk, tick,
                               seed=seed, refresh=refresh, n_valid=n_valid, reset=reset)
