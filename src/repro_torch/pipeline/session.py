"""Online-learning DFR sessions: per-stream adaptive readouts (DESIGN.md §10).

Port of ``repro/pipeline/session.py``.  A ``SessionState`` holds everything
a batch of B live streams needs to resume mid-flight: the reservoir carry
``s``, the running (optionally λ-decayed) Gram statistics, the current
readout and the per-session period counter that tracks the washout.  Every
leaf has a leading batch axis, so one state IS a continuously batched slab.

* ``session_step`` is the serving tick: ONE reservoir pass per chunk (one
  scan-kernel launch with ``state_method="kernel"``) shared by the
  prediction, made with the readout solved from earlier chunks (one
  readout-apply launch with ``use_kernel=True``), and the fold of the
  chunk into the Gram statistics (one accumulate-into Gram launch with
  ``use_kernel=True``), optionally followed by a re-solve.
* **RLS forgetting** (``forgetting`` = λ < 1) scales the carried statistics
  by λ per chunk; at λ = 1.0 no scaling op runs, and a chunk-aligned
  session folds and solves bitwise as ``fit_ridge_streaming`` does.
* **Amortised solves**: ``refresh`` (a Python bool) selects the fold-only
  or the fold+solve path; a server re-solves every ``refresh_every`` ticks.
* **Health masking** (``guard``, DESIGN.md §12): the tick ends with a
  per-row finite check of everything a row carries forward; failing rows
  are reset in place, flagged in ``quarantined`` and counted in
  ``poison``.  For healthy rows every guard leaves the identical value.

The reference jits each step and donates the slab in its server.  Here
``_session_step`` updates the slab it is given in place (its Gram and
moment stacks fold in place, resets and quarantines zero rows in place):
the caller hands the slab over, as with donation.  The public functions
(``session_update``, ``session_step``, ...) copy the slab first and leave
their input unchanged, as the reference's pure functions do.  The tick
reads nothing back from the device: no ``.item()``, no copy to the host,
no synchronise (the refresh path's ``torch.linalg.eigh`` checks its own
errors on the host).

The carried Gram is [B, F, F]: the reference pads it to its TPU tile
([B, Fq, Fq]); the port's fold masks ragged edges itself.  ``block_s``,
``block_t`` and ``block_f`` stay fields, so a reference config converts
field by field (``repro_torch.convert.session_config_from_reference``);
``block_s`` and ``block_f`` are validated and unused on the card, and
``block_t`` is the fold tile of the Gram's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.nonlinear import NLModel, SiliconMR
from ..core.reservoir import generate_states
from ..device import resolve_device
from ..kernels.dfr_scan.ops import BLOCK_S_CHOICES
from ..kernels.readout_apply import readout_apply, readout_apply_plain
from .ridge import _fold_chunk, _FoldPlan, _plan_fold, guard_readout, solve_gcv, with_bias


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Static configuration of an online-learning session batch — every
    field of the reference's ``SessionConfig``.

    ``chunk_k`` is the periods-per-tick granularity, ``forgetting`` the
    RLS decay per chunk, ``refresh_every`` the re-solve cadence a server
    drives (the session functions take the decision as ``refresh``).
    """

    model: NLModel = dataclasses.field(default_factory=SiliconMR)
    n_nodes: int = 100
    n_channels: int = 1            # C output channels of the readout
    washout: int = 50
    ridge_l2: tuple[float, ...] = (1e-6,)
    chunk_k: int = 32
    forgetting: float = 1.0
    refresh_every: int = 1
    state_method: str = "fast"     # "fast" | "ref" | "kernel"
    use_kernel: bool = False       # Gram fold via the accumulate-into Gram op,
                                   # prediction via the readout-apply kernel
    block_s: int | None = None     # TPU sublane tile: validated, unused
    block_t: int = 512             # fold tile of the Gram's plain version
    block_f: int = 128             # TPU feature tile: validated, unused
    state_dtype: str | None = None  # sub-f32 emitted state chunks (DESIGN.md §9)
    guard: bool = True             # in-step health masking (DESIGN.md §12)

    def __post_init__(self):
        if not isinstance(self.ridge_l2, tuple):
            object.__setattr__(self, "ridge_l2",
                               tuple(float(v) for v in self.ridge_l2))
        if not 0.0 < self.forgetting <= 1.0:
            raise ValueError(f"forgetting must be in (0, 1], got {self.forgetting}")
        if self.chunk_k < 1:
            raise ValueError(f"chunk_k must be >= 1, got {self.chunk_k}")
        if self.refresh_every < 1:
            raise ValueError(
                f"refresh_every must be >= 1, got {self.refresh_every}")
        if self.block_s is not None and self.block_s not in BLOCK_S_CHOICES:
            raise ValueError(f"block_s must be one of {BLOCK_S_CHOICES}, got {self.block_s}")
        if isinstance(self.block_f, bool) or not isinstance(self.block_f, int) \
                or self.block_f < 1:
            raise ValueError(f"block_f must be a positive int, got {self.block_f!r}")
        _ = self.fold_plan            # the fold's limits, checked up front

    @property
    def features(self) -> int:
        """Readout features F = N + 1 (bias folded)."""
        return self.n_nodes + 1

    @property
    def fold_plan(self) -> _FoldPlan:
        return _plan_fold(self.features, self.chunk_k, use_kernel=self.use_kernel,
                          block_t=self.block_t, n_cols=self.n_channels)


class SessionState(NamedTuple):
    """Everything a batch of B live DFR streams needs to resume mid-flight.

    The health leaves (``quarantined``/``poison``, DESIGN.md §12) are [B]
    bookkeeping only: no per-period axis ever enters the state.
    """

    s: torch.Tensor         # [B, N] f32 — reservoir carry (resume point)
    g: torch.Tensor         # [B, F, F] f32 — running (λ-decayed) Gram
    c: torch.Tensor         # [B, F, C] f32 — running Xᵀy moment
    y2: torch.Tensor        # [B] f32 — running (λ-decayed) ‖y‖²
    tcnt: torch.Tensor      # [B] f32 — effective (λ-decayed) sample count
    w: torch.Tensor         # [B, F, C] f32 — current readout (zeros until solved)
    lam_idx: torch.Tensor   # [B] i32 — GCV-selected λ index of that readout
    step: torch.Tensor      # [B] i32 — periods consumed (washout phase tracker)
    quarantined: torch.Tensor  # [B] bool — row reset by the health guard THIS tick
    poison: torch.Tensor    # [B] i32 — quarantine events since the slot was reset

    @property
    def batch(self) -> int:
        return self.s.shape[0]


def session_init(cfg: SessionConfig, batch: int, *, device=None) -> SessionState:
    """Fresh (dark-reservoir, empty-statistics) state for ``batch`` streams
    on ``device`` (default ``cuda``).  Raises ValueError up front when the
    fold cannot take ``batch`` instances."""
    _plan_fold(cfg.features, cfg.chunk_k, use_kernel=cfg.use_kernel, block_t=cfg.block_t,
               n_cols=cfg.n_channels, batch=batch)
    dev = resolve_device(device)
    f, c = cfg.features, cfg.n_channels

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((batch, *shape), dtype=dtype, device=dev)

    return SessionState(
        s=zeros(cfg.n_nodes), g=zeros(f, f), c=zeros(f, c), y2=zeros(), tcnt=zeros(),
        w=zeros(f, c), lam_idx=zeros(dtype=torch.int32), step=zeros(dtype=torch.int32),
        quarantined=zeros(dtype=torch.bool), poison=zeros(dtype=torch.int32))


def _copy(state: SessionState) -> SessionState:
    return SessionState(*(leaf.clone() for leaf in state))


def _zero_rows_(state: SessionState, rows: torch.Tensor) -> SessionState:
    """Zero every leaf of ``state`` in place where ``rows`` [B] is True."""
    for leaf in state:
        leaf.masked_fill_(rows.reshape((-1,) + (1,) * (leaf.ndim - 1)), 0)
    return state


def _as_rows(state: SessionState, rows) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.bool, device=state.s.device)


def session_reset(state: SessionState, rows) -> SessionState:
    """A copy of ``state`` with every leaf zeroed where ``rows`` [B] is True.

    The continuous-batching primitive: a finished stream's slot is handed
    to a newly arrived request by resetting that row on the device.
    """
    return _zero_rows_(_copy(state), _as_rows(state, rows))


def _rows_finite(*arrays) -> torch.Tensor:
    """[B] bool — True where every entry of every array's row is finite."""
    ok = None
    for a in arrays:
        fin = torch.all(torch.isfinite(a.reshape(a.shape[0], -1)), dim=1)
        ok = fin if ok is None else ok & fin
    return ok


def session_health(state: SessionState, y_hat: torch.Tensor | None = None) -> torch.Tensor:
    """[B] bool — per-row finite check of everything a row carries forward:
    its reservoir carry, Gram/moment statistics and readout (plus this
    tick's prediction when given)."""
    arrays = [state.s, state.g, state.c, state.y2, state.w]
    if y_hat is not None:
        arrays.append(y_hat)
    return _rows_finite(*arrays)


def _quarantine(state: SessionState, y_hat: torch.Tensor):
    """Slot quarantine (DESIGN.md §12), in place: rows whose post-fold
    state or prediction went non-finite are reset to the dark-reservoir /
    empty-statistics state (the period counter restarts, so the washout
    re-applies), their prediction is zeroed, the event is flagged in
    ``quarantined`` and counted in ``poison``.  Healthy rows are untouched."""
    bad = ~session_health(state, y_hat)
    for leaf in (state.s, state.g, state.c, state.y2, state.tcnt, state.w, state.lam_idx,
                 state.step):
        leaf.masked_fill_(bad.reshape((-1,) + (1,) * (leaf.ndim - 1)), 0)
    state = state._replace(quarantined=bad, poison=state.poison + bad.to(torch.int32))
    return y_hat.masked_fill_(bad[:, None, None], 0.0), state


def _valid_mask(cfg: SessionConfig, step: torch.Tensor, n_valid) -> torch.Tensor:
    """[B, chunk] f32 fit mask: past washout AND inside the valid prefix."""
    local = torch.arange(cfg.chunk_k, dtype=torch.int32, device=step.device)[None, :]
    vfit = (step[:, None] + local) >= cfg.washout
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=step.device).to(torch.int32)
        vfit = vfit & (local < nv[:, None])
    return vfit.to(torch.float32)


def _canon_chunk_targets(cfg: SessionConfig, y_chunk, device) -> torch.Tensor:
    y = torch.as_tensor(y_chunk, device=device).to(torch.float32)
    if y.ndim == 2:
        y = y[..., None]
    if y.shape[-1] != cfg.n_channels:
        raise ValueError(
            f"targets carry {y.shape[-1]} channels, config says {cfg.n_channels}")
    return y


def _gen_chunk(cfg: SessionConfig, mask, j_chunk, s):
    j = torch.as_tensor(j_chunk, device=s.device).to(torch.float32)
    return generate_states(cfg.model, j, mask, s0=s, method=cfg.state_method,
                           block_s=cfg.block_s, return_final=True,
                           state_dtype=cfg.state_dtype, device=s.device)


def _fold(cfg: SessionConfig, state: SessionState, states, y3, vfit, s_next) -> SessionState:
    """Fold one chunk of states into the running statistics (no solve);
    the Gram and moment stacks update in place."""
    x = with_bias(states)
    # keep the mask in the chunk dtype: a bf16 chunk stays bf16
    x.mul_(vfit.to(x.dtype)[:, :, None])
    yv = y3 * vfit[:, :, None]
    lam = cfg.forgetting
    tcnt = (state.tcnt + torch.sum(vfit, dim=1) if lam == 1.0
            else state.tcnt * lam + torch.sum(vfit, dim=1))
    g, cvec, y2 = _fold_chunk(cfg.fold_plan, state.g, state.c, state.y2, x, yv,
                              forgetting=lam)
    return state._replace(s=s_next, g=g, c=cvec, y2=y2, tcnt=tcnt,
                          step=state.step + cfg.chunk_k)


def _solve(cfg: SessionConfig, state: SessionState) -> SessionState:
    """Re-solve the readout from the current statistics (eigh + GCV).

    Under ``cfg.guard`` a row whose fresh solve comes back non-finite keeps
    its last-good readout (``guard_readout``); rows whose *statistics* are
    poisoned are handled by the quarantine.  ``torch.linalg.eigh`` raises
    on a non-finite matrix where ``jnp.linalg.eigh`` returns NaN, so a row
    whose Gram is not finite is solved from zeros and given NaN weights, as
    the reference's solve gives it; other rows are solved as they are.
    """
    ok = _rows_finite(state.g)[:, None, None]
    w, idx = solve_gcv(torch.where(ok, state.g, 0.0), state.c, state.y2,
                       state.tcnt[:, None], cfg.ridge_l2)
    w = torch.where(ok, w, torch.nan)
    idx = idx.to(torch.int32)
    if cfg.guard:
        w, idx = guard_readout(w, idx, state.w, state.lam_idx)
    return state._replace(w=w, lam_idx=idx)


def _predict(cfg: SessionConfig, states: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y_hat [B, chunk, C] f32 from the states and the current readout
    (``use_kernel``: the readout-apply kernel, which reads bf16 states as
    they are; else the widened matmul)."""
    return (readout_apply if cfg.use_kernel else readout_apply_plain)(states, w)


def session_update(cfg: SessionConfig, mask, state: SessionState, j_chunk, y_chunk, *,
                   refresh: bool = False, n_valid=None) -> SessionState:
    """Advance B sessions by one chunk of observed (input, target) pairs.

    ``j_chunk`` [B, chunk_k], ``y_chunk`` [B, chunk_k] or [B, chunk_k, C].
    Runs the reservoir from each session's carry, masks washout rows (per
    session, via ``step``) and rows past ``n_valid`` (ragged stream tails),
    folds the chunk into the statistics and, with ``refresh``, re-solves.
    With ``forgetting=1.0`` and aligned chunks the statistics and readout
    are bitwise those of ``fit_ridge_streaming`` over the concatenated
    stream.  Returns a new state; ``state`` is left unchanged.
    """
    state = _copy(state)
    y3 = _canon_chunk_targets(cfg, y_chunk, state.s.device)
    states, s_next = _gen_chunk(cfg, mask, j_chunk, state.s)
    state = _fold(cfg, state, states, y3, _valid_mask(cfg, state.step, n_valid), s_next)
    return _solve(cfg, state) if refresh else state


def session_predict(cfg: SessionConfig, mask, state: SessionState, j_chunk):
    """Inference-only chunk: advance the reservoir, apply the current readout.

    Returns (y_hat [B, chunk_k, C], state'): the statistics are left
    untouched, the carry and period counter advance.
    """
    states, s_next = _gen_chunk(cfg, mask, j_chunk, state.s)
    return _predict(cfg, states, state.w), state._replace(s=s_next, step=state.step + cfg.chunk_k)


def _session_step(cfg: SessionConfig, mask, state: SessionState, j_chunk, y_chunk, *,
                  refresh: bool = False, n_valid=None, reset=None):
    """The serving tick, on the slab it is handed: predict-then-update with
    ONE reservoir pass.

    Resets the rows flagged in ``reset`` [B] first (slots handed to newly
    arrived requests), evaluates the chunk's states once and uses them for
    the prediction (with the readout solved from earlier data) and the
    Gram fold, re-solves when ``refresh``, and ends with the quarantine
    under ``cfg.guard``.  ``state``'s tensors are updated in place where
    the tick can (the caller hands the slab over, as the reference's
    server donates it); use ``session_step`` to keep ``state``.

    Returns (y_hat [B, chunk_k, C], new state).
    """
    if reset is not None:
        state = _zero_rows_(state, _as_rows(state, reset))
    y3 = _canon_chunk_targets(cfg, y_chunk, state.s.device)
    states, s_next = _gen_chunk(cfg, mask, j_chunk, state.s)
    y_hat = _predict(cfg, states, state.w)
    state = _fold(cfg, state, states, y3, _valid_mask(cfg, state.step, n_valid), s_next)
    if refresh:
        state = _solve(cfg, state)
    if cfg.guard:
        y_hat, state = _quarantine(state, y_hat)
    return y_hat, state


def session_step(cfg: SessionConfig, mask, state: SessionState, j_chunk, y_chunk, *,
                 refresh: bool = False, n_valid=None, reset=None):
    """``_session_step`` on a copy of ``state``: ``state`` is left unchanged."""
    return _session_step(cfg, mask, _copy(state), j_chunk, y_chunk, refresh=refresh,
                         n_valid=n_valid, reset=reset)


def session_solve(cfg: SessionConfig, state: SessionState) -> SessionState:
    """Re-solve the readout now, regardless of cadence."""
    return _solve(cfg, state)
