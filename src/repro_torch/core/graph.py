"""Composable reservoir graphs: deep, multi-loop, series-coupled topologies.

Port of ``repro/core/graph.py`` (DESIGN.md §13).  The paper's accelerator
is one delay loop and one MR neuron; the related work composes reservoirs —
deep photonic RC with an on-chip link nonlinearity between layers,
series-coupled microrings, multi-loop delay reservoirs whose L loops share
one drive.  This module is the graph those topologies share:

* :class:`ReservoirStage` — one delay-loop layer: a device model,
  ``n_nodes`` virtual nodes a loop, ``loops`` parallel loops sharing the
  stage's scalar drive (each with its own MLS mask), and the *link* that
  feeds the next stage (the mean of this stage's node states through an
  on-chip link nonlinearity, ``nonlinear.LINK_NONLINEARITIES``);
* :class:`ReservoirGraph` — a series chain of stages.  Stage k + 1's drive
  is stage k's linked output, period by period; the readout features are
  every stage's node states side by side (width ``graph.width``).

Both are frozen dataclasses of Python scalars.  The mask stacks are tensors,
built by :func:`build_stage_masks`.  Every stage maps ``(drive [B, chunk],
carry [B, L, N]) -> (features [B, chunk, L·N], carry')``, so the streaming
fit (``pipeline.ridge.fit_ridge_streaming_composed``) runs the whole chain
chunk by chunk and no stage holds a full-K block; :func:`graph_states` is
the materialized oracle.  A depth-1, loops-1 graph is a literal
``generate_states`` call (``generate_channel_states`` for per-instance
masks), so the single reservoir is the depth-1 case, bit for bit.

On the kernel path a stage is one scan-kernel launch: its L loops run as
batch lanes with per-lane masks (lane b·L + l is instance b, loop l).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .masking import make_mask
from .nonlinear import LINK_NONLINEARITIES, NLModel, SiliconMR
from .reservoir import generate_channel_states, generate_states


@dataclasses.dataclass(frozen=True)
class ReservoirStage:
    """One delay-loop layer of a reservoir graph.

    ``loops`` > 1: L separate delay loops, each with its own MLS mask phase,
    driven by the same scalar input; each loop's node chain closes on its
    own previous period, never across loops.

    ``link``/``link_gain`` shape the drive this stage feeds the next one:
    the mean of its L·N node states, times ``link_gain``, through the named
    link nonlinearity (the bounded default ``sat`` keeps a downstream
    SiliconMR inside the [0, 1] drive it is tuned on).  The last stage's
    link is unused.  ``input_gain`` scales this stage's incoming drive; at
    1.0 no op runs, so the default is bitwise the ungained path.
    """

    model: NLModel = dataclasses.field(default_factory=SiliconMR)
    n_nodes: int = 100
    loops: int = 1
    mask_seed: int = 1
    mask_levels: tuple[float, float] = (0.0, 1.0)
    input_gain: float = 1.0
    link: str = "sat"
    link_gain: float = 1.0

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.loops < 1:
            raise ValueError(f"loops must be >= 1, got {self.loops}")
        if self.link not in LINK_NONLINEARITIES:
            raise ValueError(f"unknown link {self.link!r}; "
                             f"known: {sorted(LINK_NONLINEARITIES)}")

    @property
    def width(self) -> int:
        """Virtual nodes this stage contributes to the readout features."""
        return self.n_nodes * self.loops


@dataclasses.dataclass(frozen=True)
class ReservoirGraph:
    """A series chain of :class:`ReservoirStage` layers."""

    stages: tuple[ReservoirStage, ...]

    def __post_init__(self):
        if not isinstance(self.stages, tuple):
            object.__setattr__(self, "stages", tuple(self.stages))
        if len(self.stages) < 1:
            raise ValueError("a ReservoirGraph needs at least one stage")
        for st in self.stages:
            if not isinstance(st, ReservoirStage):
                raise TypeError(f"stages must be ReservoirStage, got {st!r}")

    @property
    def depth(self) -> int:
        return len(self.stages)

    @property
    def width(self) -> int:
        """Readout feature nodes: Σ per-stage n_nodes·loops."""
        return sum(st.width for st in self.stages)

    @property
    def carry_layout(self) -> tuple[tuple[int, int], ...]:
        """Per-stage (loops, n_nodes): the shape of each stage's carry past
        the batch axis, and the slice layout of a feature row."""
        return tuple((st.loops, st.n_nodes) for st in self.stages)


def chain(*stages: ReservoirStage) -> ReservoirGraph:
    """``chain(stage0, stage1, ...)``: the series graph of the stages."""
    return ReservoirGraph(stages=tuple(stages))


def single(graph_or_stage) -> bool:
    """True for the depth-1, loops-1 case (the single reservoir)."""
    if isinstance(graph_or_stage, ReservoirStage):
        return graph_or_stage.loops == 1
    g = graph_or_stage
    return g.depth == 1 and g.stages[0].loops == 1


def build_stage_masks(graph: ReservoirGraph, *, channels: int | None = None,
                      device=None) -> tuple[torch.Tensor, ...]:
    """The graph's masks: a tuple of per-stage [L, N] stacks.

    Loop l of a stage gets ``make_mask(N, seed=mask_seed + l)``.  With
    ``channels=R`` (a per-channel topology under ``WDMExperiment``) each
    stage gets an [R, L, N] stack, channel r / loop l seeded at
    ``mask_seed + r·L + l``, so no two (channel, loop) lanes share a mask.
    ``device=None`` leaves the stacks on the CPU, as ``make_mask`` does.
    """
    masks = []
    for stage in graph.stages:
        def loop_masks(base):
            return torch.stack([make_mask(stage.n_nodes, levels=stage.mask_levels,
                                          seed=base + l, device=device)
                                for l in range(stage.loops)])

        if channels is None:
            masks.append(loop_masks(stage.mask_seed))
        else:
            masks.append(torch.stack([loop_masks(stage.mask_seed + r * stage.loops)
                                      for r in range(channels)]))
    return tuple(masks)


def stage_link_drive(stage: ReservoirStage, features: torch.Tensor) -> torch.Tensor:
    """The drive this stage feeds the next: [..., W] features -> [...].

    The f32 mean over the stage's L·N nodes (every node weighted equally),
    times ``link_gain`` where it is not 1.0, through the stage's link
    nonlinearity.  Taken in f32 from the emitted features, so bf16 state
    chunks round the drive once, not twice.
    """
    p = torch.mean(features.to(torch.float32), dim=-1)
    if stage.link_gain != 1.0:
        p = p * stage.link_gain
    return LINK_NONLINEARITIES[stage.link](p)


def stage_states(
    stage: ReservoirStage,
    drive: torch.Tensor,      # [B, K] this stage's scalar drive
    masks: torch.Tensor,      # [L, N] shared or [B, L, N] per-instance
    s0: torch.Tensor | None,  # [B, L, N] carry (None = dark loops)
    *,
    method: str = "fast",
    block_s: int | None = None,
    state_dtype=None,
    device=None,
):
    """One stage over ``drive``: -> (features [B, K, L·N], carry [B, L, N]).

    The L loops run as batch lanes (lane b·L + l) through the per-lane mask
    path: one scan-kernel launch for all B·L loops.  Loops-1 with shared
    masks is a literal ``generate_states`` call, with per-instance masks a
    literal ``generate_channel_states`` call.  Feature l·N + i is loop l's
    node i, as in the carry's [B, L, N] layout.
    """
    b, k = drive.shape
    per_instance = masks.ndim == 3
    l, n = masks.shape[-2:]
    if per_instance and masks.shape[0] != b:
        raise ValueError(f"per-instance masks {tuple(masks.shape)} do not match "
                         f"batch {b}")
    if stage.input_gain != 1.0:
        drive = drive * stage.input_gain
    kw = dict(method=method, block_s=block_s, return_final=True, state_dtype=state_dtype,
              device=device)
    if l == 1:
        s0_1 = None if s0 is None else s0[:, 0]
        if per_instance:
            states, s_next = generate_channel_states(stage.model, drive, masks[:, 0],
                                                     s0=s0_1, **kw)
        else:
            states, s_next = generate_states(stage.model, drive, masks[0], s0=s0_1, **kw)
        return states, s_next[:, None, :]
    # fold the loops into lanes: lane b·L + l carries (instance b, loop l)
    drive_lanes = drive.repeat_interleave(l, dim=0)                  # [B·L, K]
    masks_lanes = masks.reshape(b * l, n) if per_instance else masks.repeat(b, 1)
    s0_lanes = None if s0 is None else s0.reshape(b * l, n)
    states, s_next = generate_channel_states(stage.model, drive_lanes, masks_lanes,
                                             s0=s0_lanes, **kw)
    features = states.reshape(b, l, k, n).movedim(1, 2).reshape(b, k, l * n)
    return features, s_next.reshape(b, l, n)


def graph_states(
    graph: ReservoirGraph,
    j,                       # [B, K] (or [K]) stage 0's input drive
    masks,                   # per-stage [L, N] / [B, L, N] stacks
    *,
    s0=None,                 # per-stage [B, L, N] carries
    method: str = "fast",
    block_s: int | None = None,
    return_final: bool = False,
    state_dtype=None,
    device=None,
):
    """Materialized graph evaluation: -> features [B, K, graph.width].

    The oracle of the composed streaming path (tests and small runs): each
    stage's full-K state block is resident here, which the streaming fit
    (``pipeline.fit_ridge_streaming_composed``) avoids.  Stage s occupies
    feature columns ``[offset_s, offset_s + width_s)``; a depth-1, loops-1
    graph returns ``generate_states``'s output bit for bit.
    ``return_final=True`` adds the per-stage carry tuple: feed it back as
    ``s0`` to resume the chain.  Runs on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    j = torch.as_tensor(j, device=dev).to(torch.float32)
    squeeze = j.ndim == 1
    if squeeze:
        j = j[None, :]
    if len(masks) != graph.depth:
        raise ValueError(f"expected {graph.depth} stage mask stacks, got {len(masks)}")
    states_fn = _chain_fn(graph, masks, method=method, block_s=block_s,
                          state_dtype=state_dtype, device=dev)
    features, carries = states_fn(j, (None,) * graph.depth if s0 is None else tuple(s0))
    if squeeze:
        features = features[0]
        carries = tuple(c[0] for c in carries)
    return (features, carries) if return_final else features


def _chain_fn(graph: ReservoirGraph, masks, *, method: str, block_s: int | None,
              state_dtype, device):
    """``(drive [B, K], carries) -> (features [B, K, width], carries')``:
    every stage over the same K periods, stage k + 1 driven by stage k's
    linked output.  ``carries`` holds a per-stage [B, L, N] carry or None
    (dark loops)."""
    dev = resolve_device(device)
    masks = tuple(torch.as_tensor(m, device=dev).to(torch.float32) for m in masks)
    depth = graph.depth

    def states_fn(j, carries):
        feats, new_c = [], []
        drive = j
        for i, stage in enumerate(graph.stages):
            f_i, c_i = stage_states(stage, drive, masks[i], carries[i], method=method,
                                    block_s=block_s, state_dtype=state_dtype, device=dev)
            feats.append(f_i)
            new_c.append(c_i)
            if i + 1 < depth:
                drive = stage_link_drive(stage, f_i)
        return (feats[0] if depth == 1 else torch.cat(feats, dim=-1)), tuple(new_c)

    return states_fn
