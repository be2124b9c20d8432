"""Design-space exploration: a (detuning × loss × power) robustness map —
port of ``repro/devices/sweep.py``.

The grid's G = D·L·P points become G batch lanes of a ``CMTSweepParams``
whose leaves are [G] tensors; the task's series are broadcast over the same
lanes, and the whole map runs through one ``Experiment.run(...,
dev_params=...)`` call on the streaming path.  The reference folds the grid
into lanes so that one compiled program serves every grid; the port
compiles nothing, so it has no counterpart of ``pipeline_cache_size``.

>>> grid = SweepGrid(detune=(-1.0, 0.0, 1.0), loss_scale=(0.5, 1.0),
...                  power=(0.0, 1.0))
>>> res = run_device_sweep(model, grid, tasks.narma10(1200))
>>> res.nrmse.shape                      # (3, 2, 2) — the folded map
>>> res.stable_region(nrmse_max=0.4)     # boolean map + summary
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .cmt import CMTSweepParams, MRCavityCMT


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """A (detune × loss_scale × power) parameter box, axis values as tuples."""

    detune: tuple[float, ...]
    loss_scale: tuple[float, ...]
    power: tuple[float, ...]

    def __post_init__(self):
        for f in ("detune", "loss_scale", "power"):
            if not isinstance(getattr(self, f), tuple):
                object.__setattr__(self, f, tuple(float(v) for v in getattr(self, f)))
            if not getattr(self, f):
                raise ValueError(f"grid axis {f!r} is empty")

    @property
    def shape(self) -> tuple[int, int, int]:
        return (len(self.detune), len(self.loss_scale), len(self.power))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def lanes(self, *, device=None) -> CMTSweepParams:
        """The grid raveled into per-lane [G] f32 leaves (row-major: detune
        slowest, power fastest — ``fold`` is the inverse); a CPU tensor
        unless ``device`` is given, as ``make_mask``."""
        axes = (torch.tensor(getattr(self, f), dtype=torch.float32, device=device)
                for f in ("detune", "loss_scale", "power"))
        return CMTSweepParams(*(a.ravel() for a in torch.meshgrid(*axes, indexing="ij")))

    def fold(self, values) -> np.ndarray:
        """Per-lane [G] results back into the (D, L, P) map."""
        if isinstance(values, torch.Tensor):
            values = values.cpu().numpy()
        return np.asarray(values).reshape(self.shape)

    def point(self, idx: tuple[int, int, int]) -> dict:
        return {"detune": self.detune[idx[0]],
                "loss_scale": self.loss_scale[idx[1]],
                "power": self.power[idx[2]]}


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """The folded robustness map: one cell per grid point, numpy on host."""

    grid: SweepGrid
    nrmse: np.ndarray      # [D, L, P]
    ser: np.ndarray        # [D, L, P]
    lam: np.ndarray        # [D, L, P] — GCV-selected ridge λ per point

    def stable_region(self, *, nrmse_max: float = 0.4) -> dict:
        """The stable operating region (finite NRMSE under the bound): the
        boolean map plus a summary (fraction stable, the best point, the
        stable range of each axis)."""
        ok = np.isfinite(self.nrmse) & (self.nrmse <= nrmse_max)
        summary = {"nrmse_max": nrmse_max,
                   "n_stable": int(ok.sum()), "n_total": int(ok.size),
                   "stable_fraction": round(float(ok.mean()), 4)}
        if ok.any():
            masked = np.where(ok, self.nrmse, np.inf)
            best = np.unravel_index(int(np.argmin(masked)), ok.shape)
            summary["best_point"] = {**self.grid.point(best),
                                     "nrmse": round(float(self.nrmse[best]), 4),
                                     "ser": round(float(self.ser[best]), 4)}
            for ax, name in enumerate(("detune", "loss_scale", "power")):
                hit = ok.any(axis=tuple(i for i in range(3) if i != ax))
                vals = [getattr(self.grid, name)[i] for i in np.flatnonzero(hit)]
                summary[f"stable_{name}"] = [min(vals), max(vals)]
        return {"map": ok, "summary": summary}


def _tile(x, g: int) -> np.ndarray:
    return np.repeat(np.asarray(x, dtype=np.float32)[None, :], g, axis=0)


def run_device_sweep(model: MRCavityCMT, grid: SweepGrid, dataset, *,
                     n_nodes: int = 50, washout: int = 50,
                     stream_chunk_k: int | None = 256,
                     ridge_l2: tuple[float, ...] = (1e-8, 1e-6, 1e-4),
                     state_method: str = "fast", device=None) -> SweepResult:
    """The whole robustness map from one ``Experiment.run`` on ``device``
    (default ``cuda``).

    ``dataset`` is one ``core.tasks`` Dataset, broadcast over the G grid
    lanes, so every lane sees the same data and the map isolates the device
    physics.  ``stream_chunk_k`` keeps the run on the streaming path (no
    [G, T, N] state tensor); ``None`` runs the materialized path.  The
    reference's ``mask_seed`` argument, which it does not use, is left out:
    the config keeps its default mask.
    """
    from ..pipeline import Experiment, ExperimentConfig

    cfg = ExperimentConfig(model=model, n_nodes=n_nodes, washout=washout,
                           ridge_l2=ridge_l2, state_method=state_method,
                           stream_chunk_k=stream_chunk_k,
                           state_noise_rel=0.0, collect_y_pred=False)
    g = grid.size
    res = Experiment(cfg, device=device).run(
        _tile(dataset.inputs_train, g), _tile(dataset.targets_train, g),
        _tile(dataset.inputs_test, g), _tile(dataset.targets_test, g),
        dev_params=grid.lanes())
    return SweepResult(grid=grid, nrmse=grid.fold(res.nrmse),
                       ser=grid.fold(res.ser), lam=grid.fold(res.lam))
