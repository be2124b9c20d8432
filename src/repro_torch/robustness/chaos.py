"""Chaos soak: drive a session slab through faults and grade the guards.

Port of ``repro/robustness/chaos.py``.  :func:`run_soak` runs the SAME
stream data through the serving tick twice — once under the neutral
:class:`~repro_torch.robustness.faults.FaultSpec` (the clean reference)
and once under the caller's spec — and grades the three robustness claims
of DESIGN.md §12:

* **isolation** — slots whose spec is neutral produce *bitwise* the clean
  run's predictions and final state (the guards are per-row selects; no
  op mixes rows);
* **containment** — slots with poisoning faults (NaN/Inf/corrupt) are
  quarantined (``poison > 0``) and never emit a non-finite prediction;
* **re-convergence** — a quarantined slot restarts from the dark state and
  learns again from post-fault data: its tail symbol-error rate is
  reported for callers to gate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import tasks
from ..core.masking import make_mask
from ..pipeline.session import SessionConfig, SessionState, session_init
from .faults import FaultSpec, faulted_rows, faulty_session_step, no_faults

__all__ = ["make_streams", "run_soak"]


def make_streams(batch: int, n_periods: int, *, snr_db: float = 24.0, seed: int = 0):
    """[B, T] (inputs, targets) numpy arrays — one channel-equalization
    link a slot, with the serving CLI's input layer (a per-stream affine
    map to [0, 1]: the masked MR drive is an optical intensity)."""
    js, ys = [], []
    for r in range(batch):
        # over-request: the train_frac split may return a couple of periods
        # fewer than asked, and the soak needs whole ticks
        ds = tasks.channel_equalization(n_periods + 64, snr_db=snr_db,
                                        train_frac=0.999, seed=seed + r)
        x = np.asarray(ds.inputs_train[:n_periods], np.float32)
        x = (x - x.min()) / (x.max() - x.min() + 1e-12)
        js.append(x)
        ys.append(np.asarray(ds.targets_train[:n_periods], np.float32))
    return np.stack(js), np.stack(ys)


def _ser(y_hat: np.ndarray, y: np.ndarray) -> float:
    sym = np.asarray(tasks.SYMBOLS, np.float32)
    dec = sym[np.argmin(np.abs(y_hat[:, None] - sym[None, :]), axis=1)]
    return float(np.mean(dec != y))


def _run(cfg: SessionConfig, mask, spec: FaultSpec, j_all, y_all, *, n_ticks: int,
         seed: int):
    k = cfg.chunk_k
    dev = mask.device
    state = session_init(cfg, spec.batch, device=dev)
    j_dev = torch.as_tensor(j_all, device=dev)
    y_dev = torch.as_tensor(y_all, device=dev)
    y_hist, q_hist = [], []
    for t in range(n_ticks):
        y_hat, state = faulty_session_step(
            cfg, mask, spec, state, j_dev[:, t * k:(t + 1) * k], y_dev[:, t * k:(t + 1) * k],
            t, seed=seed, refresh=(t % cfg.refresh_every) == 0)
        y_hist.append(y_hat[..., 0].cpu().numpy())
        q_hist.append(state.quarantined.cpu().numpy())
    return (np.concatenate(y_hist, axis=1), np.stack(q_hist, axis=1),
            SessionState(*(leaf.cpu().numpy() for leaf in state)))


def run_soak(cfg: SessionConfig, spec: FaultSpec, *, n_ticks: int, seed: int = 0,
             data_seed: int = 0, snr_db: float = 24.0, tail_frac: float = 0.25) -> dict:
    """Soak ``spec`` against the clean reference and return the report.

    Both passes run the same code on the same data, on ``spec``'s device;
    only the spec differs.  Returns a JSON-serialisable report with the
    isolation / containment / re-convergence evidence; callers decide the
    gates.
    """
    batch, k = spec.batch, cfg.chunk_k
    dev = spec.nan_prob.device
    mask = make_mask(cfg.n_nodes, seed=data_seed, device=dev)
    j_all, y_all = make_streams(batch, n_ticks * k, snr_db=snr_db, seed=data_seed)
    yh_clean, _, st_clean = _run(cfg, mask, no_faults(batch, device=dev), j_all, y_all,
                                 n_ticks=n_ticks, seed=seed)
    yh_fault, q_hist, st_fault = _run(cfg, mask, spec, j_all, y_all,
                                      n_ticks=n_ticks, seed=seed)

    faulty = faulted_rows(spec).cpu().numpy()
    healthy = ~faulty
    leaves_equal = all(np.array_equal(a[healthy], b[healthy])
                       for a, b in zip(st_clean, st_fault))
    healthy_bitwise = bool(np.array_equal(yh_clean[healthy], yh_fault[healthy])
                           and leaves_equal)

    tail = max(1, int(round(n_ticks * k * tail_frac)))

    def tail_ser(rows: np.ndarray, yh: np.ndarray) -> float | None:
        if not rows.any():
            return None
        return _ser(yh[rows, -tail:].ravel(), y_all[rows, -tail:].ravel())

    return {
        "batch": batch,
        "n_ticks": n_ticks,
        "chunk": k,
        "washout": cfg.washout,
        "faulty_rows": np.flatnonzero(faulty).tolist(),
        "healthy_bitwise_identical": healthy_bitwise,
        "quarantine_events": st_fault.poison.tolist(),
        "quarantine_ticks": [np.flatnonzero(q_hist[i]).tolist() for i in range(batch)],
        "output_all_finite": bool(np.isfinite(yh_fault).all()),
        "tail_periods": tail,
        "tail_ser_healthy": tail_ser(healthy, yh_fault),
        "tail_ser_faulty": tail_ser(faulty, yh_fault),
        "tail_ser_clean": tail_ser(np.ones(batch, bool), yh_clean),
        "tail_ser_rows": [_ser(yh_fault[i, -tail:], y_all[i, -tail:]) for i in range(batch)],
    }
