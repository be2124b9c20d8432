"""Training driver: checkpoint/restart, straggler watchdog, failure recovery.

Port of ``repro/runtime/trainer.py``, the control loop a training job runs
(``launch/train.py`` wires it up):

  * **Restart**: on start, restore the newest intact checkpoint (falling
    back through older ones on integrity failure) and resume from its step;
    the data pipeline is deterministic in (seed, step), so the token stream
    continues exactly where it left off.
  * **Step retry**: a step that raises a ``RuntimeError`` (a CUDA error
    surfaces as one) is retried up to ``max_step_retries`` times from the
    last known-good state before surfacing.  The port's step updates the
    state in place only after every gradient exists
    (``runtime/steps.train_step``), so a step that raised left it as it was.
  * **Straggler watchdog**: flags steps exceeding ``straggler_factor`` ×
    the rolling median step time (the hook point is ``on_straggler``).

  * **Elastic re-shard**: checkpoints hold global arrays; with
    ``state_sharding=(mesh, spec_tree)`` (the state of local shards a
    sharded step trains) every save gathers the state and writes it once,
    and a restart on a different mesh re-lays it out
    (``checkpoint/store.py``).

The one host sync a step is the read of its metrics (the reference's
``device_get``), which also surfaces an asynchronous device failure inside
the retry.  Without ``state_sharding`` checkpoints are restored onto
``device``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable

import torch

from ..checkpoint.store import CheckpointStore
from ..data.pipeline import DataConfig, Prefetcher

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    max_step_retries: int = 2
    straggler_factor: float = 3.0
    log_every: int = 10


class StragglerWatchdog:
    """Rolling-median step-time monitor."""

    def __init__(self, factor: float, window: int = 32):
        self.factor = factor
        self.times: collections.deque = collections.deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float, on_straggler: Callable | None = None):
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
                if on_straggler:
                    on_straggler(step, dt, med)
        self.times.append(dt)


def host_metrics(metrics: dict) -> dict:
    """Scalar metrics (f32 device tensors) as host floats, in one read-back."""
    if not metrics:
        return {}
    values = [torch.as_tensor(v, dtype=torch.float32) for v in metrics.values()]
    dev = next((v.device for v in values if v.device.type != "cpu"), values[0].device)
    return dict(zip(metrics, torch.stack([v.to(dev) for v in values]).tolist()))


def run_training(
    *,
    step_fn,                      # (state, batch) -> (state, metrics)
    init_state_fn,                # () -> state   (fresh init, on its device)
    data_cfg: DataConfig,
    loop_cfg: TrainLoopConfig,
    device=None,                  # where restored leaves go (None: numpy leaves)
    state_sharding=None,          # (mesh, spec tree) of a sharded state
    on_metrics=None,
    on_straggler=None,
):
    store = CheckpointStore(loop_cfg.checkpoint_dir, keep=loop_cfg.keep_checkpoints)
    watchdog = StragglerWatchdog(loop_cfg.straggler_factor)

    state = init_state_fn()
    start_step = 0
    restored_step, restored = store.restore(state, device=device, sharding=state_sharding)
    if restored is not None:
        state, start_step = restored, restored_step
        log.info("restored checkpoint at step %d", start_step)

    prefetch = Prefetcher(data_cfg, start_step=start_step)
    history = []
    try:
        step = start_step
        while step < loop_cfg.total_steps:
            data_step, batch = prefetch.next()
            assert data_step == step, (data_step, step)

            t0 = time.time()
            retries = 0
            while True:
                try:
                    new_state, metrics = step_fn(state, batch)
                    # materialise to surface async runtime failures here
                    metrics = host_metrics(metrics)
                    break
                except RuntimeError as e:  # transient
                    retries += 1
                    if retries > loop_cfg.max_step_retries:
                        raise
                    log.warning("step %d failed (%s); retry %d", step, e, retries)
            state = new_state
            dt = time.time() - t0
            watchdog.observe(step, dt, on_straggler)

            metrics["step"] = step
            metrics["step_time_s"] = dt
            history.append(metrics)
            if on_metrics:
                on_metrics(metrics)
            if loop_cfg.log_every and step % loop_cfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, metrics.get("loss", float("nan")), dt)

            step += 1
            if loop_cfg.checkpoint_every and step % loop_cfg.checkpoint_every == 0:
                store.save_async(step, state, sharding=state_sharding)
        store.wait()
        store.save(loop_cfg.total_steps, state, sharding=state_sharding)
    finally:
        prefetch.close()
    return state, history, watchdog
