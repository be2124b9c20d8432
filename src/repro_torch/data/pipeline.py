"""Deterministic, host-sharded synthetic data pipeline.

Port of ``repro/data/pipeline.py`` (numpy only, so the port keeps its own
copy): every host generates only its own shard of the global batch,
deterministically from (seed, step, host_id), so a restarted or re-sharded
job regenerates identical batches with no coordination.  A background
prefetch thread keeps ``depth`` batches ready.  Batches are numpy int32
arrays, bitwise the reference's.

``host_batch`` makes structured pseudo-text: a mixture of Zipfian unigrams
and a repeated-ngram process, so models have learnable signal (loss
decreases) without any external corpus.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_repeat: float = 0.7   # prob of copying from `lag` tokens back
    lag: int = 64
    n_hosts: int = 1
    host_id: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=(cfg.seed, step, cfg.host_id))
    )


def host_batch(cfg: DataConfig, step: int) -> dict:
    """Generate this host's slice of batch ``step``: {tokens, labels}.

    Labels are next-token targets (shift-by-one of the same stream); the
    trainer's loss needs no extra shifting.
    """
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError("global_batch must divide evenly across hosts")
    b_local = cfg.global_batch // cfg.n_hosts
    rng = _batch_rng(cfg, step)
    s = cfg.seq_len + 1

    # Zipfian unigrams (clipped to vocab), then ngram-copy persistence.
    toks = rng.zipf(cfg.zipf_a, size=(b_local, s)) % cfg.vocab_size
    copy = rng.random((b_local, s)) < cfg.ngram_repeat
    copy[:, : cfg.lag] = False
    shifted = np.roll(toks, cfg.lag, axis=1)
    toks = np.where(copy, shifted, toks).astype(np.int32)

    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background thread producing host batches ``depth`` steps ahead."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = host_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
