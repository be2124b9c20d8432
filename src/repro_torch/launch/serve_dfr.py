"""Online-learning DFR serving loop: continuous batching over live sessions.

Port of ``repro/launch/serve_dfr.py``.  Requests are *streams* (e.g. one
user's channel-equalization link); the per-slot state is the
``SessionState`` row (reservoir carry + running Gram statistics + current
readout), and the step is ``session_step``: ONE reservoir pass per
``chunk_k``-period tick shared by prediction (with the readout solved from
earlier data) and the RLS Gram fold.  Streams arrive mid-flight, are
packed into free slots by resetting that row on the device, and retire
when consumed.  The readout is re-solved on every ``refresh_every``-th
tick.  The slab lives on ``device`` (default ``cuda``) and each tick
updates it in place.

Robust serving (DESIGN.md §12) adds three host-side layers around the
in-step health guard:

* **Ingest validation** — a tick whose chunk carries NaN/Inf is *dropped*
  for that slot (fed as zeros with ``n_valid = 0``, so nothing folds) and
  counted; finite samples outside ``ingest_range`` are clamped and
  counted.  Counters surface in :meth:`DFRServer.stats`.
* **Dead-slot eviction** — a stream whose slot keeps tripping the
  quarantine (``SessionState.poison`` ≥ ``max_poison``) is evicted to
  ``server.evicted``.
* **Crash recovery** — with a ``checkpoint_dir`` the server snapshots the
  slab *plus all host queue metadata* (request bytes, consumption offsets,
  emitted predictions, counters) through ``CheckpointStore`` every
  ``checkpoint_every`` ticks.  :meth:`DFRServer.restore` resumes mid-stream
  and the resumed run is **bit-exact**: the slab round-trips through
  ``.npy``, request bytes round-trip base64, the refresh cadence is a
  function of the restored tick, and injected faults replay from their
  (seed, tick) hash.  A checkpoint of the reference's server restores too
  (its feature-padded Gram is cut to F).  Only wall-clock metrics
  (latencies) are best-effort across a crash.

Example:

  PYTHONPATH=src python -m repro_torch.launch.serve_dfr --requests 32 --batch 8 \\
      --nodes 64 --chunk 32 --forgetting 0.99 \\
      --checkpoint-dir /tmp/dfr_ckpt --checkpoint-every 16 --resume
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import time
from collections import deque

import numpy as np
import torch

from ..checkpoint import CheckpointStore
from ..convert import session_state_from_reference
from ..core import tasks
from ..core.masking import make_mask
from ..device import resolve_device
from ..pipeline.session import SessionConfig, _session_step, session_init
from ..robustness.faults import FaultSpec, faulty_session_step


@dataclasses.dataclass
class StreamRequest:
    """One live stream: inputs, observed targets, and consumption progress."""

    rid: int
    j: np.ndarray                  # [K] received series (reservoir input)
    y: np.ndarray                  # [K] transmitted symbols (online targets)
    pos: int = 0                   # periods consumed so far
    y_hat: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.pos >= len(self.j)


def _arr_to_json(a: np.ndarray) -> dict:
    """Lossless (bit-exact) array → JSON: raw bytes, base64."""
    a = np.ascontiguousarray(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def _arr_from_json(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["b64"]), dtype=d["dtype"])
    return a.reshape(d["shape"]).copy()


def _req_to_json(req: StreamRequest) -> dict:
    return {"rid": req.rid, "pos": req.pos,
            "j": _arr_to_json(req.j), "y": _arr_to_json(req.y),
            "y_hat": [_arr_to_json(y) for y in req.y_hat]}


def _req_from_json(d: dict) -> StreamRequest:
    return StreamRequest(rid=d["rid"], pos=d["pos"],
                         j=_arr_from_json(d["j"]), y=_arr_from_json(d["y"]),
                         y_hat=[_arr_from_json(y) for y in d["y_hat"]])


class DFRServer:
    """Fixed-slot continuous-batching server over one session slab.

    ``batch`` slots share one ``SessionState`` slab on ``device`` (default
    ``cuda``), which every tick updates in place.  Idle slots tick along on
    zero input with ``n_valid = 0`` (nothing folds into their Gram) until a
    request lands.  ``fault_spec`` (a
    :class:`~repro_torch.robustness.faults.FaultSpec` on the same device)
    swaps the tick for the fault-injecting wrapper, as the chaos soak uses
    it to attack a live server.
    """

    def __init__(self, cfg: SessionConfig, batch: int, *, mask_seed: int = 0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, checkpoint_keep: int = 3,
                 max_poison: int = 0,
                 ingest_range: tuple[float, float] | None = None,
                 fault_spec: FaultSpec | None = None, fault_seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.batch = batch
        self.device = resolve_device(device)
        self.mask = make_mask(cfg.n_nodes, seed=mask_seed, device=self.device)
        self.state = session_init(cfg, batch, device=self.device)
        self.slots: list[StreamRequest | None] = [None] * batch
        self.queue: deque[StreamRequest] = deque()
        self.tick = 0
        self.tick_seconds: list[float] = []
        self.completed: list[StreamRequest] = []
        self.evicted: list[StreamRequest] = []
        self.max_poison = max_poison
        self.ingest_range = ingest_range
        self.fault_spec = fault_spec
        self.fault_seed = fault_seed
        self.counters = {"dropped_ticks": 0, "dropped_values": 0,
                         "clamped_values": 0, "quarantine_events": 0,
                         "evictions": 0, "checkpoints_saved": 0}
        self.restored_from: int | None = None
        self.checkpoint_every = checkpoint_every
        self.store = (CheckpointStore(checkpoint_dir, keep=checkpoint_keep)
                      if checkpoint_dir else None)

    def submit(self, req: StreamRequest) -> None:
        self.queue.append(req)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _run_step(self, jc, yc, *, refresh, n_valid, reset):
        if self.fault_spec is None:
            return _session_step(self.cfg, self.mask, self.state, jc, yc,
                                 refresh=refresh, n_valid=n_valid, reset=reset)
        return faulty_session_step(self.cfg, self.mask, self.fault_spec, self.state,
                                   jc, yc, self.tick, seed=self.fault_seed,
                                   refresh=refresh, n_valid=n_valid, reset=reset)

    def warmup(self) -> None:
        """Run both step paths once before timing (kernel builds and library
        handles are first-call costs, not latency), then start afresh."""
        z = torch.zeros((self.batch, self.cfg.chunk_k), dtype=torch.float32,
                        device=self.device)
        nv = torch.zeros((self.batch,), dtype=torch.int32, device=self.device)
        rs = torch.zeros((self.batch,), dtype=torch.bool, device=self.device)
        for refresh in (False, True):
            _, self.state = self._run_step(z, z, refresh=refresh, n_valid=nv, reset=rs)
        self.state.w.cpu()
        self.state = session_init(self.cfg, self.batch, device=self.device)

    def _sanitize(self, jc: np.ndarray, yc: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Ingest validation of the packed chunks (DESIGN.md §12), in place.

        A row whose samples hold a non-finite value drops its tick (zero
        drive, ``n_valid = 0`` so nothing folds, and the stream still
        advances past the bad region); finite samples of the other rows
        outside ``ingest_range`` are clamped.  Returns ``n_valid`` [B].
        """
        bad = ~np.isfinite(jc) | ~np.isfinite(yc)      # padding is 0: finite
        dropped = bad.any(axis=1)
        if dropped.any():
            self.counters["dropped_ticks"] += int(dropped.sum())
            self.counters["dropped_values"] += int(bad.sum())
            jc[dropped] = 0.0
            yc[dropped] = 0.0
        if self.ingest_range is not None:
            lo, hi = self.ingest_range
            real = np.arange(jc.shape[1])[None, :] < lens[:, None]
            oob = ((jc < lo) | (jc > hi)) & real & ~dropped[:, None]
            if oob.any():
                self.counters["clamped_values"] += int(oob.sum())
                jc[oob] = np.clip(jc[oob], lo, hi)
        return np.where(dropped, 0, lens).astype(np.int32)

    def step(self) -> None:
        """One serving tick: pack arrivals, run the step, retire finished."""
        ck = self.cfg.chunk_k
        reset = np.zeros((self.batch,), bool)
        for i in range(self.batch):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                reset[i] = True
        jc = np.zeros((self.batch, ck), np.float32)
        yc = np.zeros((self.batch, ck), np.float32)
        lens = np.zeros((self.batch,), np.int32)
        served: list[tuple[int, StreamRequest, int]] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            lo, hi = req.pos, min(req.pos + ck, len(req.j))
            jc[i, : hi - lo] = req.j[lo:hi]
            yc[i, : hi - lo] = req.y[lo:hi]
            lens[i] = hi - lo
            served.append((i, req, hi - lo))
            req.pos = hi
        nv = self._sanitize(jc, yc, lens)
        refresh = (self.tick % self.cfg.refresh_every) == 0

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        t0 = time.perf_counter()
        y_hat, self.state = self._run_step(dev(jc), dev(yc), refresh=refresh,
                                           n_valid=dev(nv), reset=dev(reset))
        yh = y_hat[..., 0].cpu().numpy()               # waits for the tick
        self.tick_seconds.append(time.perf_counter() - t0)

        for i, req, n_used in served:
            req.y_hat.append(yh[i, :n_used])
            if req.done:
                self.completed.append(req)
                self.slots[i] = None
        self.tick += 1

        # health bookkeeping + dead-slot eviction (the in-step guard already
        # reset the row; the host decides whether the stream keeps its slot).
        # ``quarantined`` flags THIS tick's events only.
        if self.cfg.guard:
            q = self.state.quarantined.cpu().numpy()
            self.counters["quarantine_events"] += int(q.sum())
            if self.max_poison:
                poison = self.state.poison.cpu().numpy()
                for i in np.flatnonzero(poison >= self.max_poison):
                    req = self.slots[i]
                    if req is not None:
                        self.counters["evictions"] += 1
                        self.evicted.append(req)
                        self.slots[i] = None

        if (self.store is not None and self.checkpoint_every
                and self.tick % self.checkpoint_every == 0):
            self.save_checkpoint()

    # -- crash recovery --------------------------------------------------------
    def _meta_blob(self) -> np.ndarray:
        meta = {
            "tick": self.tick,
            "counters": self.counters,
            "slots": [None if r is None else _req_to_json(r) for r in self.slots],
            "queue": [_req_to_json(r) for r in self.queue],
            "completed": [_req_to_json(r) for r in self.completed],
            "evicted": [_req_to_json(r) for r in self.evicted],
        }
        return np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)

    def snapshot_tree(self) -> dict:
        """The checkpoint tree: the device slab + one host-metadata leaf —
        the reference server's layout, leaf for leaf."""
        return {"meta": self._meta_blob(), "slab": self.state}

    def save_checkpoint(self) -> None:
        """Atomic async snapshot at the current tick (DESIGN.md §3/§12)."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        # count first so the snapshot includes itself — a resumed server's
        # counter then matches the uninterrupted run's
        self.counters["checkpoints_saved"] += 1
        self.store.save_async(self.tick, self.snapshot_tree())

    def restore(self, *, step: int | None = None) -> int | None:
        """Resume from the newest intact checkpoint; returns its tick.

        Integrity failures (torn write, bit rot) fall back to the previous
        checkpoint inside ``CheckpointStore.restore``.  Everything the
        resumed ticks consume is restored bit-exactly; returns ``None`` (and
        leaves the server untouched) when nothing restorable exists.
        """
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        template = {"meta": np.zeros((0,), np.uint8),
                    "slab": session_init(self.cfg, self.batch, device=self.device)}
        got_step, tree = self.store.restore(template, step=step)
        if got_step is None:
            return None
        self.state = session_state_from_reference(tree["slab"], device=self.device)
        meta = json.loads(np.asarray(tree["meta"]).tobytes().decode("utf-8"))
        self.tick = int(meta["tick"])
        self.counters = dict(meta["counters"])
        self.slots = [None if r is None else _req_from_json(r) for r in meta["slots"]]
        self.queue = deque(_req_from_json(r) for r in meta["queue"])
        self.completed = [_req_from_json(r) for r in meta["completed"]]
        self.evicted = [_req_from_json(r) for r in meta["evicted"]]
        self.restored_from = got_step
        return got_step

    def close(self) -> None:
        """Flush any in-flight async checkpoint write."""
        if self.store is not None:
            self.store.wait()

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        """Health / progress counters for dashboards and the chaos soak."""
        return {
            "tick": self.tick,
            "active": self.active,
            "queued": len(self.queue),
            "completed": len(self.completed),
            "evicted": len(self.evicted),
            "restored_from": self.restored_from,
            **self.counters,
        }

    def drain(self, max_ticks: int = 100_000) -> None:
        while (self.queue or self.active) and self.tick < max_ticks:
            self.step()
        self.close()


def _latency_quantiles(seconds: list[float]):
    if not seconds:  # e.g. resumed from an already-drained checkpoint
        return float("nan"), float("nan")
    us = np.asarray(seconds) * 1e6
    return float(np.percentile(us, 50)), float(np.percentile(us, 99))


def channel_eq_requests(n_requests: int, stream_len: int, chunk: int, *,
                        snr_db: float = 24.0, seed: int = 0) -> list[StreamRequest]:
    """Independent channel-equalization streams (one link each), cut to
    whole chunks so the per-session washout counter tracks real periods
    exactly; the Experiment pipeline's input layer (a per-stream affine map
    to [0, 1]: the masked drive of the silicon MR is an optical intensity
    and cannot go negative)."""
    k = (stream_len // chunk) * chunk
    reqs = []
    for r in range(n_requests):
        ds = tasks.channel_equalization(max(k, 64), snr_db=snr_db, train_frac=0.999,
                                        seed=seed + r)
        x = np.asarray(ds.inputs_train[:k], np.float32)
        x = (x - x.min()) / (x.max() - x.min() + 1e-12)
        reqs.append(StreamRequest(rid=r, j=x, y=np.asarray(ds.targets_train[:k], np.float32)))
    return reqs


def online_ser(server: DFRServer, washout: int) -> tuple[float, float]:
    """(online SER, steady SER) over the completed streams: the post-washout
    symbol error of each stream, and the error of its last quarter once the
    readout has converged (the online number includes the cold-start misses
    made while the Gram was still filling); each the mean over streams."""
    sers, sers_tail = [], []
    sym = np.asarray(tasks.SYMBOLS, np.float32)
    for req in server.completed:
        yh = np.concatenate(req.y_hat)[washout:]
        yt = req.y[washout:len(req.j)]
        dec = sym[np.argmin(np.abs(yh[:, None] - sym[None, :]), axis=1)]
        sers.append(float(np.mean(dec != yt)))
        q = len(dec) // 4
        sers_tail.append(float(np.mean(dec[-q:] != yt[-q:])))
    return (float(np.mean(sers)) if sers else float("nan"),
            float(np.mean(sers_tail)) if sers_tail else float("nan"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--stream-len", type=int, default=512)
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--washout", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--forgetting", type=float, default=0.99)
    ap.add_argument("--refresh-every", type=int, default=4)
    ap.add_argument("--snr-db", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot the server every N ticks (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest intact checkpoint")
    ap.add_argument("--max-poison", type=int, default=0,
                    help="evict a stream after N quarantine events (0 = never)")
    ap.add_argument("--ingest-range", type=float, nargs=2, default=None,
                    metavar=("LO", "HI"),
                    help="clamp finite host inputs to [LO, HI] at ingest")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the session slab (cuda or cpu)")
    args = ap.parse_args(argv)

    # the port's main path: the scan kernel and the accumulate-into Gram
    # kernel on CUDA tensors, their plain versions on CPU tensors
    cfg = SessionConfig(n_nodes=args.nodes, washout=args.washout,
                        chunk_k=args.chunk, forgetting=args.forgetting,
                        refresh_every=args.refresh_every,
                        ridge_l2=(1e-8, 1e-6, 1e-4), state_method="kernel",
                        use_kernel=True)
    server = DFRServer(cfg, args.batch, mask_seed=args.seed,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every,
                       max_poison=args.max_poison,
                       ingest_range=(tuple(args.ingest_range)
                                     if args.ingest_range else None),
                       device=args.device)
    server.warmup()
    if args.resume and server.store is not None:
        got = server.restore()
        if got is not None:
            print(f"resumed from checkpoint tick={got}")

    if server.restored_from is None:
        for req in channel_eq_requests(args.requests, args.stream_len, args.chunk,
                                       snr_db=args.snr_db, seed=args.seed):
            server.submit(req)

    t0 = time.perf_counter()
    server.drain()
    wall = time.perf_counter() - t0

    ser_online, ser_steady = online_ser(server, args.washout)
    p50, p99 = _latency_quantiles(server.tick_seconds)
    streams_per_s = len(server.completed) / max(wall, 1e-9)
    periods_per_s = sum(len(r.j) for r in server.completed) / max(wall, 1e-9)
    print(f"device={server.device} batch={args.batch} requests={len(server.completed)} "
          f"ticks={server.tick} wall={wall*1e3:.1f}ms "
          f"({streams_per_s:.1f} streams/s, {periods_per_s:.0f} periods/s) "
          f"tick p50={p50:.0f}us p99={p99:.0f}us "
          f"online-SER={ser_online:.4f} steady-SER={ser_steady:.4f} "
          f"stats={json.dumps(server.stats())}")
    return server


if __name__ == "__main__":
    main()
