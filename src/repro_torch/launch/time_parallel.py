"""Per-rank figures of the sharded train step on gloo ranks of one card.

    PYTHONPATH=src python -m repro_torch.launch.time_parallel [--parent DIR] [--out FILE]

reservoir_lm at full width and depth (12 layers, d 768, N 256, vocab
32000, 4 microbatches, remat "full") with f32 activations, ``--steps``
steps of 8 × 512 tokens of the token stream from params drawn on the card
from seed 0: in one process, then on two gloo ranks of the one card
(``launch.mesh.run_ranks``; NCCL refuses two ranks on one device) on the
(1, 2) and the (2, 1) mesh.  ``step_figures`` gives, a step: the host ms
(the step ends in a synchronise), K1's and K1ᵀ's (launches, calls), and
the collectives by kind and mesh axis with their wire bytes by the dry
run's ring formulas (``collective_summary``); and over the steps the peak
``torch.cuda.max_memory_allocated``.  ``chip_smoke.py``'s ``parallel``
phase takes its figures from it.  With ``--parent DIR`` (a checkout of
another commit, e.g. ``git archive <commit> | tar -x -C DIR``) it measures
DIR's package too, each checkout in a process of its own (this file run
against that checkout's ``src``), in turns parent, this, this, parent.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = (8, 512)
SHAPES = ((1, 2), (2, 1))
_OPT = {"lr": 3e-3, "warmup_steps": 2, "total_steps": 10}


def config():
    """reservoir_lm at full width with f32 activations."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("reservoir_lm"), dtype="float32")


def batches(cfg, steps: int, shape=BATCH) -> list[dict]:
    """The token stream's first ``steps`` global batches of ``shape``
    (numpy)."""
    from repro_torch.data import DataConfig, host_batch

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape[1], global_batch=shape[0])
    return [host_batch(data, step) for step in range(steps)]


def collective_summary(events) -> dict:
    """The wire bytes of ``events`` by kind (``launch.dryrun.collective_bytes``)
    and, by kind and mesh axis, their count and wire bytes."""
    from repro_torch.launch.dryrun import collective_bytes

    by_axis: dict[str, dict] = {}
    for ev in events:
        cell = by_axis.setdefault(ev["kind"], {}).setdefault(str(ev["axis"]),
                                                             {"count": 0, "wire_bytes": 0.0})
        cell["count"] += 1
        cell["wire_bytes"] += collective_bytes([ev])[ev["kind"]]
    return {"wire_bytes": collective_bytes(events), "by_axis": by_axis}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_figures(cfg, state, host_batches, dev, opt, mesh=None) -> dict:
    """Train ``state`` over ``host_batches`` with AdamW(``opt``) (under
    ``mesh`` when given), in place.  Returns each step's metrics, host ms,
    K1's and K1ᵀ's (launches, calls) and collectives
    (``collective_summary``), the peak device bytes over the steps
    (``torch.cuda.max_memory_allocated``, 0 off the card), and the
    state."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding
    from repro_torch.runtime.steps import train_step

    out = {"metrics": [], "ms": [], "k1": [], "k1t": [], "collectives": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for batch in host_batches:
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for wrapper in (scan_ops.dfr_scan, scan_ops.dfr_scan_grad):
            wrapper.launches = wrapper.calls = 0
        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            events = []
            if mesh is not None:
                stack.enter_context(sharding.use_mesh(mesh))
                events = stack.enter_context(sharding.record_collectives())
            state, metrics = train_step(cfg, AdamWConfig(**opt), state, tb)
            metrics = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append(metrics)
        out["k1"].append((scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls))
        out["k1t"].append((scan_ops.dfr_scan_grad.launches, scan_ops.dfr_scan_grad.calls))
        out["collectives"].append(collective_summary(events))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["state"] = state
    return out


def summary(run: dict) -> dict:
    """A run's figures for a report: step ms (each, and p50), peak bytes,
    the last step's K1/K1ᵀ (launches, calls) and collectives."""
    return {"step_ms": run["ms"], "step_ms_p50": statistics.median(run["ms"]),
            "peak_bytes": run["peak_bytes"], "k1_launches_calls": list(run["k1"][-1]),
            "k1t_launches_calls": list(run["k1t"][-1]),
            "collectives_per_step": run["collectives"][-1],
            "losses": [m["loss"] for m in run["metrics"]]}


def _state(cfg, dev):
    from repro_torch.runtime.steps import init_train_state

    return init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def _rank(rank: int, steps: int) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.runtime.steps import state_pspecs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config()
    out = {}
    for shape in SHAPES:
        mesh = make_mesh(shape, ("data", "model"), device_type="cuda")
        state = sharding.tree_shard(_state(cfg, dev), state_pspecs(cfg, mesh), mesh)
        torch.cuda.empty_cache()
        run = step_figures(cfg, state, batches(cfg, steps), dev, _OPT, mesh=mesh)
        del run["state"], state
        torch.cuda.empty_cache()
        out[f"mesh_{shape[0]}x{shape[1]}"] = summary(run)
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _worker(steps: int) -> None:
    import repro_torch
    from repro_torch.launch.mesh import run_ranks

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config()
    one = step_figures(cfg, _state(cfg, dev), batches(cfg, steps), dev, _OPT)
    del one["state"]
    torch.cuda.empty_cache()
    store = Path(__file__).resolve().parents[3] / "build" / "time_parallel"
    store.mkdir(parents=True, exist_ok=True)
    ranks = run_ranks(_rank, 2, store_dir=str(store), args=(steps,), timeout=600, threads=None)
    print(json.dumps({"checkout": str(Path(repro_torch.__file__).resolve().parents[2]),
                      "card": _card(), "torch": torch.__version__,
                      "one_process": summary(one), "ranks": ranks}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to measure too")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the results here (JSON lines)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_parallel needs a GPU", file=sys.stderr)
        return 2
    if args.worker:
        _worker(args.steps)
        return 0
    return compare_checkouts(__file__, ["--steps", str(args.steps)], args.parent, args.out)


def compare_checkouts(script, worker_args: list, parent, out) -> int:
    """Run ``script --worker *worker_args`` against this checkout's ``src``
    (and, with ``parent``, that checkout's: parent, this, this, parent),
    each in a process of its own; print each run's last output line (JSON)
    and write them all to ``out`` when given."""
    here = Path(__file__).resolve().parents[3]
    order = [here] if parent is None else [Path(parent).resolve(), here, here,
                                           Path(parent).resolve()]
    results = []
    for checkout in order:
        env = {**os.environ, "PYTHONPATH": str(checkout / "src")}
        proc = subprocess.run([sys.executable, str(Path(script).resolve()), "--worker",
                               *worker_args], env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
