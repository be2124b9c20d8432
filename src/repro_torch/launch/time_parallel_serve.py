"""Per-rank figures of sharded serving on gloo ranks of one card.

    PYTHONPATH=src python -m repro_torch.launch.time_parallel_serve [--parent DIR] [--out FILE]

xlstm-1.3b at full width cut to one unit (7 mLSTM and 1 sLSTM blocks;
d_model 2048, 4 heads, d_in 4096, f 2730, vocab 50304) in f32, params
drawn on the card from seed 0 (the sLSTM's ``r_rec`` then scaled to
1/sqrt(head_dim), where its recurrence is not chaotic), serves a prefill of
8 × 512 token ids drawn with numpy from seed 0, then ``--decodes`` greedy
decode steps: in one process, then on two gloo ranks of the one card
(``launch.mesh.run_ranks``; NCCL refuses two ranks on one device) on the
(1, 2) mesh.  Per process: the prefill ms, each decode step's ms and their
p50 (each step ends in a synchronise), the collectives of the last decode
step by kind and mesh axis with their wire bytes by the dry run's ring
formulas (``time_parallel.collective_summary``), and the peak
``torch.cuda.max_memory_allocated`` over the serve.  With ``--parent DIR``
(a checkout of another commit, e.g. ``git archive <commit> | tar -x -C
DIR``) it measures DIR's package too, each checkout in a process of its
own (this file run against that checkout's ``src``), in turns parent,
this, this, parent.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH = (8, 512)
LAYERS = 8
SHAPE = (1, 2)


def config():
    """xlstm-1.3b at full width cut to LAYERS layers, f32."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("xlstm-1.3b"), dtype="float32", n_layers=LAYERS)


def params(cfg, dev):
    """The params of ``cfg`` drawn on ``dev`` from seed 0, each sLSTM's
    ``r_rec`` scaled from 1/sqrt(heads) to 1/sqrt(head_dim)."""
    from repro_torch.models import init_params

    out = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    hd = cfg.d_model // cfg.n_heads
    for blk, unit in zip(cfg.unit, out["units"], strict=True):
        if blk.mixer == "slstm":
            unit["mixer/r_rec"].mul_(math.sqrt(cfg.n_heads / hd))
    return out


def serve_figures(cfg, p, prompts, dev, decodes: int, batch: int) -> dict:
    """A prefill of ``prompts`` and ``decodes`` greedy decode steps under the
    active mesh, if any: prefill ms, decode ms, the last decode step's
    collectives and the peak device bytes."""
    from repro_torch.launch.time_parallel import collective_summary
    from repro_torch.parallel import sharding
    from repro_torch.runtime.steps import serve_decode, serve_prefill

    out = {"decode_ms": []}
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logit, cache = serve_prefill(cfg, p, prompts, max_len=prompts.shape[1] + decodes,
                                     batch=batch)
        torch.cuda.synchronize(dev)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        for _ in range(decodes):
            tok = torch.argmax(logit, dim=-1)[:, None]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with sharding.record_collectives() as events:
                logit, cache = serve_decode(cfg, p, cache, tok)
            torch.cuda.synchronize(dev)
            out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
    out["decode_ms_p50"] = statistics.median(out["decode_ms"])
    out["decode_collectives"] = collective_summary(events)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _prompts(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, BATCH)


def _rank(rank: int, decodes: int) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config()
    mesh = make_mesh(SHAPE, ("data", "model"), device_type="cuda")
    local = sharding.tree_shard(params(cfg, dev), sharding.param_pspecs(cfg, mesh), mesh)
    torch.cuda.empty_cache()
    rows = sharding.serve_rows(torch.as_tensor(_prompts(cfg), device=dev), mesh)
    with sharding.use_mesh(mesh):
        serve_figures(cfg, local, rows[:, :16], dev, 2, BATCH[0])            # warm
        return serve_figures(cfg, local, rows, dev, decodes, BATCH[0])


def _worker(decodes: int) -> None:
    import repro_torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.time_parallel import _card

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config()
    p = params(cfg, dev)
    prompts = torch.as_tensor(_prompts(cfg), device=dev)
    serve_figures(cfg, p, prompts[:, :16], dev, 2, BATCH[0])                  # warm
    one = serve_figures(cfg, p, prompts, dev, decodes, BATCH[0])
    del p
    torch.cuda.empty_cache()
    store = Path(__file__).resolve().parents[3] / "build" / "time_parallel_serve"
    store.mkdir(parents=True, exist_ok=True)
    ranks = run_ranks(_rank, math.prod(SHAPE), store_dir=str(store), args=(decodes,),
                      timeout=600, threads=None)
    print(json.dumps({"checkout": str(Path(repro_torch.__file__).resolve().parents[2]),
                      "card": _card(), "torch": torch.__version__, "arch": cfg.name,
                      "layers": cfg.n_layers, "batch": list(BATCH), "mesh": list(SHAPE),
                      "one_process": one, "ranks": ranks}), flush=True)


def main(argv=None) -> int:
    from repro_torch.launch.time_parallel import compare_checkouts

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to measure too")
    ap.add_argument("--decodes", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write the results here (JSON lines)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_parallel_serve needs a GPU", file=sys.stderr)
        return 2
    if args.worker:
        _worker(args.decodes)
        return 0
    return compare_checkouts(__file__, ["--decodes", str(args.decodes)], args.parent, args.out)


if __name__ == "__main__":
    sys.exit(main())
