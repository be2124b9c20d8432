"""Multi-pod dry run: every (arch × shape × mesh) cell's step on one rank of
a fake process group, on ``meta`` tensors.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell for 512 fake XLA host devices and reads the compiled program
(``memory_analysis``, ``cost_analysis``, the HLO's collectives).  The port
compiles nothing, so it runs its own step as it would run on a rank of the
production mesh, but on ``meta`` tensors (shapes and dtypes, no memory, no
arithmetic) under a ``fake`` process group of 256 or 512 ranks, whose
collectives return at once: the same code as a real run, without the
devices.  For each cell it

  1. builds the production mesh (16×16, or 2×16×16 multi-pod) over the fake
     group, as rank 0;
  2. builds this rank's inputs: the state's local shards under
     ``param_pspecs`` and the batch of ``configs.input_specs``;
  3. runs the train, prefill or decode step once, counting its FLOPs
     (``torch.utils.flop_counter.FlopCounterMode``: matmuls, convolutions
     and attention, forward and backward) and recording its collectives
     (``parallel.sharding.record_collectives``);
  4. records the bytes this rank holds as arguments and outputs, the
     collectives' wire bytes by the reference's ring formulas
     (``collective_bytes``), and writes
     ``build/dryrun/<arch>__<shape>__<mesh>.json``.

``temp_bytes`` (XLA's scratch) has no counterpart without a compiler and
is written as null.  The scan kernels K1 and K1ᵀ run on ``meta`` through
their operators' fake shape functions (``kernels/dfr_scan/ops.py``).
The train cells run the sharded train step (``runtime/steps.py``): the
rank's state blocks, each unit's leaves gathered as it runs, Megatron
tensor parallelism over "model", so the FLOPs counted on the rank leave
out the products it moves to the other model ranks, and the gradients
come back by reduce-scatter.
The serving cells (prefill, decode) run the sharded serving steps: the
rank's param blocks under ``param_pspecs``, its rows of the batch where
the batch axes divide it (else every row: long_500k), and for decode its
cache blocks under ``cache_pspecs``; a prefill allocates its cache blocks
itself.  ``collective_axes`` counts the collectives by kind and mesh axis.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all            # every runnable cell
  python -m repro_torch.launch.dryrun --all --mesh multipod
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time

import torch
import torch.distributed as dist

from ..configs import SHAPES, get_config, input_specs, list_archs, runnable_cells
from ..models.model import meta_params
from ..optim import AdamWConfig
from ..parallel import sharding
from ..runtime.steps import serve_decode, serve_prefill, state_pspecs, train_step
from .mesh import make_production_mesh

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
          "broadcast")


def collective_bytes(events) -> dict:
    """Per-rank wire bytes by collective kind (ring-algorithm estimate) of
    recorded collectives (``{"kind", "bytes", "group"}``).

    Result-shape convention, as the reference's: for a collective whose
    result is r bytes on a rank, over a group of n ranks —
      all-reduce          2·r·(n−1)/n      (reduce-scatter + all-gather ring)
      all-gather          r·(n−1)/n        (each rank receives r − its shard)
      reduce-scatter      r·(n−1)          (operand = r·n, sends (n−1) shards)
      all-to-all          r·(n−1)/n
      collective-permute  r
      broadcast           r·(n−1)/n        (the port's; a rank receives r but the root)
    """
    out: dict[str, float] = {}
    count: dict[str, int] = {}
    for ev in events:
        kind, r, n = ev["kind"], float(ev["bytes"]), ev["group"]
        if kind not in _KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        if kind == "all-reduce":
            wire = 2.0 * r * (n - 1) / n
        elif kind in ("all-gather", "all-to-all", "broadcast"):
            wire = r * (n - 1) / n
        elif kind == "reduce-scatter":
            wire = r * (n - 1)
        else:  # collective-permute
            wire = r
        out[kind] = out.get(kind, 0.0) + wire
        count[kind] = count.get(kind, 0) + 1
    out["total"] = sum(out.values())
    out["counts"] = count
    return out


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``fake`` process group of ``world_size`` ranks, this process being
    ``rank``, for the extent: its collectives return at once and move
    nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, sequences; other leaves 0)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def _meta_state(cfg) -> dict:
    zeros = meta_params(cfg)
    return {"params": meta_params(cfg), "opt": {"m": zeros, "v": meta_params(cfg)},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def build_step(cfg, shape: str, mesh, specs=None):
    """Returns (step fn, args) for one rank of ``mesh``: ``fn(*args)`` runs
    the cell's step under the mesh.  ``specs`` overrides the shape's input
    stand-ins (the calibration variants run at microbatch-sized batches)."""
    kind = SHAPES[shape]["kind"]
    if specs is None:
        specs = input_specs(cfg, shape)

    if kind == "train":
        opt_cfg = AdamWConfig()
        state = sharding.tree_shard(_meta_state(cfg), state_pspecs(cfg, mesh), mesh)

        def step(state, batch):
            with sharding.use_mesh(mesh):
                return train_step(cfg, opt_cfg, state, batch)

        return step, (state, specs)

    params = sharding.tree_shard(meta_params(cfg), sharding.param_pspecs(cfg, mesh), mesh)
    batch = specs["tokens"].shape[0]
    tokens = sharding.serve_rows(specs["tokens"], mesh)

    if kind == "prefill":
        def step(params, tokens, context=None):
            with sharding.use_mesh(mesh), torch.no_grad():
                return serve_prefill(cfg, params, tokens, context, batch=batch)

        return step, (params, tokens) + (
            (sharding.serve_rows(specs["context"], mesh),) if "context" in specs else ())

    if kind == "decode":
        full = specs["cache"]
        cache_specs = sharding.cache_pspecs(cfg, mesh, full)
        cache = {"pos": full["pos"], "specs": cache_specs,
                 "units": sharding.tree_shard(full["units"], cache_specs["units"], mesh)}

        def step(params, cache, tokens):
            with sharding.use_mesh(mesh), torch.no_grad():
                return serve_decode(cfg, params, cache, tokens)

        return step, (params, cache, tokens)

    raise ValueError(kind)


def apply_overrides(cfg, overrides: dict | None):
    """dataclasses.replace with string values coerced to the field types."""
    if not overrides:
        return cfg
    fields = {f.name for f in dataclasses.fields(cfg)}
    coerced = {}
    for k, v in overrides.items():
        if k not in fields:
            raise KeyError(k)
        cur = getattr(cfg, k)
        coerced[k] = type(cur)(v) if not isinstance(v, type(cur)) else v
    return dataclasses.replace(cfg, **coerced)


def measure(cfg, shape: str, mesh_name: str, specs=None) -> dict:
    """One cell's step on rank 0 of a fake production mesh: FLOPs, the
    bytes the rank holds, the recorded collectives and their wire bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    with fake_world(512 if mesh_name == "multipod" else 256):
        mesh = make_production_mesh(multi_pod=mesh_name == "multipod", device_type="cpu")
        t0 = time.perf_counter()
        fn, args = build_step(cfg, shape, mesh, specs=specs)
        with sharding.record_collectives() as events, FlopCounterMode(display=False) as fc:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        axes: dict[str, dict[str, int]] = {}
        for ev in events:
            by_axis = axes.setdefault(ev["kind"], {})
            by_axis[str(ev["axis"])] = by_axis.get(str(ev["axis"]), 0) + 1
        return {"n_devices": int(mesh.size()), "flops": float(fc.get_total_flops()),
                "memory": {"argument_bytes": tree_bytes(args), "output_bytes": tree_bytes(out),
                           "temp_bytes": None},
                "collectives": collective_bytes(events), "collective_axes": axes,
                "events": len(events), "seconds": seconds}


def run_cell(arch: str, shape: str, mesh_name: str, *, force: bool = False,
             overrides: dict | None = None, tag: str = "", out_dir=None) -> dict:
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_path = out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = apply_overrides(get_config(arch), overrides)
    m = measure(cfg, shape, mesh_name)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "n_devices": m["n_devices"],
           "flops": m["flops"], "memory": m["memory"], "collectives": m["collectives"],
           "collective_axes": m["collective_axes"],
           "model_params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "seconds": {"run": round(m["seconds"], 2)}}
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable); use with --tag")
    ap.add_argument("--tag", default="", help="suffix for the output JSON")
    ap.add_argument("--out-dir", default=None, help=f"default {OUT_DIR}")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.set)

    cells = []
    if args.all:
        for arch in list_archs(include_extras=True):
            for shape in runnable_cells(arch):
                cells.append((arch, shape))
    else:
        cells.append((args.arch, args.shape))

    failed = 0
    for arch, shape in cells:
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, args.mesh, force=args.force, overrides=overrides,
                           tag=args.tag, out_dir=args.out_dir)
            status = "ok"
            extra = (f"flops={rec['flops']:.3e} coll={rec['collectives']['total']:.3e}B "
                     f"args={rec['memory']['argument_bytes'] / 2**30:.2f}GiB")
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failed += 1
            status, extra = "FAIL", f"{type(e).__name__}: {e}"
        print(f"[{time.time()-t0:7.1f}s] {arch:24s} {shape:12s} {args.mesh:8s} {status} {extra}",
              flush=True)
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
