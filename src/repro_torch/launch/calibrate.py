"""Structure-calibrated cost extraction (DESIGN.md §6).

Port of ``repro/launch/calibrate.py``.  The reference compiles cheap
variants at full tensor dims and solves for the per-component costs,
because XLA's ``cost_analysis()`` counts a ``while`` body once whatever
its trip count.  The port's dry run (``launch/dryrun.py``) runs the step
eagerly, so it counts every unit and every microbatch and under-counts
nothing: the variants' solved total must equal the direct count of the
whole config, which is what this module's test holds.  The variants are
the reference's, over the port's counts (FLOPs and collective wire
bytes), with one more for training:

  train:  A = opt + step_unit + emb + unit       (U'=1, M'=1)
          B = opt + 2·step_unit + emb + 2·unit   (U'=2, M'=1)
          C = opt + step_unit + 2·(emb + unit)   (U'=1, M'=2)
          D = opt + 2·step_unit + 2·(emb + 2·unit)   (U'=2, M'=2)
          -> unit = D−C−B+A;  step_unit = B−A−unit;  emb = C−A−unit;
             opt = A−step_unit−emb−unit
          total(U, M) = opt + U·step_unit + M·(emb + U·unit)
  serve:  A = base + 1·unit;  B = base + 2·unit
          -> unit = B−A;  total(U) = base + U·unit
  (+ an E'=2 encoder variant for enc-dec archs.)

``step_unit`` is what a unit costs once a step whatever the microbatches:
the port's train step gathers each unit's params and reduce-scatters their
gradients inside the microbatch loop, as the reference's GSPMD step does,
and all-reduces once a step the gradients of the leaves no batch axis
shards; the reference's A/B/C algebra is the case step_unit = 0 (the
FLOPs).  The variants run at the microbatch batch, as the
reference's do.  There is no ``bytes accessed`` count without a compiler.

Writes build/dryrun/calib__<arch>__<shape>__pod.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import torch

from ..configs import SHAPES, get_config, input_specs, list_archs, runnable_cells
from .dryrun import OUT_DIR, apply_overrides, measure

_METRICS = ("flops", "coll")


def _variant(cfg, *, units: int, microbatches: int, enc_layers: int | None = None):
    return dataclasses.replace(
        cfg,
        n_layers=units * len(cfg.unit),
        microbatches=microbatches,
        analysis_unroll=max(units, microbatches),
        n_encoder_layers=(enc_layers if enc_layers is not None else cfg.n_encoder_layers),
    )


def _resize_batch(specs, batch: int):
    """Shrink the batch dim of train/prefill input specs (not decode caches)."""
    return {k: v if k == "cache" else
            torch.empty((batch, *v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def _measure(cfg, shape, mesh_name: str, batch: int | None = None) -> dict:
    specs = input_specs(cfg, shape)
    if batch is not None:
        specs = _resize_batch(specs, batch)
    m = measure(cfg, shape, mesh_name, specs=specs)
    return {"flops": m["flops"], "coll": float(m["collectives"]["total"])}


def _sub(a, b):
    return {k: max(0.0, a[k] - b[k]) for k in a}


def solve(cfg, kind: str, measured) -> dict:
    """The per-component costs and the total from the variants'
    measurements (``measured(units, microbatches, enc_layers, batch_scale)``
    -> {"flops", "coll"})."""
    enc = cfg.n_encoder_layers
    e1 = min(1, enc)
    a = measured(1, 1, e1, 1)
    b = measured(2, 1, e1, 1)
    rec = {"n_units": cfg.n_units}
    if kind == "train":
        c = measured(1, 2, e1, 2)
        d = measured(2, 2, e1, 2)
        unit = _sub(_sub(d, c), _sub(b, a))
        step_unit = _sub(_sub(b, a), unit)
        emb = _sub(_sub(c, a), unit)
        opt = _sub(_sub(_sub(a, step_unit), emb), unit)
        rec.update({"unit": unit, "step_unit": step_unit, "emb": emb, "opt": opt,
                    "microbatches": cfg.microbatches})
        total = {k: opt[k] + cfg.n_units * step_unit[k]
                 + cfg.microbatches * (emb[k] + cfg.n_units * unit[k]) for k in _METRICS}
    else:
        unit = _sub(b, a)
        base = _sub(a, unit)
        rec.update({"unit": unit, "base": base})
        total = {k: base[k] + cfg.n_units * unit[k] for k in _METRICS}
    if enc:
        # the encoder runs, and gathers its units' params, once a microbatch
        enc_unit = _sub(measured(1, 1, 2, 1), a)
        rec["enc_unit"] = enc_unit
        mult = cfg.microbatches if kind == "train" else 1
        total = {k: total[k] + mult * (enc - 1) * enc_unit[k] for k in _METRICS}
    rec["total"] = total
    return rec


def calibrate_cell(arch: str, shape: str, *, force: bool = False,
                   overrides: dict | None = None, tag: str = "", out_dir=None,
                   mesh_name: str = "pod") -> dict:
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_path = out_dir / f"calib__{arch}__{shape}__{mesh_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = apply_overrides(get_config(arch), overrides)
    kind = SHAPES[shape]["kind"]
    # train variants run at the microbatch batch: one microbatch's worth a unit
    b_mb = SHAPES[shape]["batch"] // cfg.microbatches if kind == "train" else None

    def measured(units, microbatches, enc_layers, batch_scale):
        v = _variant(cfg, units=units, microbatches=microbatches, enc_layers=enc_layers)
        return _measure(v, shape, mesh_name, batch=None if b_mb is None else batch_scale * b_mb)

    rec = {"arch": arch, "shape": shape, **solve(cfg, kind, measured)}
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--tag", default="")
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
            rec = calibrate_cell(arch, shape, force=args.force, overrides=overrides,
                                 tag=args.tag, out_dir=args.out_dir)
            msg = f"ok flops={rec['total']['flops']:.3e} coll={rec['total']['coll']:.3e}B"
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failed += 1
            msg = f"FAIL {type(e).__name__}: {e}"
        print(f"[{time.time()-t0:7.1f}s] calib {arch:24s} {shape:12s} {msg}", flush=True)
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
