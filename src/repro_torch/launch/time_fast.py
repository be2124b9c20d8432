"""Time the ``fast`` reservoir path end to end, one task instance a cell.

    PYTHONPATH=src python -m repro_torch.launch.time_fast [--device cpu] [--reps 3]

Cells, at the paper's operating points (``repro_torch.configs.dfrc_tasks()``):
NARMA10 on SiliconMR (N = 900, 2000 samples) and channel equalisation on
MackeyGlass (N = 400, mask levels ±1, quantized, 9000 symbols at 24 dB),
each an ``Experiment`` of ``ExperimentConfig.from_dfrc`` (``state_method=
"fast"``, the ``DFRCConfig`` default, and the five-λ grid).  Prints one
JSON line a cell: host seconds of each run (ending in a device synchronise
on ``cuda``), the metric, and the device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import dfrc_tasks
from ..core import tasks
from ..device import resolve_device
from ..pipeline import Experiment, ExperimentConfig


def cells():
    """(name, config, dataset) of each timed cell."""
    points = dfrc_tasks()
    return (
        ("narma10 Silicon MR", ExperimentConfig.from_dfrc(points["narma10"]["Silicon MR"]),
         tasks.narma10(2000, seed=0)),
        ("channel_eq Electronic (MG)",
         ExperimentConfig.from_dfrc(points["channel_eq"]["Electronic (MG)"]),
         tasks.channel_equalization(9000, seed=0)),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for name, cfg, ds in cells():
        exp = Experiment(cfg, device=dev)
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = exp.run_dataset(ds)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"cell": name, "device": str(dev), "N": cfg.n_nodes,
                          "periods": len(ds.inputs_train) + len(ds.inputs_test),
                          "wall_s": walls, "nrmse": float(res.nrmse[0]),
                          "ser": float(res.ser[0])}), flush=True)


if __name__ == "__main__":
    main()
