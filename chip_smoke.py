#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build — the card's name and power limit (nvidia-smi), TF32
   off, both CUDA kernels built with nvcc from ``src/repro_torch/kernels/csrc``;
2. kernels vs their plain PyTorch versions on the card — the scan kernel
   for the four device models (f32 and bf16 states, per-lane masks,
   bitwise chunk resume), the Gram kernel on ragged edges and bf16 X, and
   accumulate-into == one-shot bitwise;
3. the main path at full width — ``Experiment.run`` on the paper's NARMA10
   Silicon-MR operating point (N = 900, washout 60, the λ grid, sampled
   digitiser noise 0.003) over 64 seeds through the scan kernel (2
   launches) and the Gram kernel (1 launch), then channel equalisation at
   the paper's N = 30; NRMSE/SER held to the bands of tests/test_pipeline.py;
   a stage breakdown of one more run, from the pipeline's own stage marks
   (``repro_torch.pipeline.record_stages``);
4. small end-to-end parity — kernel path vs the ``ref`` path (≤1e-3) and
   the Gram vs the SVD readout (≤5e-3) at N = 32, noise off;
5. the ``kernels`` line: launches on the main path, error vs the plain
   version, kernel / plain / library times and the roofline bound; and
   the time of one bare ``torch.linalg.eigh`` of the main path's Gram.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without that line; so it does when
no CUDA device is available or the port's package is not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

LAMS = (1e-10, 1e-8, 1e-6, 1e-4, 1e-2)
B_MAIN = 64
N_MAIN = 900
WASHOUT = 60
# f32 ops of one SiliconMR node step: u, drive (2), alpha, charge,
# discharge (2), compare, select
SCAN_OPS_PER_STEP = 9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def stack(datasets):
    import numpy as np

    return tuple(np.stack([getattr(d, f) for d in datasets])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_build(card: str) -> None:
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in r["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "per_source_seconds": {n: r["seconds"] for n, r in report.items()},
          "cached": {n: r["cached"] for n, r in report.items()}, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})


def phase_scan_checks(dev) -> None:
    """The scan kernel vs its plain version for every model it inlines."""
    import numpy as np
    import torch

    from repro_torch.core import MackeyGlass, MZISine, SiliconMR, SiliconMRLiteral, make_mask
    from repro_torch.kernels.dfr_scan import ops

    rng = np.random.default_rng(0)
    b, k, n = B_MAIN, 32, N_MAIN
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    results = {}
    # SiliconMR: the same separately rounded IEEE ops in both -> 1e-6.
    # Literal: the same ops, but its states grow geometrically (the printed
    # Eq. (6-7) is unstable), so its bound is relative to the largest state.
    # MackeyGlass and MZISine call powf/sinf in the kernel and torch's
    # pow/sin in the plain version: libm ulp differences carried through
    # the recurrence -> 1e-5.
    for model, levels, tol, relative in ((SiliconMR(), (0.0, 1.0), 1e-6, False),
                                         (SiliconMR(beta_tpa=0.5), (0.0, 1.0), 1e-6, False),
                                         (SiliconMRLiteral(), (0.0, 1.0), 1e-5, True),
                                         (MackeyGlass(), (-1.0, 1.0), 1e-5, False),
                                         (MZISine(), (0.0, 1.0), 1e-5, False)):
        mask = make_mask(n, levels=levels, seed=1, device=dev)
        out, fin = ops.dfr_scan(model, j, mask, s0, return_final=True)
        ref, ref_fin = ops.dfr_scan_plain(model, j, mask, s0)
        err = max(max_err(out, ref), max_err(fin, ref_fin))
        scale = max(1.0, float(ref.abs().max())) if relative else 1.0
        check(bool(torch.isfinite(out).all()), f"{model!r} states finite")
        check(err <= tol * scale, f"{model!r} scan vs plain {err} > {tol} x {scale}")
        # bitwise chunk resume: fin of one call as s0 of the next
        st1, f1 = ops.dfr_scan(model, j[:, :13], mask, s0, return_final=True)
        st2, f2 = ops.dfr_scan(model, j[:, 13:], mask, f1, return_final=True)
        check(torch.equal(torch.cat([st1, st2], dim=1), out) and torch.equal(f2, fin),
              f"{model!r} chunk resume is not bitwise")
        results[repr(model)] = {"max_abs_err": err, "state_scale": scale}
    mr, mask = SiliconMR(), make_mask(n, seed=1, device=dev)
    out16 = ops.dfr_scan(mr, j, mask, s0, out_dtype=torch.bfloat16)
    ref = ops.dfr_scan_plain(mr, j, mask, s0)[0]
    err16 = max_err(out16, ref)
    check(out16.dtype == torch.bfloat16 and err16 <= 4e-2, f"bf16 states err {err16}")
    masks = torch.stack([make_mask(n, seed=s, device=dev) for s in range(1, b + 1)])
    lane = ops.dfr_scan(mr, j, masks, s0)
    err_lane = max_err(lane, ops.dfr_scan_plain(mr, j, masks, s0)[0])
    check(err_lane <= 1e-6, f"per-lane mask err {err_lane}")
    emit({"phase": "kernel_checks", "kernel": "dfr_scan", "shape_bkn": [b, k, n],
          "by_model": results, "bf16_states_err": err16,
          "per_lane_mask_err": err_lane, "chunk_resume_bitwise": True})


def phase_gram_checks(dev) -> None:
    """The Gram kernel vs its plain version on ragged edges and bf16 X."""
    import numpy as np
    import torch

    from repro_torch.kernels.ridge_gram import ops

    rng = np.random.default_rng(1)
    b, t, f, c = 3, 517, 203, 2
    x = torch.as_tensor(rng.standard_normal((b, t, f)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.standard_normal((b, t, c)), dtype=torch.float32, device=dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        g, m = ops.gram_accumulate_batched(xd, y)
        gp, mp = ops.gram_plain_batched(xd, y)
        for name, a, r in (("G", g, gp), ("c", m, mp)):
            check(torch.allclose(a, r, rtol=1e-5, atol=1e-4),
                  f"gram {name} {dtype} vs plain: {max_err(a, r)}")
        errs[str(dtype)] = max(max_err(g, gp), max_err(m, mp))
    # accumulate-into over an uneven split == one-shot, bitwise
    g1, c1 = ops.gram_accumulate_batched(x, y)
    g0 = torch.zeros_like(g1)
    c0 = torch.zeros_like(c1)
    for lo, hi in ((0, 100), (100, 101), (101, t)):
        ops.gram_accumulate_batched_into(g0, c0, x[:, lo:hi], y[:, lo:hi])
    check(torch.equal(g0, g1) and torch.equal(c0, c1), "accumulate-into != one-shot")
    emit({"phase": "kernel_checks", "kernel": "ridge_gram", "shape_btfc": [b, t, f, c],
          "max_abs_err": errs, "into_equals_one_shot_bitwise": True})


def main_inputs(tasks, n_seeds: int):
    narma = stack([tasks.narma10(2000, seed=s) for s in range(n_seeds)])
    chan = stack([tasks.channel_equalization(9000, seed=s) for s in range(n_seeds)])
    return narma, chan


def phase_main_path(dev, narma, chan, card: str) -> dict:
    """The paper's claims path at full width, through the kernels."""
    import numpy as np
    import torch

    from repro_torch.core import SiliconMR
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.pipeline import Experiment, ExperimentConfig

    cfg = ExperimentConfig(model=SiliconMR(), n_nodes=N_MAIN, washout=WASHOUT, ridge_l2=LAMS,
                           state_method="kernel", readout_use_kernel=True)
    exp = Experiment(cfg, device=dev)

    def counts():
        return (scan_ops.dfr_scan.launches, gram_ops.gram_accumulate_batched.launches,
                gram_ops.gram_accumulate_batched_into.launches)

    def reset():
        scan_ops.dfr_scan.launches = 0
        gram_ops.gram_accumulate_batched.launches = 0
        gram_ops.gram_accumulate_batched_into.launches = 0

    reset()
    res, first_s = wall(lambda: exp.run(*narma))
    launches = counts()
    check(launches == (2, 1, 0), f"NARMA10 launches (scan, gram, into) = {launches}")
    check(bool(np.all(np.isfinite(res.nrmse))), "NARMA10 NRMSE finite")
    check(res.y_pred.shape == (B_MAIN, 1000), f"y_pred shape {res.y_pred.shape}")
    check(bool(np.all(res.nrmse < 0.72)), f"NARMA10 NRMSE per instance {res.nrmse}")
    check(float(res.nrmse.mean()) < 0.65, f"NARMA10 mean NRMSE {res.nrmse.mean()}")
    _, second_s = wall(lambda: exp.run(*narma))
    emit({"phase": "main_path", "task": "narma10", "card": card, "B": B_MAIN, "N": N_MAIN,
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "nrmse_mean": float(res.nrmse.mean()), "nrmse_max": float(res.nrmse.max()),
          "nrmse_min": float(res.nrmse.min()),
          "lam_counts": {str(v): int(c) for v, c in zip(*np.unique(res.lam, return_counts=True))},
          "run_wall_s_first": first_s, "run_wall_s_second": second_s})

    # Channel equalisation at the paper's N = 30 (quantized 4-PAM output).
    # Asserted with the SVD readout; the Gram/eigh readout is reported too:
    # it misses the band in the JAX package as well, with the same SERs on
    # the same states (tests/test_torch_experiment.py::
    # test_chan_eq_paper_point_readouts_match_reference).
    chan_out = {}
    for use_kernel in (False, True):
        ccfg = ExperimentConfig(model=SiliconMR(), n_nodes=30, washout=WASHOUT, ridge_l2=LAMS,
                                quantize=True, state_method="kernel",
                                readout_use_kernel=use_kernel)
        reset()
        cres, cs = wall(lambda: Experiment(ccfg, device=dev).run(*chan))
        claunch = counts()
        check(claunch == (2, int(use_kernel), 0), f"chan-eq launches {claunch}")
        check(set(np.unique(cres.y_pred)) <= {-3.0, -1.0, 1.0, 3.0}, "chan-eq symbols")
        if not use_kernel:
            check(bool(np.all(cres.ser < 0.16)), f"chan-eq SER per instance {cres.ser}")
            check(float(cres.ser.mean()) < 0.13, f"chan-eq mean SER {cres.ser.mean()}")
        chan_out["gram_eigh" if use_kernel else "svd"] = {
            "ser_mean": float(cres.ser.mean()), "ser_max": float(cres.ser.max()),
            "launches": {"dfr_scan": claunch[0], "ridge_gram": claunch[1]}, "wall_s": cs}
    emit({"phase": "main_path", "task": "channel_equalization", "card": card, "B": B_MAIN,
          "N": 30, "snr_db": 24.0, "asserted": "svd", "readouts": chan_out})
    return {"cfg": cfg, "exp": exp, "launches": launches}


def phase_stages(dev, narma, exp, card: str) -> None:
    """Stage breakdown of one more ``Experiment.run`` of the main path,
    recorded by the pipeline's own stage marks (host clock, a device
    synchronise at each mark)."""
    import numpy as np

    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.pipeline import record_stages

    scan_ops.dfr_scan.launches = 0
    gram_ops.gram_accumulate_batched.launches = 0
    with record_stages() as stages:
        res, run_s = wall(lambda: exp.run(*narma))
    launches = (scan_ops.dfr_scan.launches, gram_ops.gram_accumulate_batched.launches)
    check(launches == (2, 1), f"timed run launches (scan, gram) = {launches}")
    check(bool(np.all(res.nrmse < 0.72)), f"timed run NRMSE {res.nrmse}")
    emit({"phase": "stages", "task": "narma10", "card": card, "B": B_MAIN, "N": N_MAIN,
          "wall_s": stages, "run_wall_s": run_s,
          "unmarked_s": run_s - sum(stages.values()),
          "nrmse_mean": float(res.nrmse.mean())})


def kernel_inputs(dev, narma, cfg, exp) -> dict:
    """The kernels' inputs at the main path's shapes: the train split's
    sample series j [B, K] and the features [B, T - washout, N + 1] with
    their targets [B, T - washout, 1]."""
    from repro_torch.core import generate_states
    from repro_torch.pipeline import with_bias
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    tr_in = _canon_batch(narma[0], "inputs_train", dev)
    j_tr, _ = _input_layer(cfg, tr_in, tr_in)
    states = generate_states(cfg.model, j_tr, exp.mask, method="kernel", device=dev)
    y = _canon_batch(narma[1], "targets_train", dev)[:, WASHOUT:, None]
    return {"j_tr": j_tr, "x": with_bias(states[:, WASHOUT:]), "y": y, "mask": exp.mask}


def phase_parity(dev, tasks) -> None:
    """Kernel path vs the ref path and the SVD readout, N = 32, noise off.

    The states paths must agree to 1e-3 under either readout.  The Gram
    (eigh) readout vs the SVD readout is held to 5e-3, the reference's own
    bound (tests/test_pipeline.py::test_readout_kernel_path_agrees): on
    these eight seeds the JAX package's two readouts differ by more than
    1e-3 themselves (cond(X) squared in the Gram; shown on CPU by
    tests/test_torch_experiment.py::test_gram_vs_svd_readout_gap_is_the_references_own).
    """
    import numpy as np

    from repro_torch.core import SiliconMR
    from repro_torch.pipeline import Experiment, ExperimentConfig

    batch = stack([tasks.narma10(360, seed=s) for s in range(8)])
    runs = {}
    for method in ("kernel", "ref"):
        for readout in ("gram", "svd"):
            cfg = ExperimentConfig(model=SiliconMR(), n_nodes=32, washout=40, ridge_l2=(1e-4,),
                                   state_noise_rel=0.0, state_method=method,
                                   readout_use_kernel=readout == "gram")
            runs[(method, readout)] = Experiment(cfg, device=dev).run(*batch).nrmse

    def diff(a, b):
        return float(np.abs(runs[a] - runs[b]).max())

    diffs = {"kernel_vs_ref_states_gram": diff(("kernel", "gram"), ("ref", "gram")),
             "kernel_vs_ref_states_svd": diff(("kernel", "svd"), ("ref", "svd")),
             "gram_vs_svd_readout": diff(("kernel", "gram"), ("kernel", "svd"))}
    check(diffs["kernel_vs_ref_states_gram"] <= 1e-3, f"states parity (gram) {diffs}")
    check(diffs["kernel_vs_ref_states_svd"] <= 1e-3, f"states parity (svd) {diffs}")
    check(diffs["gram_vs_svd_readout"] <= 5e-3, f"readout parity {diffs}")
    emit({"phase": "parity", "N": 32, "B": 8, "nrmse_max_abs_diff": diffs})


def phase_kernels_line(dev, data: dict, launches) -> None:
    """Per-kernel times at the main path's shapes, errors, bounds."""
    import torch

    from repro_torch.core import SiliconMR
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops

    model, j, mask = SiliconMR(), data["j_tr"], data["mask"]
    b, k = j.shape
    n = mask.shape[0]
    s0 = torch.zeros((b, n), dtype=torch.float32, device=dev)
    out = scan_ops.dfr_scan(model, j, mask, s0)
    (ref, _), plain_s = wall(lambda: scan_ops.dfr_scan_plain(model, j, mask, s0))
    scan_err = max_err(out, ref)
    check(scan_err <= 1e-6, f"scan vs plain at the main shape: {scan_err}")
    scan_ms = cuda_ms(lambda: scan_ops.dfr_scan(model, j, mask, s0), reps=3)
    scan_bytes = 4 * (b * k + n + 2 * b * n + b * k * n)
    scan_bound, scan_by = bound_ms(scan_bytes, SCAN_OPS_PER_STEP * b * k * n)

    x, y = data["x"], data["y"]
    bb, t, f = x.shape
    cols = y.shape[-1]
    g, c = gram_ops.gram_accumulate_batched(x, y)
    (gp, cp), _ = wall(lambda: gram_ops.gram_plain_batched(x, y))
    gram_err = max(max_err(g, gp), max_err(c, cp))
    check(torch.allclose(g, gp, rtol=1e-5, atol=1e-4) and torch.allclose(c, cp, rtol=1e-5,
                                                                           atol=1e-4),
          f"gram vs plain at the main shape: {gram_err}")
    gram_ms = cuda_ms(lambda: gram_ops.gram_accumulate_batched(x, y), reps=5)
    gram_plain_ms = cuda_ms(lambda: gram_ops.gram_plain_batched(x, y), reps=5)
    gram_lib_ms = cuda_ms(lambda: torch.bmm(x.mT, x), reps=5)
    # G is symmetric: the function needs F(F+1)/2 dot products over T (the
    # kernel computes all F² of them), plus the F·C of c.
    gram_ops_n = bb * t * f * (f + 1) + 2 * bb * t * f * cols
    gram_bytes = 4 * (bb * t * f + bb * t * cols + bb * f * f + bb * f * cols)
    gram_bound, gram_by = bound_ms(gram_bytes, gram_ops_n)

    # accumulate-into: fold the last 640 rows onto the Gram of the first 300
    split = 300
    g0, c0 = gram_ops.gram_accumulate_batched(x[:, :split], y[:, :split])
    gi, ci = gram_ops.gram_accumulate_batched_into(g0.clone(), c0.clone(), x[:, split:],
                                                   y[:, split:])
    check(torch.equal(gi, g) and torch.equal(ci, c), "into != one-shot at the main shape")
    gq, cq = gram_ops.gram_plain_batched(x[:, split:], y[:, split:], g0=g0.clone(),
                                         c0=c0.clone())
    into_err = max(max_err(gi, gq), max_err(ci, cq))
    check(torch.allclose(gi, gq, rtol=1e-5, atol=1e-4), f"into vs plain: {into_err}")
    xs, ys = x[:, split:].contiguous(), y[:, split:].contiguous()
    g_run, c_run = g0.clone(), c0.clone()
    into_ms = cuda_ms(lambda: gram_ops.gram_accumulate_batched_into(g_run, c_run, xs, ys), reps=5)
    into_plain_ms = cuda_ms(lambda: gram_ops.gram_plain_batched(
        xs, ys, g0=g_run, c0=c_run), reps=5)
    into_lib_ms = cuda_ms(lambda: torch.baddbmm(g0, xs.mT, xs), reps=5)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(g), reps=2)
    tc = t - split
    into_bound, into_by = bound_ms(4 * (bb * tc * (f + cols) + 2 * bb * f * (f + cols)),
                                   bb * tc * f * (f + 1) + 2 * bb * tc * f * cols
                                   + bb * (f * (f + 1) // 2 + f * cols))
    emit({"kernels": [
        {"name": "dfr_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/dfr_scan.cu",
         "replaces": "src/repro/kernels/dfr_scan/dfr_scan.py:97", "launches": launches[0],
         "max_abs_err": scan_err, "ms": scan_ms, "plain_ms": plain_s * 1e3,
         "bound_ms": scan_bound, "bound_by": scan_by, "library_ms": None,
         "shape_bkn": [b, k, n]},
        {"name": "ridge_gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ridge_gram.cu",
         "replaces": "src/repro/kernels/ridge_gram/ridge_gram.py:118", "launches": launches[1],
         "max_abs_err": gram_err, "ms": gram_ms, "plain_ms": gram_plain_ms,
         "bound_ms": gram_bound, "bound_by": gram_by, "library_ms": gram_lib_ms,
         "shape_btf": [bb, t, f]},
        {"name": "ridge_gram_into", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ridge_gram.cu",
         "replaces": "src/repro/kernels/ridge_gram/ridge_gram.py:147", "launches": launches[2],
         "max_abs_err": into_err, "ms": into_ms, "plain_ms": into_plain_ms,
         "bound_ms": into_bound, "bound_by": into_by, "library_ms": into_lib_ms,
         "shape_btf": [bb, tc, f]},
    ]})
    emit({"phase": "library", "call": "torch.linalg.eigh", "shape": list(g.shape),
          "ms": eigh_ms})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.core import tasks
    except ImportError as err:
        print(f"chip_smoke: the port's package is not beside this script ({err})",
              file=sys.stderr)
        return 2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build(card)
    phase_scan_checks(dev)
    phase_gram_checks(dev)
    narma, chan = main_inputs(tasks, B_MAIN)
    main = phase_main_path(dev, narma, chan, card)
    phase_stages(dev, narma, main["exp"], card)
    phase_parity(dev, tasks)
    phase_kernels_line(dev, kernel_inputs(dev, narma, main["cfg"], main["exp"]),
                       main["launches"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
