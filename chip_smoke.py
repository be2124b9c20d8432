#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build — the card's name and power limit (nvidia-smi), TF32
   off, both CUDA kernels built with nvcc from ``src/repro_torch/kernels/csrc``;
2. kernels vs their plain PyTorch versions on the card — the scan kernel
   for the four device models (f32 and bf16 states, per-lane masks,
   bitwise chunk resume), then on the edge grid of its block layout (N ∈
   {1, 31, 32, 33, 100, 900, the largest N} × B ∈ {1, 33, 64, 65}, K = 1,
   2, 37 in turn (1, 2 above N = 100), both mask modes, every model: SiliconMR exact, bf16
   states the f32 states rounded, resume at an uneven split bitwise;
   MZISine above the chain kernel's node limit, which SiliconMR raises at); the
   Gram kernel on the edges of its triangle
   grid (F at the 64-wide tile's edges and 901, C = 1 and 128, a ragged
   T, f32 and bf16 X, both thread layouts), G symmetric bitwise, a
   non-symmetric G0 through accumulate-into, and accumulate-into over an
   uneven split == one-shot bitwise;
3. the main path at full width — ``Experiment.run`` on the paper's NARMA10
   Silicon-MR operating point (N = 900, washout 60, the λ grid, sampled
   digitiser noise 0.003) over 64 seeds through the scan kernel (2
   launches) and the Gram kernel (1 launch), then channel equalisation at
   the paper's N = 30; NRMSE/SER held to the bands of tests/test_pipeline.py;
   a stage breakdown of one more run, from the pipeline's own stage marks
   (``repro_torch.pipeline.record_stages``);
4. small end-to-end parity — kernel path vs the ``ref`` path (≤1e-3) and
   the Gram vs the SVD readout (≤5e-3) at N = 32, noise off;
5. the streaming fused path at the same NARMA10 point (chunk 256, the
   noise as its expected Tikhonov diagonal): K1 once per chunk, K3 once per
   fit chunk, launches (8, 0, 4); bf16 chunks within 0.06 NRMSE of f32;
   noise off, the streamed Gram bitwise equal to the materialized K2 Gram
   and the NRMSE within 1e-5; a stage breakdown of one streamed run;
6. a long stream (K = 20000 a split): the streamed run's peak device memory
   under a quarter of one split's [B, K, N] f32 state tensor, beside the
   materialized run's peak;
7. WDM ensembles (R = 64 channels, N = 100, K = 10000 a split): K1 in its
   per-lane mode once per chunk, streamed vs materialized within 1e-5
   NRMSE per channel; the shared readout (R = 8, F = 801) against the same
   fit folded with plain matmuls;
8. the ``kernels`` line: each kernel at the shapes of the path it rides,
   its launches on that path, error vs the plain version (K1 also on a
   chunk resumed from a carry and on a whole materialized split, exact),
   kernel / plain / library times and the roofline bound (K1 also its chain
   bound at the card's maximum SM clock, from a chain-only loop timed on
   the card in this run, and its lanes a block) (K3 at the fold chunk of
   each of its three paths, timed from a symmetric running Gram); and the
   time of one bare ``torch.linalg.eigh`` of the main path's Gram.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without that line; so it does when
no CUDA device is available or the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# dependent f32 ops of SiliconMR's least node-chain step: mul, add, select
# (the compare and the charge add run beside them); the chain bound counts
# each at the latency of one dependent f32 add, measured on the card by
# chain_cycles()
CHAIN_OPS = 3
CHAIN_PROBE_STEPS = 1 << 20
STREAM_CHUNK = 256
N_WDM = 100
# the scan kernel's edge grid (phase_scan_checks): N at the float4 group's
# and the warp's edges and the path widths, B at the 8-lane block's edges
SCAN_EDGE_N = (1, 31, 32, 33, 100, 900)
SCAN_EDGE_B = (1, 33, 64, 65)
SCAN_EDGE_K = (1, 2, 37)
# the shared readout (F = 801), folded by K3 and by plain matmuls.  The gate
# on K3 there is each Gram's error against the bound of an f32 sum
# ("gram_error_vs_bound" ≤ 1).  The NRMSE gap between the two fits is no
# kernel check: it shows how far the ill-conditioned f32 solve (cond ≈ 8e8,
# one input drives all 8 channels) spreads two f32 sums taken in another
# order (≈ 0.012; the float64 fit reads 0.540 and both f32 fits 0.569–0.581,
# PERF.md).  SHARED_TOL only catches a readout far off either.
SHARED_TOL = 0.03
# two λ whose GCV scores differ by less than this (relative) tie: ‖y‖² summed
# in another order moves a score by ~1e-7 relative, a few times that after
# the cancellation in ‖y − ŷ‖²
GCV_TIE_RTOL = 1e-5


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


def sm_clocks_mhz() -> dict:
    """The SM clock now and its maximum, in MHz (nvidia-smi)."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    now, top = (float(v) for v in line.split(","))
    return {"now": now, "max": top}


def chain_cycles(dev) -> dict:
    """Cycles a step of two dependent chains on register values, one thread,
    CHAIN_PROBE_STEPS steps between two clock64() reads (the scan kernel's
    ``dfr_scan_chain_probe``), the least of three runs: ``kernel_step`` is
    SiliconMR's chain step as the scan kernel computes it, ``f32_op`` one
    dependent f32 add; ``least_step`` is CHAIN_OPS of the latter."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import _build

    fn = _build.load("dfr_scan").dfr_scan_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(3)
    # 8 inputs u, 8 chain-free values a, alpha, s0
    vals = np.concatenate([rng.uniform(0, 1, 8), rng.uniform(0.05, 0.4, 8), [0.632, 0.1]])
    x = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    last = torch.empty(1, dtype=torch.float32, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for form, name in ((0, "kernel_step"), (1, "f32_op")):
        runs = []
        for _ in range(3):
            _build.check(fn(form, x.data_ptr(), last.data_ptr(), cyc.data_ptr(),
                            CHAIN_PROBE_STEPS, stream), "dfr_scan_chain_probe")
            torch.cuda.synchronize(dev)
            check(bool(torch.isfinite(last).all()), f"chain probe {name}: state not finite")
            runs.append(int(cyc.item()) / CHAIN_PROBE_STEPS)
        res[name] = min(runs)
    res["least_step"] = CHAIN_OPS * res["f32_op"]
    return res


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def reset_counts() -> None:
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops

    scan_ops.dfr_scan.launches = 0
    gram_ops.gram_accumulate_batched.launches = 0
    gram_ops.gram_accumulate_batched_into.launches = 0


def launch_counts() -> tuple[int, int, int]:
    """(K1 dfr_scan, K2 ridge_gram, K3 ridge_gram_into) launches so far."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops

    return (scan_ops.dfr_scan.launches, gram_ops.gram_accumulate_batched.launches,
            gram_ops.gram_accumulate_batched_into.launches)


@contextlib.contextmanager
def solved_grams():
    """Record a copy of every (G, c, ‖y‖², sample count) the pipeline hands
    its GCV solve."""
    from repro_torch.pipeline import ridge

    seen = []
    solve = ridge.solve_gcv

    def spy(g, c, y2, n_samples, lambdas):
        seen.append((g.clone(), c.clone(), y2.clone(), n_samples))
        return solve(g, c, y2, n_samples, lambdas)

    ridge.solve_gcv = spy
    try:
        yield seen
    finally:
        ridge.solve_gcv = solve


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


def scan_models():
    """(name, model, mask levels, tolerance vs the plain version, relative?)
    for every form the scan kernel inlines.  SiliconMR (with and without
    TPA) runs the plain version's separately rounded IEEE ops (the TPA
    division is __fdiv_rn in the kernel, an IEEE division in torch): exact.
    Literal runs the same ops, but its states grow geometrically (the
    printed Eq. (6-7) is unstable), so its bound is relative to the largest
    state.  MackeyGlass and MZISine call powf/sinf in the kernel and torch's
    pow/sin in the plain version: libm ulp differences carried through the
    recurrence -> 1e-5."""
    from repro_torch.core import MackeyGlass, MZISine, SiliconMR, SiliconMRLiteral

    return (("SiliconMR", SiliconMR(), (0.0, 1.0), 0.0, False),
            ("SiliconMR_tpa", SiliconMR(beta_tpa=0.5), (0.0, 1.0), 0.0, False),
            ("SiliconMRLiteral", SiliconMRLiteral(), (0.0, 1.0), 1e-5, True),
            ("MackeyGlass", MackeyGlass(), (-1.0, 1.0), 1e-5, False),
            ("MZISine", MZISine(), (0.0, 1.0), 1e-5, False))


def scan_edge_cases(per_lane: bool):
    """(B, K, N) of the scan kernel's edge grid for one mask mode: every N of
    SCAN_EDGE_N and the largest N the block layout takes, each with every B
    of SCAN_EDGE_B; K cycles through SCAN_EDGE_K (only 1 and 2 above N =
    100, where the plain version's node loop is longest)."""
    from repro_torch.kernels.dfr_scan import ops

    cases = []
    for a, n in enumerate((*SCAN_EDGE_N, ops.max_nodes(per_lane))):
        ks = SCAN_EDGE_K if n <= 100 else SCAN_EDGE_K[:2]
        for c, b in enumerate(SCAN_EDGE_B):
            cases.append((b, ks[(a + c) % len(ks)], n))
    return cases


def scan_edge_check(dev, model, levels, tol, relative, b, k, n, per_lane, seed) -> float:
    """The scan kernel on one edge case: states and carry vs the plain
    version within ``tol`` (× the largest state if ``relative``); bf16
    states equal the f32 states rounded, with the same f32 carry, bitwise;
    the scan resumed from its carry at an uneven split equals one call
    bitwise; one launch a call.  Returns the error vs the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels.dfr_scan import ops

    rng = np.random.default_rng(seed)
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.choice(levels, (b, n) if per_lane else (n,)),
                           dtype=torch.float32, device=dev)
    what = f"{model!r} B={b} K={k} N={n} {'per-lane' if per_lane else 'broadcast'}"
    before = ops.dfr_scan.launches
    out, fin = ops.dfr_scan(model, j, mask, s0, return_final=True)
    check(ops.dfr_scan.launches == before + 1, f"{what}: not one launch")
    ref, ref_fin = ops.dfr_scan_plain(model, j, mask, s0)
    err = max(max_err(out, ref), max_err(fin, ref_fin))
    scale = max(1.0, float(ref.abs().max())) if relative else 1.0
    check(err <= tol * scale, f"{what}: scan vs plain {err} > {tol} x {scale}")
    out16, fin16 = ops.dfr_scan(model, j, mask, s0, out_dtype=torch.bfloat16, return_final=True)
    check(torch.equal(out16, out.to(torch.bfloat16)) and torch.equal(fin16, fin),
          f"{what}: bf16 states are not the f32 states rounded")
    if k > 1:
        cut = k // 3 + 1
        st1, f1 = ops.dfr_scan(model, j[:, :cut], mask, s0, return_final=True)
        st2, f2 = ops.dfr_scan(model, j[:, cut:], mask, f1, return_final=True)
        check(torch.equal(torch.cat([st1, st2], dim=1), out) and torch.equal(f2, fin),
              f"{what}: chunk resume at {cut} is not bitwise")
    return err / scale


def phase_scan_checks(dev) -> None:
    """The scan kernel vs its plain version for every form it inlines: at
    the main width (B = 64, N = 900, K = 32) with per-lane masks and bf16
    states, then on the edge grid of its block layout (``scan_edge_cases``:
    N at the float4 group's and the warp's edges, the largest N, B at the
    8-lane block's edges, K = 1, 2, 37 in turn), in both mask modes."""
    import numpy as np
    import torch

    from repro_torch.core import SiliconMR, make_mask
    from repro_torch.kernels.dfr_scan import ops

    rng = np.random.default_rng(0)
    b, k, n = B_MAIN, 32, N_MAIN
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    results = {}
    for name, model, levels, tol, relative in scan_models():
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
        results[name] = {"max_abs_err": err, "state_scale": scale}
    mr, mask = SiliconMR(), make_mask(n, seed=1, device=dev)
    out16 = ops.dfr_scan(mr, j, mask, s0, out_dtype=torch.bfloat16)
    ref = ops.dfr_scan_plain(mr, j, mask, s0)[0]
    err16 = max_err(out16, ref)
    check(out16.dtype == torch.bfloat16 and err16 <= 4e-2, f"bf16 states err {err16}")
    masks = torch.stack([make_mask(n, seed=s, device=dev) for s in range(1, b + 1)])
    lane = ops.dfr_scan(mr, j, masks, s0)
    err_lane = max_err(lane, ops.dfr_scan_plain(mr, j, masks, s0)[0])
    check(err_lane == 0.0, f"per-lane mask err {err_lane}")
    emit({"phase": "kernel_checks", "kernel": "dfr_scan", "shape_bkn": [b, k, n],
          "by_model": results, "bf16_states_err": err16,
          "per_lane_mask_err": err_lane, "chunk_resume_bitwise": True})

    t0 = time.perf_counter()
    grid, cases = {}, 0
    for per_lane in (False, True):
        edges = scan_edge_cases(per_lane)
        for name, model, levels, tol, relative in scan_models():
            errs = [scan_edge_check(dev, model, levels, tol, relative, eb, ek, en, per_lane,
                                    seed=cases + i) for i, (eb, ek, en) in enumerate(edges)]
            cases += len(edges)
            grid[f"{name} {'per-lane' if per_lane else 'broadcast'}"] = max(errs)
    # MZISine's kernel keeps no rows in shared memory: no node limit
    above = {}
    for per_lane in (False, True):
        n_above = ops.max_nodes(per_lane) + 1
        name, model, levels, tol, relative = scan_models()[-1]
        above[f"{name} {'per-lane' if per_lane else 'broadcast'}"] = scan_edge_check(
            dev, model, levels, tol, relative, 33, 2, n_above, per_lane, seed=cases)
        cases += 1
        z = torch.zeros((33, n_above), device=dev)
        try:
            ops.dfr_scan(scan_models()[0][1], z[:, :2], z if per_lane else z[0], z)
        except ValueError:
            pass
        else:
            check(False, f"SiliconMR at N = {n_above} did not raise")
    emit({"phase": "kernel_checks", "kernel": "dfr_scan", "edge_grid": {
              "N": [*SCAN_EDGE_N, "max"], "max_nodes": {"broadcast": ops.max_nodes(False),
                                                        "per_lane": ops.max_nodes(True)},
              "B": SCAN_EDGE_B, "K": SCAN_EDGE_K, "cases": cases,
              "max_err_vs_plain_by_form": grid, "mzi_above_node_limit": above,
              "bf16_is_f32_rounded_bitwise": True,
              "resume_bitwise": True, "seconds": time.perf_counter() - t0}})


def phase_gram_checks(dev) -> None:
    """The Gram kernel vs its plain version on the edges of its triangle
    grid: F ∈ {1, 63, 64, 65, 901} (the 64-wide tile's edges), C ∈ {1, 128},
    a ragged T, f32 and bf16 X, each at B = 2 and at a B whose triangle
    grid gives every SM 4 blocks (the two thread layouts of the kernel).
    K2's G equals its transpose bitwise; K3 from a non-symmetric G0 gives
    G0 + XᵀX (rtol 1e-5, atol 1e-4: f32 sums in another order); K3 over
    the uneven split (0, 100), (100, 101), (101, T) equals one shot
    bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels.ridge_gram import ops

    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t = 517
    errs, cases = {}, 0
    for f in (1, 63, 64, 65, 901):
        tiles = -(-f // 64)
        for b in (2, 4 * sms // (tiles * (tiles + 1) // 2) + 1):
            for c in (1, 128):
                x = torch.as_tensor(rng.standard_normal((b, t, f)), dtype=torch.float32,
                                    device=dev)
                y = torch.as_tensor(rng.standard_normal((b, t, c)), dtype=torch.float32,
                                    device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    xd = x.to(dtype)
                    what = f"F={f} B={b} C={c} {dtype}"
                    g, m = ops.gram_accumulate_batched(xd, y)
                    gp, mp = ops.gram_plain_batched(xd, y)
                    for name, a, r in (("G", g, gp), ("c", m, mp)):
                        check(torch.allclose(a, r, rtol=1e-5, atol=1e-4),
                              f"gram {name} {what} vs plain: {max_err(a, r)}")
                    check(torch.equal(g, g.mT), f"K2 G not symmetric bitwise ({what})")
                    g0 = torch.rand((b, f, f), dtype=torch.float32, device=dev)
                    c0 = torch.rand((b, f, c), dtype=torch.float32, device=dev)
                    gi, ci = ops.gram_accumulate_batched_into(g0.clone(), c0.clone(), xd, y)
                    gq, cq = ops.gram_plain_batched(xd, y, g0=g0.clone(), c0=c0.clone())
                    check(torch.allclose(gi, gq, rtol=1e-5, atol=1e-4)
                          and torch.allclose(ci, cq, rtol=1e-5, atol=1e-4),
                          f"K3 from a non-symmetric G0 ({what}): {max_err(gi, gq)}")
                    gs, cs = torch.zeros_like(g), torch.zeros_like(m)
                    for lo, hi in ((0, 100), (100, 101), (101, t)):
                        ops.gram_accumulate_batched_into(gs, cs, xd[:, lo:hi], y[:, lo:hi])
                    check(torch.equal(gs, g) and torch.equal(cs, m),
                          f"accumulate-into over an uneven split != one shot ({what})")
                    errs[what] = max(max_err(g, gp), max_err(m, mp), max_err(gi, gq))
                    cases += 1
                del x, y
    emit({"phase": "kernel_checks", "kernel": "ridge_gram", "T": t, "cases": cases,
          "max_abs_err_vs_plain": max(errs.values()), "k2_symmetric_bitwise": True,
          "into_nonsymmetric_g0_ok": True, "into_equals_one_shot_bitwise": True})


def main_inputs(tasks, n_seeds: int):
    narma = stack([tasks.narma10(2000, seed=s) for s in range(n_seeds)])
    chan = stack([tasks.channel_equalization(9000, seed=s) for s in range(n_seeds)])
    return narma, chan


def phase_main_path(dev, narma, chan, card: str) -> dict:
    """The paper's claims path at full width, through the kernels."""
    import numpy as np

    from repro_torch.core import SiliconMR
    from repro_torch.pipeline import Experiment, ExperimentConfig

    cfg = ExperimentConfig(model=SiliconMR(), n_nodes=N_MAIN, washout=WASHOUT, ridge_l2=LAMS,
                           state_method="kernel", readout_use_kernel=True)
    exp = Experiment(cfg, device=dev)

    reset_counts()
    res, first_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()
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
        reset_counts()
        cres, cs = wall(lambda: Experiment(ccfg, device=dev).run(*chan))
        claunch = launch_counts()
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

    from repro_torch.pipeline import record_stages

    reset_counts()
    with record_stages() as stages:
        res, run_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()[:2]
    check(launches == (2, 1), f"timed run launches (scan, gram) = {launches}")
    check(bool(np.all(res.nrmse < 0.72)), f"timed run NRMSE {res.nrmse}")
    emit({"phase": "stages", "task": "narma10", "card": card, "B": B_MAIN, "N": N_MAIN,
          "wall_s": stages, "run_wall_s": run_s,
          "unmarked_s": run_s - sum(stages.values()),
          "nrmse_mean": float(res.nrmse.mean())})


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


def streamed_vs_materialized(what: str, grams, res_s, res_m) -> dict:
    """Noise off, the streamed (G, c) equal the materialized K2's bitwise.
    ‖y‖² is summed chunk by chunk on one path and in one pass on the other,
    so the two GCV picks can differ where two λ tie to f32 round-off: where
    the λ agree, w must be bitwise equal and the NRMSE within 1e-5; where
    they differ, each run must score the other's λ within GCV_TIE_RTOL of
    its own pick."""
    import numpy as np
    import torch

    from repro_torch.pipeline.ridge import gcv_path

    (g_s, c_s, y2_s, n_s), (g_m, c_m, y2_m, n_m) = grams
    check(torch.equal(g_s, g_m) and torch.equal(c_s, c_m),
          f"{what}: streamed Gram vs materialized K2 Gram: G {max_err(g_s, g_m)}, "
          f"c {max_err(c_s, c_m)}")
    same = res_s.lam == res_m.lam
    gap = np.abs(res_s.nrmse - res_m.nrmse)
    gap_same = float(gap[same].max()) if same.any() else 0.0
    check(gap_same <= 1e-5, f"{what}: streamed vs materialized NRMSE where λ agrees {gap_same}")
    w_bitwise = bool(np.array_equal(res_s.readout_w[same], res_m.readout_w[same]))
    check(w_bitwise, f"{what}: w differs where λ agrees")
    lams = np.asarray(LAMS, dtype=np.float32)
    ties = []
    for i in np.flatnonzero(~same):
        pick = {"streamed": int(np.argmin(np.abs(lams - res_s.lam[i]))),
                "materialized": int(np.argmin(np.abs(lams - res_m.lam[i])))}
        rel = {}
        for name, (g, c, y2, n), other in (("streamed", grams[0], "materialized"),
                                           ("materialized", grams[1], "streamed")):
            score = gcv_path(g[i], c[i], y2[i], n, LAMS)[1]
            rel[name] = float((score[pick[other]] - score[pick[name]]) / score[pick[name]])
            check(rel[name] <= GCV_TIE_RTOL,
                  f"{what}: instance {i} λ flip is no GCV tie ({name} {rel[name]})")
        ties.append({"instance": int(i), "lam": {k: float(LAMS[v]) for k, v in pick.items()},
                     "gcv_rel_gap": rel, "nrmse_gap": float(gap[i])})
    return {"gram_bitwise": True, "lam_agrees": int(same.sum()), "instances": int(same.size),
            "nrmse_max_gap_where_lam_agrees": gap_same, "nrmse_max_gap": float(gap.max()),
            "w_bitwise_where_lam_agrees": w_bitwise, "y2_max_rel_gap":
            float(((y2_s - y2_m).abs() / y2_m.abs()).max()), "gcv_ties": ties}


def shared_features(cfg, masks, tr, te, dev):
    """The shared readout's features, materialized: the fit rows of the
    train split (after the washout) and the test split, [T, R·N + 1] each
    (channel-major, bias last)."""
    from repro_torch.pipeline import channel_states, with_bias
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    j_tr, j_te = _input_layer(cfg, _canon_batch(tr, "inputs_train", dev),
                              _canon_batch(te, "inputs_test", dev))
    st_tr, fin = channel_states(cfg.model, j_tr, masks, method="kernel", return_final=True,
                                device=dev)
    st_te = channel_states(cfg.model, j_te, masks, s0=fin, method="kernel", device=dev)

    def features(st):
        r, k, n = st.shape
        return with_bias(st.movedim(0, 1).reshape(k, r * n))

    return features(st_tr)[cfg.washout:], features(st_te)


def f64_ridge(x, y, x_te, y_te, lam: float) -> dict:
    """The ridge fit at one λ in float64 (the port's λ' = λ·tr(G)/F): its
    test NRMSE and the condition number of the regularised system."""
    import numpy as np
    import torch

    from repro_torch.core.metrics import nrmse

    x64 = x.double()
    g = x64.mT @ x64
    lamp = lam * float(torch.trace(g)) / g.shape[-1]
    ev = torch.linalg.eigvalsh(g)
    w = torch.linalg.solve(g + lamp * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device),
                           x64.mT @ y.double())
    pred = (x_te.double() @ w)[:, 0].cpu().numpy()
    return {"nrmse": float(nrmse(np.asarray(y_te, dtype=np.float64), pred)),
            "cond": float((ev[-1] + lamp) / (ev[0].clamp(min=0) + lamp))}


def gram_error_ratio(g, c, x, y) -> float:
    """The largest error of (G, c) against the float64 XᵀX and Xᵀy (X
    [..., T, F]), as a share of the classical bound on an f32 sum of T
    products,
    γ_T·|X|ᵀ|X| with γ_T = T·u/(1 − T·u), u = 2⁻²⁴.  Above 1, the sums
    are wrong, not merely rounded."""
    import torch

    t = x.shape[-2]
    u = 2.0 ** -24
    gamma = t * u / (1 - t * u)
    x64, y64 = x.double(), y.double()
    tiny = torch.finfo(torch.float64).tiny
    return max(float(((got.double() - exact).abs() / (gamma * mag + tiny)).max())
               for got, exact, mag in ((g, x64.mT @ x64, x64.abs().mT @ x64.abs()),
                                       (c, x64.mT @ y64, x64.abs().mT @ y64.abs())))


def stream_config(**kw):
    """The streaming fused path at the main path's NARMA10 point."""
    from repro_torch.core import SiliconMR
    from repro_torch.pipeline import ExperimentConfig

    base = dict(model=SiliconMR(), n_nodes=N_MAIN, washout=WASHOUT, ridge_l2=LAMS,
                state_method="kernel", readout_use_kernel=True, stream_chunk_k=STREAM_CHUNK,
                state_noise_mode="diagonal", state_noise_rel=0.003)
    base.update(kw)
    return ExperimentConfig(**base)


def phase_streaming(dev, narma, card: str) -> dict:
    """NARMA10 at the paper's point on the streaming fused path: 1000/1000
    periods in chunks of 256 (the train split ends in a ragged chunk of
    232), through K1 once per chunk and K3 once per fit chunk."""
    import numpy as np

    from repro_torch.pipeline import Experiment, record_stages

    cfg = stream_config()
    exp = Experiment(cfg, device=dev)
    reset_counts()
    res, first_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()
    check(launches == (8, 0, 4), f"streamed launches (scan, gram, into) = {launches}")
    check(bool(np.all(np.isfinite(res.nrmse))), "streamed NRMSE finite")
    check(res.y_pred.shape == (B_MAIN, 1000), f"streamed y_pred shape {res.y_pred.shape}")
    check(bool(np.all(res.nrmse < 0.72)), f"streamed NRMSE per instance {res.nrmse}")
    check(float(res.nrmse.mean()) < 0.65, f"streamed mean NRMSE {res.nrmse.mean()}")
    _, steady_s = wall(lambda: exp.run(*narma))

    # bf16 state chunks: within the drift bound of DESIGN.md §9
    res16 = Experiment(dataclasses.replace(cfg, stream_state_dtype="bfloat16"),
                       device=dev).run(*narma)
    drift = float(np.abs(res16.nrmse - res.nrmse).max())
    check(drift <= 0.06, f"bf16 vs f32 streamed NRMSE drift {drift}")

    # noise off: the streamed Gram IS the materialized K2 Gram, bitwise
    off = dataclasses.replace(cfg, state_noise_rel=0.0)
    with solved_grams() as grams:
        res_s = Experiment(off, device=dev).run(*narma)
        res_m = Experiment(dataclasses.replace(off, stream_chunk_k=None), device=dev).run(*narma)
    noise_off = streamed_vs_materialized("NARMA10", grams, res_s, res_m)
    noise_off["nrmse_mean"] = float(res_s.nrmse.mean())

    reset_counts()
    with record_stages() as stages:
        rec, run_s = wall(lambda: exp.run(*narma))
    check(launch_counts() == (8, 0, 4), f"recorded streamed run launches {launch_counts()}")
    check(bool(np.array_equal(rec.nrmse, res.nrmse)), "recorded streamed run NRMSE differs")
    emit({"phase": "streaming", "task": "narma10", "card": card, "B": B_MAIN, "N": N_MAIN,
          "chunk": STREAM_CHUNK, "noise": "diagonal 0.003",
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "nrmse_mean": float(res.nrmse.mean()), "nrmse_max": float(res.nrmse.max()),
          "run_wall_s_first": first_s, "run_wall_s_steady": steady_s,
          "bf16_nrmse_max_drift": drift, "bf16_nrmse_mean": float(res16.nrmse.mean()),
          "noise_off": noise_off,
          "stages_wall_s": stages, "stages_run_wall_s": run_s,
          "unmarked_s": run_s - sum(v for k, v in stages.items()
                                    if k not in ("stream_states", "stream_fold"))})
    return {"launches": launches, "exp": exp}


def phase_long_stream(dev, tasks, card: str) -> None:
    """K = 20000 a split, noise off: the streamed run's peak device memory
    stays under a quarter of one split's [B, K, N] f32 state tensor."""
    import numpy as np
    import torch

    from repro_torch.pipeline import Experiment

    long = stack([tasks.narma10(40000, seed=s) for s in range(B_MAIN)])
    k_split = long[0].shape[1]
    state_bytes = B_MAIN * k_split * N_MAIN * 4
    peaks, walls, nrmse = {}, {}, {}
    for name, chunk in (("streamed", STREAM_CHUNK), ("materialized", None)):
        exp = Experiment(stream_config(state_noise_rel=0.0, stream_chunk_k=chunk), device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res, walls[name] = wall(lambda: exp.run(*long))
        peaks[name] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                       "allocated_before": before}
        nrmse[name] = res.nrmse
        check(bool(np.all(np.isfinite(res.nrmse))), f"long {name} NRMSE finite")
    peak = peaks["streamed"]["peak_bytes"]
    check(peak < state_bytes / 4, f"streamed peak {peak} B >= a quarter of {state_bytes} B")
    emit({"phase": "long_stream", "card": card, "B": B_MAIN, "N": N_MAIN, "K_split": k_split,
          "chunk": STREAM_CHUNK, "state_tensor_bytes_per_split": state_bytes,
          "memory": peaks, "wall_s": walls,
          "nrmse_mean": {k: float(v.mean()) for k, v in nrmse.items()},
          "nrmse_max_gap": float(np.abs(nrmse["streamed"] - nrmse["materialized"]).max())})


def phase_wdm(dev, tasks, card: str) -> dict:
    """WDM ensembles: R = 64 channels of N = 100 on K = 10000 a split, K1
    in its per-lane mode; then the shared readout at R = 8 (F = 801)."""
    import numpy as np
    import torch

    from repro_torch.pipeline import WDMExperiment

    chans = stack([tasks.narma10(20000, seed=r) for r in range(B_MAIN)])
    cfg = stream_config(n_nodes=N_WDM, state_noise_rel=0.0)
    n_chunks = -(-chans[0].shape[1] // STREAM_CHUNK)
    exp_s = WDMExperiment(cfg, B_MAIN, device=dev)
    with solved_grams() as grams:
        reset_counts()
        res_s, stream_s = wall(lambda: exp_s.run(*chans))
        launches = launch_counts()
        check(launches == (2 * n_chunks, 0, n_chunks), f"streamed WDM launches {launches}")
        reset_counts()
        res_m, mat_s = wall(lambda: WDMExperiment(dataclasses.replace(cfg, stream_chunk_k=None),
                                                  B_MAIN, device=dev).run(*chans))
        check(launch_counts() == (2, 1, 0), f"materialized WDM launches {launch_counts()}")
    check(bool(np.all(np.isfinite(res_s.nrmse))), "WDM NRMSE finite")
    vs_materialized = streamed_vs_materialized("WDM", grams, res_s, res_m)

    emit({"phase": "wdm", "card": card, "R": B_MAIN, "N": N_WDM,
          "K_split": chans[0].shape[1], "chunk": STREAM_CHUNK,
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "nrmse_mean": float(res_s.nrmse.mean()), "nrmse_max": float(res_s.nrmse.max()),
          "streamed_vs_materialized": vs_materialized,
          "wall_s": {"streamed": stream_s, "materialized": mat_s}})
    # shared readout: 8 channels (8 masks) observe one NARMA10 stream, one
    # readout over their 801 features; the same fit with the Gram folded by
    # plain matmuls instead of K3.  Both Grams are held to the error bound
    # of an f32 sum against the float64 Gram of the same features.
    r = 8
    tr = np.repeat(chans[0][:1], r, axis=0)
    te = np.repeat(chans[2][:1], r, axis=0)
    shared = {}
    with solved_grams() as grams:
        for name, use_kernel in (("kernel", True), ("plain", False)):
            reset_counts()
            exp = WDMExperiment(dataclasses.replace(cfg, readout_use_kernel=use_kernel), r,
                                shared_readout=True, device=dev)
            res = exp.run(tr, chans[1][0], te, chans[3][0])
            check(launch_counts() == (2 * n_chunks, 0, n_chunks if use_kernel else 0),
                  f"shared readout ({name}) launches {launch_counts()}")
            check(res.readout_w.shape == (1, r * N_WDM + 1) and bool(np.isfinite(res.nrmse).all()),
                  f"shared readout ({name}) {res.readout_w.shape} {res.nrmse}")
            shared[name] = {"nrmse": float(res.nrmse[0]), "lam": float(res.lam[0])}
    x, x_te = shared_features(cfg, exp.masks, tr, te, dev)
    y = torch.as_tensor(chans[1][0][cfg.washout:, None], dtype=torch.float32, device=dev)
    for (g, c, *_), name in zip(grams, ("kernel", "plain")):
        shared[name]["gram_error_vs_bound"] = gram_error_ratio(g[0], c[0], x, y)
    shared["nrmse_gap"] = abs(shared["kernel"]["nrmse"] - shared["plain"]["nrmse"])
    shared["float64_at_kernel_lam"] = f64_ridge(x, y, x_te, chans[3][0],
                                                shared["kernel"]["lam"])
    emit({"phase": "wdm_shared", "card": card, "R": r, "F": r * N_WDM + 1,
          "K_split": chans[0].shape[1], **shared, "tolerance": SHARED_TOL})
    for name in ("kernel", "plain"):
        check(shared[name]["gram_error_vs_bound"] <= 1.0,
              f"shared Gram ({name}) outside the f32 sum's error bound")
    check(shared["nrmse_gap"] <= SHARED_TOL,
          f"shared readout kernel vs plain fold NRMSE {shared['nrmse_gap']}")
    return {"launches": launches, "chans": chans, "cfg": cfg, "masks": exp_s.masks,
            "shared": {"x": x, "y": y, "launches": n_chunks}}


def phase_kernels_line(dev, narma, paths: dict) -> None:
    """Each kernel at the shapes of the path it rides, with that path's
    launch count: K1 at one streamed chunk (broadcast mask, N = 900) and in
    its per-lane mode at one WDM chunk (N = 100); K2 at the main path's
    Gram; K3 at a fold chunk of each path that launches it (streamed
    NARMA10 [64, 256, 901], WDM [64, 256, 101], the shared readout
    [1, 256, 801]), onto the symmetric running stacks K2 made of the chunk
    before, as the fold hands them in.  Each Gram row carries its bound
    share (bound_ms / ms) and its time against one PyTorch call
    (vs_library = ms / library_ms).

    K1 (SiliconMR) is held to its plain version exactly where its paths
    launch it: on chunk 1 of the stream, resumed from the kernel's carry
    after chunk 0 (f32 states and carry; bf16 states the f32 states
    rounded, bitwise, and within half a bf16 ulp of the plain f32 state),
    and on a whole split from a zero state, as the materialized paths
    launch it (NARMA10 [64, 1000, 900], WDM [64, 10000, 100]).
    ``plain_ms`` is the plain version's time on the chunk.  Beside its
    roofline bound, each K1 row has its chain bound (``chain_bound_ms``:
    K·N dependent chain steps at the card's maximum SM clock, each of
    CHAIN_OPS f32 ops at the latency ``chain_cycles`` measures in this run,
    beside the measured cycles of the kernel's own chain step) and the
    lanes a block of its layout."""
    import torch

    from repro_torch.core import generate_states
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.pipeline import with_bias
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    cfg, exp = paths["main"]["cfg"], paths["main"]["exp"]
    model = cfg.model
    tr_in = _canon_batch(narma[0], "inputs_train", dev)
    j_tr, _ = _input_layer(cfg, tr_in, tr_in)
    y_tr = _canon_batch(narma[1], "targets_train", dev)[..., None]
    rows = []
    cycles = chain_cycles(dev)
    clocks = sm_clocks_mhz()

    def scan_row(name, j, mask, launches, path):
        b, k = j.shape
        n = mask.shape[-1]
        zero = torch.zeros((b, n), dtype=torch.float32, device=dev)
        checks = []
        # chunk 1, resumed from the kernel's carry after chunk 0
        _, carry = scan_ops.dfr_scan(model, j[:, :STREAM_CHUNK], mask, zero, return_final=True)
        j1 = j[:, STREAM_CHUNK:2 * STREAM_CHUNK].contiguous()
        out, fin = scan_ops.dfr_scan(model, j1, mask, carry, return_final=True)
        out16 = scan_ops.dfr_scan(model, j1, mask, carry, out_dtype=torch.bfloat16)
        (ref, ref_fin), plain_s = wall(lambda: scan_ops.dfr_scan_plain(model, j1, mask, carry))
        err = max(max_err(out, ref), max_err(fin, ref_fin))
        # rounding an f32 state to bf16 (8 significant bits) moves it by at most
        # 2^-8 of itself
        bf16_excess = float(((out16.float() - ref).abs() - ref.abs() * 2.0 ** -8).max())
        checks.append({"what": "chunk 1 from the carry of chunk 0",
                       "shape_bkn": [b, STREAM_CHUNK, n], "max_abs_err": err,
                       "bf16_err_beyond_half_ulp": bf16_excess, "plain_s": plain_s})
        check(err == 0.0, f"{name} vs plain on a resumed chunk: {err}")
        check(bf16_excess <= 2e-6, f"{name} bf16 states vs plain: {bf16_excess} beyond half an ulp")
        check(torch.equal(out16, out.to(torch.bfloat16)),
              f"{name}: bf16 states are not the f32 states rounded")
        del out, out16, ref
        # the whole split from a zero state
        out = scan_ops.dfr_scan(model, j, mask, zero)
        (ref, _), full_s = wall(lambda: scan_ops.dfr_scan_plain(model, j, mask, zero))
        err_full = max_err(out, ref)
        checks.append({"what": "whole split from zero", "shape_bkn": [b, k, n],
                       "max_abs_err": err_full, "plain_s": full_s})
        check(err_full == 0.0, f"{name} vs plain on a whole split: {err_full}")
        del out, ref
        ms = cuda_ms(lambda: scan_ops.dfr_scan(model, j1, mask, carry), reps=5)
        bound, by = bound_ms(4 * (b * STREAM_CHUNK + mask.numel() + 2 * b * n
                                  + b * STREAM_CHUNK * n),
                             SCAN_OPS_PER_STEP * b * STREAM_CHUNK * n)
        # each lane's K·N steps are one dependent chain, each step at least
        # CHAIN_OPS dependent f32 ops; lanes run side by side
        chain_bound = STREAM_CHUNK * n * cycles["least_step"] / (clocks["max"] * 1e3)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/dfr_scan.cu",
                     "replaces": "src/repro/kernels/dfr_scan/dfr_scan.py:97",
                     "launches": launches, "path": path,
                     "max_abs_err": max(c["max_abs_err"] for c in checks), "ms": ms,
                     "plain_ms": plain_s * 1e3, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "chain_bound_ms": chain_bound,
                     "chain_bound_share": chain_bound / ms, "chain_cycles_per_step": cycles,
                     "sm_clock_mhz": clocks,
                     "lanes_per_block": scan_ops.scan_layout(b, n, mask.ndim == 2).lanes,
                     "shape_bkn": [b, STREAM_CHUNK, n], "checks": checks})

    scan_row("dfr_scan", j_tr, exp.mask, paths["streaming"]["launches"][0],
             "streaming NARMA10, one launch per chunk")
    wdm = paths["wdm"]
    chans = wdm["chans"]
    j_wdm, _ = _input_layer(wdm["cfg"], _canon_batch(chans[0], "inputs_train", dev),
                            _canon_batch(chans[2], "inputs_test", dev))
    scan_row("dfr_scan_per_lane", j_wdm, wdm["masks"], wdm["launches"][0],
             "streaming WDM, one per-lane launch per chunk")

    def gram_row(name, replaces, launches, path, chunks, y_chunks):
        """K2 on ``chunks[0]`` alone, or K3 folding ``chunks[1]`` onto the
        running stacks K2 made of ``chunks[0]`` (symmetric bitwise, as every
        G0 the fold hands in), against the plain version and one PyTorch
        call on the same inputs.  K3 is also held to its plain version from
        a non-symmetric G0 (its full semantics), outside the timing."""
        into = len(chunks) == 2
        x, y = chunks[-1], y_chunks[-1]
        b, t, f = x.shape
        cols = y.shape[-1]
        if into:
            g0, c0 = gram_ops.gram_accumulate_batched(chunks[0], y_chunks[0])
            g, c = gram_ops.gram_accumulate_batched_into(g0.clone(), c0.clone(), x, y,
                                                         round_y=False)
            gp, cp = gram_ops.gram_plain_batched(x, y, g0=g0.clone(), c0=c0.clone(),
                                                 round_y=False)
        else:
            g, c = gram_ops.gram_accumulate_batched(x, y)
            gp, cp = gram_ops.gram_plain_batched(x, y)
        err = max(max_err(g, gp), max_err(c, cp))
        check(torch.allclose(g, gp, rtol=1e-5, atol=1e-4)
              and torch.allclose(c, cp, rtol=1e-5, atol=1e-4),
              f"{name} vs plain at {[b, t, f]}: {err}")
        check(torch.equal(g, g.mT), f"{name}: G is not symmetric bitwise at {[b, t, f]}")
        if into:
            r0 = torch.rand_like(g0)
            rc = torch.rand_like(c0)
            gi, ci = gram_ops.gram_accumulate_batched_into(r0.clone(), rc.clone(), x, y,
                                                           round_y=False)
            gq, cq = gram_ops.gram_plain_batched(x, y, g0=r0.clone(), c0=rc.clone(),
                                                 round_y=False)
            check(torch.allclose(gi, gq, rtol=1e-5, atol=1e-4)
                  and torch.allclose(ci, cq, rtol=1e-5, atol=1e-4),
                  f"{name} from a non-symmetric G0: {max_err(gi, gq)}")
            del r0, rc, gi, ci, gq, cq
            g_run, c_run = g0.clone(), c0.clone()
            ms = cuda_ms(lambda: gram_ops.gram_accumulate_batched_into(
                g_run, c_run, x, y, round_y=False), reps=5)
            g_pl, c_pl = g0.clone(), c0.clone()
            plain_ms = cuda_ms(lambda: gram_ops.gram_plain_batched(
                x, y, g0=g_pl, c0=c_pl, round_y=False), reps=5)
            lib_call, lib_ms = "torch.baddbmm", cuda_ms(lambda: torch.baddbmm(g0, x.mT, x),
                                                        reps=5)
            zeros = torch.zeros_like(g0), torch.zeros_like(c0)
            vs_bound = {"kernel": gram_error_ratio(*gram_ops.gram_accumulate_batched_into(
                            *zeros, x, y, round_y=False), x, y),
                        "plain": gram_error_ratio(*gram_ops.gram_plain_batched(
                            x, y, round_y=False), x, y)}
        else:
            ms = cuda_ms(lambda: gram_ops.gram_accumulate_batched(x, y), reps=5)
            plain_ms = cuda_ms(lambda: gram_ops.gram_plain_batched(x, y), reps=5)
            lib_call, lib_ms = "torch.bmm", cuda_ms(lambda: torch.bmm(x.mT, x), reps=5)
            vs_bound = {"kernel": gram_error_ratio(g, c, x, y),
                        "plain": gram_error_ratio(gp, cp, x, y)}
        # G is symmetric: the function needs F(F+1)/2 dot products over T,
        # plus the F·C of c; accumulate-into also reads G0 and c0 and adds them
        bound, by = bound_ms(4 * (b * t * (f + cols) + (1 + into) * b * f * (f + cols)),
                             b * t * f * (f + 1) + 2 * b * t * f * cols
                             + into * b * (f * (f + 1) // 2 + f * cols))
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/ridge_gram.cu",
                     "replaces": replaces, "launches": launches, "path": path,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms, "library_call": lib_call,
                     "bound_share": bound / ms, "vs_library": ms / lib_ms,
                     "shape_btf": [b, t, f], "g0": "K2 of the chunk before" if into else None,
                     "symmetric_bitwise": True, "error_vs_f32_sum_bound": vs_bound})
        return g

    k2, k3 = ("src/repro/kernels/ridge_gram/ridge_gram.py:118",
              "src/repro/kernels/ridge_gram/ridge_gram.py:147")
    # K2 at the main path's Gram: features [B, T - washout, N + 1]
    states = generate_states(model, j_tr, exp.mask, method="kernel", device=dev)
    g_main = gram_row("ridge_gram", k2, paths["main"]["launches"][1], "materialized NARMA10",
                      [with_bias(states[:, WASHOUT:])], [y_tr[:, WASHOUT:]])
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(g_main), reps=2)
    bb, f = g_main.shape[:2]
    del g_main

    # K3 at the streamed fold's chunk 1 of 256 rows, onto the running stacks
    # of chunk 0: bias-extended states [B, 256, N + 1] and f32 targets
    def two_chunks(st, yy):
        return ([with_bias(st[:, :STREAM_CHUNK]), with_bias(st[:, STREAM_CHUNK:2 * STREAM_CHUNK])],
                [yy[:, :STREAM_CHUNK].contiguous(),
                 yy[:, STREAM_CHUNK:2 * STREAM_CHUNK].contiguous()])

    gram_row("ridge_gram_into", k3, paths["streaming"]["launches"][2],
             "streaming NARMA10, one launch per fit chunk", *two_chunks(states, y_tr))
    del states
    # K3 at the WDM fold's chunk [64, 256, N_WDM + 1] (per-lane states)
    zero_w = torch.zeros((j_wdm.shape[0], N_WDM), dtype=torch.float32, device=dev)
    st_w = scan_ops.dfr_scan(wdm["cfg"].model, j_wdm[:, :2 * STREAM_CHUNK].contiguous(),
                             wdm["masks"], zero_w)
    y_w = _canon_batch(chans[1], "targets_train", dev)[..., None]
    gram_row("ridge_gram_into_wdm", k3, wdm["launches"][2],
             "streaming WDM, one launch per fit chunk", *two_chunks(st_w, y_w))
    del j_wdm, st_w
    # K3 at the shared readout's chunk [1, 256, R·N + 1] (one instance)
    shared = wdm["shared"]
    xs = shared["x"][None, :2 * STREAM_CHUNK]
    ys = shared["y"][None, :2 * STREAM_CHUNK]
    gram_row("ridge_gram_into_shared", k3, shared["launches"],
             "WDM shared readout, one launch per fit chunk",
             [xs[:, :STREAM_CHUNK].contiguous(), xs[:, STREAM_CHUNK:].contiguous()],
             [ys[:, :STREAM_CHUNK].contiguous(), ys[:, STREAM_CHUNK:].contiguous()])
    for row in rows[2:]:
        check(max(row["error_vs_f32_sum_bound"].values()) <= 1.0,
              f"{row['name']} outside the f32 sum's error bound")
    emit({"kernels": rows})
    emit({"phase": "library", "call": "torch.linalg.eigh", "shape": [bb, f, f], "ms": eigh_ms})

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
    streaming = phase_streaming(dev, narma, card)
    phase_long_stream(dev, tasks, card)
    wdm = phase_wdm(dev, tasks, card)
    phase_kernels_line(dev, narma, {"main": main, "streaming": streaming, "wdm": wdm})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
