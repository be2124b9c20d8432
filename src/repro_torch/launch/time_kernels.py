"""Time a kernel call on the card: device time warm and with L2 cold, and
the host's time a call through the wrapper.

    PYTHONPATH=src python -m repro_torch.launch.time_kernels [--parent DIR] [--plans] [--out FILE]

``kernel_times(fn, reps)`` gives three times of one call of ``fn``:

* ``ms``: device time.  CUDA events around ``reps`` calls, enqueued while
  the device spins (``torch.cuda._sleep``) for longer than the host takes
  to enqueue them, so the events time the device and not the enqueue.
* ``cold_ms``: the same with L2 flushed before each call, each call
  between its own pair of events, as a caller finds a cold cache.  The
  flush reads a 128 MB buffer (the card's L2 holds 50 MB): a flush that
  writes leaves L2 full of dirty lines, whose write-back the timed call
  would then pay.  A pair of events around one call also times the
  launch's start and drain, which calls back to back overlap.
* ``call_ms``: host wall time a call through the wrapper, over ``reps``
  calls ending in one synchronise: what a host-bound loop pays.

``host_ahead`` says whether the host finished enqueuing before the device
finished its spin in both timed loops (else the device waited and the
times count host time).  ``chip_smoke.py``'s kernels line times every row with
it.

The command times the block copy, the readout apply, the adjoint scan
K1ᵀ, K1 at the LM's decode shape and K1's MackeyGlass form at the Fig. 5/6
splits ([64, 1000, 900] and [64, 6000, 400], with its chain bound and the
sha256 of its states' and final state's bytes, so that two checkouts'
outputs compare bit for bit), at the shapes of the paths they ride
(the ``contracts`` fixture's [2048, 1024] f32 with a 32 × 256 tile; the
bf16 streamed evaluation's [64, 256, 900] and the serving tick's
[4096, 32, 64] f32, C = 1; the LM train step's [24, 512, 256], beta 0 and
0.5, where a checkout has K1ᵀ; decode's [24, 1, 256]), beside their byte
bounds and
the PyTorch call that computes the same (``x.clone()``,
``torch.baddbmm`` on features already f32) and, for the readout, PyTorch's
row sums of the features (``x.sum(-1)``: one read of the same bytes).  With ``--parent DIR`` (a
checkout of another commit, e.g. ``git archive <commit> | tar -x -C DIR``)
it times DIR's kernels too, each checkout in a process of its own that
builds its own sources, in turns parent, this, this, parent.  With
``--plans`` it also times the readout kernel under other layouts than its
launch plan picks, K1ᵀ under every lanes a block and handoff group
(``adjoint_variants``), and the block copy's SIMT route where the wrapper
takes TMA (``plan_variants``).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

FLUSH_BYTES = 128 * 2 ** 20
SPIN_CYCLES_PER_MS = 2.0e6     # at most the H100's 1980 MHz: a spin lasts at least its ms
PEAK_HBM_BYTES = 3.35e12       # H100 SXM (NVIDIA's data sheet)


def _spin(ms: float) -> None:
    torch.cuda._sleep(int(ms * SPIN_CYCLES_PER_MS))


def _spun(loop, enqueue_ms: float) -> bool:
    """Run ``loop`` behind a device spin; True if the host finished
    enqueuing it before the spin ended.  The spin is sized from
    ``enqueue_ms``, and doubled up to twice more while the host falls
    behind (a first use of a kernel or an event can be slow)."""
    spin_ms = 2.0 * enqueue_ms + 0.2
    for _ in range(3):
        torch.cuda.synchronize()
        _spin(spin_ms)
        t0 = time.perf_counter()
        loop()
        if (time.perf_counter() - t0) * 1e3 < spin_ms:
            return True
        spin_ms *= 4.0
    return False


def kernel_times(fn, reps: int = 20, *, cold: bool = True) -> dict:
    """``{"ms", "cold_ms", "call_ms", "host_ahead"}`` of one call of ``fn``
    (see the module's docstring); ``cold=False`` skips ``cold_ms``."""
    fn()                                               # warm-up, and a first call's build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    out = {"call_ms": (time.perf_counter() - t0) * 1e3 / reps}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def warm():
        start.record()
        for _ in range(reps):
            fn()
        end.record()

    ahead = _spun(warm, enqueue_ms)
    end.synchronize()
    out["ms"] = start.elapsed_time(end) / reps
    if cold:
        flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        pairs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                 for _ in range(reps)]

        def flushed():
            for a, b in pairs:
                flush.sum()
                a.record()
                fn()
                b.record()

        ahead = _spun(flushed, 2.0 * enqueue_ms) and ahead
        torch.cuda.synchronize()
        out["cold_ms"] = sum(a.elapsed_time(b) for a, b in pairs) / reps
        del flush
    out["host_ahead"] = ahead
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _rows(reps: int) -> list[dict]:
    """The two kernels at their paths' shapes, with the library call."""
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.readout_apply import ops as apply_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = []
    for name, (b, t, n), dtype in (("readout_apply", (64, 256, 900), torch.bfloat16),
                                   ("readout_apply_serving", (4096, 32, 64), torch.float32)):
        x = torch.rand((b, t, n), generator=gen, device=dev).to(dtype)
        w = torch.randn((b, n + 1, 1), generator=gen, device=dev) / 30.0
        out = apply_ops.readout_apply(x, w)
        ref = apply_ops.readout_apply_plain(x, w)
        scale = torch.cat([x, torch.ones_like(x[..., :1])], -1).float().abs() @ w.abs()
        xf = x.float()
        n_bytes = x.numel() * x.element_size() + 4 * (w.numel() + out.numel())
        rows.append({"name": name, "shape": [b, t, n], "dtype": str(dtype).removeprefix("torch."),
                     "rel_err_of_sum_magnitude": float(((out - ref).abs() / scale).max()),
                     "bitwise_two_calls": bool(torch.equal(out, apply_ops.readout_apply(x, w))),
                     "bound_ms": n_bytes / PEAK_HBM_BYTES * 1e3,
                     **kernel_times(lambda: apply_ops.readout_apply(x, w), reps),
                     "library": kernel_times(lambda: torch.baddbmm(w[:, n:], xf, w[:, :n]),
                                             reps),
                     # one read of the features and nothing else: PyTorch's row sums
                     "read_floor": kernel_times(lambda: x.sum(-1), reps)})
    rows += _adjoint_rows(dev, gen, reps)
    rows.append(_decode_row(dev, gen, reps))
    rows += _mg_rows(dev, reps)
    x = torch.randn((2048, 1024), generator=gen, device=dev)
    tile = (32, 256)
    out = copy_ops.block_copy(x, tile)
    rows.append({"name": "block_copy", "shape": [2048, 1024], "tile": list(tile),
                 "route": getattr(copy_ops.block_copy, "last_route", None),
                 "bitwise": bool(torch.equal(out, x)),
                 "bound_ms": 2 * x.numel() * 4 / PEAK_HBM_BYTES * 1e3,
                 **kernel_times(lambda: copy_ops.block_copy(x, tile), reps),
                 "library": kernel_times(lambda: x.clone(), reps)})
    return rows


def _adjoint_inputs(dev, gen, b: int, k: int = 512, n: int = 256):
    """K1ᵀ's inputs at the LM train step's shape: K1's own f32 states of
    SiliconMR with the mixer's mask, a normal gradient of the states, and
    the model at beta 0 and 0.5 (TPA saturation)."""
    import dataclasses

    from repro_torch.core import SiliconMR, make_mask
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    model = SiliconMR()
    j = torch.rand((b, k), generator=gen, device=dev)
    s0 = torch.zeros((b, n), device=dev)
    mask = make_mask(n, seed=1, device=dev)
    states = scan_ops.dfr_scan(model, j, mask, s0)
    g = torch.randn((b, k, n), generator=gen, device=dev)
    g_fin = torch.zeros((b, n), device=dev)
    models = {0.0: model, 0.5: dataclasses.replace(model, beta_tpa=0.5)}
    return models, (j, mask, s0, states, g, g_fin)


def _adjoint_rows(dev, gen, reps: int) -> list[dict]:
    """K1ᵀ at the LM train step's [24, 512, 256], beta 0 (the mixer's form)
    and 0.5, where this checkout has it; its outputs' checksums let two
    checkouts be compared."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    if not hasattr(scan_ops, "dfr_scan_grad"):
        return []
    b, k, n = 24, 512, 256
    models, args = _adjoint_inputs(dev, gen, b, k, n)
    n_bytes = 4 * (2 * b * k * n + 2 * b * k + 3 * b * n + n)
    rows = []
    for beta, model in models.items():
        dj, ds0 = scan_ops.dfr_scan_grad(model, *args)
        rows.append({"name": "dfr_scan_grad" if beta == 0 else f"dfr_scan_grad_beta{beta}",
                     "shape": [b, k, n], "beta": beta,
                     "dj_sum": float(dj.double().sum()), "ds0_sum": float(ds0.double().sum()),
                     "bound_ms": n_bytes / PEAK_HBM_BYTES * 1e3,
                     **kernel_times(lambda m=model: scan_ops.dfr_scan_grad(m, *args), reps)})
    return rows


def _decode_row(dev, gen, reps: int) -> dict:
    """K1 at the LM decode step's [24, 1, 256] (one token a step, f32), the
    shape where the host's time a call (``call_ms``) outweighs the
    device's."""
    from repro_torch.core import SiliconMR, make_mask
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    b, n = 24, 256
    j = torch.rand((b, 1), generator=gen, device=dev)
    s0 = torch.rand((b, n), generator=gen, device=dev)
    mask = make_mask(n, seed=1, device=dev)
    model = SiliconMR()
    return {"name": "dfr_scan_lm_decode", "shape": [b, 1, n],
            **kernel_times(lambda: scan_ops.dfr_scan(model, j, mask, s0, return_final=True),
                           reps)}


def _mg_step_cycles(dev) -> float:
    """Cycles of MackeyGlass's chain step (a mul and an add) on the card:
    ``dfr_scan_chain_probe`` form 3, one thread, 2^20 dependent steps, the
    least of three runs."""
    import ctypes

    from repro_torch.core import MackeyGlass
    from repro_torch.kernels import _build

    fn = _build.load("dfr_scan").dfr_scan_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = list(MackeyGlass().kernel_spec()[1])
    # 8 inputs u, 8 chain-free values, s0, then the 16 constants
    x = torch.tensor([0.5] * 8 + [0.1] * 8 + [0.1] + consts + [0.0] * (16 - len(consts)),
                     dtype=torch.float32, device=dev)
    last = torch.empty(1, dtype=torch.float32, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    steps, runs = 1 << 20, []
    for _ in range(3):
        _build.check(fn(3, x.data_ptr(), last.data_ptr(), cyc.data_ptr(), steps,
                        torch.cuda.current_stream(dev).cuda_stream), "dfr_scan_chain_probe")
        torch.cuda.synchronize(dev)
        runs.append(int(cyc.item()) / steps)
    return min(runs)


def _sha256(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def _mg_rows(dev, reps: int) -> list[dict]:
    """K1's MackeyGlass form at the Fig. 5/6 splits ([64, 1000, 900] and
    [64, 6000, 400], from a zero state, ±1 mask) on seeded inputs: its three
    times, its chain bound (K·N MackeyGlass chain steps at the card's
    maximum SM clock) and the sha256 of its f32 states' and final state's
    bytes, which show two checkouts' bits equal.  At most 5 timed calls a
    loop (the chain route takes 0.4 s a call)."""
    from repro_torch.core import MackeyGlass
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    model = MackeyGlass()
    route = getattr(scan_ops, "scan_route", lambda m: "chain")(model)
    cycles = _mg_step_cycles(dev)
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True).stdout.split()[0])
    rows = []
    for name, (b, k, n) in (("dfr_scan_mg_narma10", (64, 1000, 900)),
                            ("dfr_scan_mg_channel_eq", (64, 6000, 400))):
        gen = torch.Generator(device=dev).manual_seed(30 + n)
        j = torch.rand((b, k), generator=gen, device=dev) - 0.5
        mask = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        s0 = torch.zeros((b, n), device=dev)
        states, fin = scan_ops.dfr_scan(model, j, mask, s0, return_final=True)
        digests = {"states_sha256": _sha256(states), "fin_sha256": _sha256(fin)}
        del states, fin
        t = kernel_times(lambda: scan_ops.dfr_scan(model, j, mask, s0), min(reps, 5))
        chain = k * n * cycles / (clock * 1e3)
        rows.append({"name": name, "shape": [b, k, n], "kernel_route": route, **digests,
                     "chain_bound_ms": chain, "chain_bound_share": chain / t["ms"],
                     "mg_step_cycles": cycles, "sm_clock_max_mhz": clock, **t})
    return rows


def _launch_with(plan: dict, x, w, y):
    """A call of the readout-apply kernel with ``plan``'s layout (group,
    threads, row groups, seg) in place of ``apply_plan``'s."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.readout_apply import ops as apply_ops

    b, t, n = x.shape
    c = w.shape[-1]
    rows = plan["row_groups"] * plan["threads"] // plan["group"]
    per_b = -(-t // rows)
    smem = apply_ops.smem_bytes(x.element_size(), plan["seg"], rows, plan["col_block"])
    passes = max(1, -(-(n // (16 // x.element_size())) // plan["seg"]))
    fn = _build.entry(*apply_ops._ENTRY)

    def call():
        _build.check(fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), y.data_ptr(),
                        b, t, n, c, (n + 1) * c, plan["group"].bit_length() - 1, plan["seg"],
                        plan["row_groups"], plan["col_block"], plan["threads"], per_b, b * per_b,
                        passes, smem, torch.cuda.current_stream().cuda_stream), "readout_apply")
    return call


def plan_variants(reps: int) -> list[dict]:
    """The readout-apply kernel at its two main-path shapes under other
    layouts than ``apply_plan`` picks (lanes a row, threads a block, row
    groups, chunks a row a pass); and the block copy's SIMT route at the
    fixture's tile (checked bitwise), where the
    wrapper takes TMA.  What ``apply_plan``'s and ``copy_route``'s choices
    rest on."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.readout_apply import ops as apply_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    out = []
    for (b, t, n), dtype, layouts in (
            ((64, 256, 900), torch.bfloat16,
             ((16, 256, 1, 64), (16, 256, 1, 128), (32, 256, 1, 128), (16, 128, 2, 64),
              (16, 256, 2, 64), (8, 128, 2, 32))),
            ((4096, 32, 64), torch.float32,
             ((8, 128, 2, 16), (8, 256, 1, 16), (16, 256, 2, 16), (4, 128, 1, 16),
              (16, 128, 2, 16)))):
        x = torch.rand((b, t, n), generator=gen, device=dev).to(dtype)
        w = torch.randn((b, n + 1, 1), generator=gen, device=dev) / 30.0
        chosen = apply_ops.apply_plan(b, t, n, 1, dtype)
        for group, threads, row_groups, seg in layouts:
            plan = {"group": group, "threads": threads, "row_groups": row_groups, "seg": seg,
                    "col_block": 1}
            y = torch.empty((b, t, 1), device=dev)
            out.append({"kernel": "readout_apply", "shape": [b, t, n],
                        "dtype": str(dtype).removeprefix("torch."), **plan,
                        "chosen": all(chosen[k] == v for k, v in plan.items()),
                        **kernel_times(_launch_with(plan, x, w, y), reps)})
    out += adjoint_variants(dev, gen, reps)
    x = torch.randn((2048, 1024), generator=gen, device=dev)
    tile = (32, 256)
    y = torch.empty_like(x)
    fn = _build.entry(*copy_ops._ENTRY)
    for route, vec, box in (("tma", 0, copy_ops.tma_boxes(tile, 4)), ("simt", 16, (0, 0))):
        def call(route=route, vec=vec, box=box):
            _build.check(fn(x.data_ptr(), y.data_ptr(), 4, 2048, 1024, *tile,
                            tile[0] * tile[1] * 4, copy_ops._ROUTE_CODE[route], vec, *box,
                            torch.cuda.current_stream().cuda_stream), "block_copy")
        call()
        torch.cuda.synchronize()
        out.append({"kernel": "block_copy", "shape": [2048, 1024], "tile": list(tile),
                    "route": route, "bitwise": bool(torch.equal(y, x)),
                    **kernel_times(call, reps)})
    return out


def adjoint_variants(dev, gen, reps: int) -> list[dict]:
    """K1ᵀ at the LM's [24, 512, 256] and at B = 64 under every lanes a
    block of ``grad_layout`` (1, 2, 4, 8) and both handoff groups (64, 128
    nodes), beta 0 and 0.5, each checked bitwise against the layout the
    wrapper picks: what that choice rests on."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    out = []
    for b in (24, 64):
        models, args = _adjoint_inputs(dev, gen, b)
        n = args[1].shape[0]
        for beta, model in models.items():
            consts = scan_ops.grad_constants(model)
            want = scan_ops.dfr_scan_grad(model, *args)
            chosen = scan_ops.grad_layout(b, n)
            for lanes in (1, 2, 4, 8):
                for group in (64, 128):
                    lay = scan_ops._grad_layout(b, n, lanes)
                    lay = lay._replace(group=group, smem_bytes=scan_ops.grad_smem_bytes(
                        lay.lanes, n, lay.depth, group))
                    got = scan_ops._grad_launch(*args, consts, lay)
                    out.append({"kernel": "dfr_scan_grad", "shape": [b, args[0].shape[1], n],
                                "beta": beta, **lay._asdict(), "chosen": lay == chosen,
                                "bitwise": all(torch.equal(x, y) for x, y in zip(got, want)),
                                **kernel_times(lambda m=lay: scan_ops._grad_launch(
                                    *args, consts, m), reps, cold=False)})
    return out


def _worker(reps: int) -> None:
    import repro_torch

    print(json.dumps({"checkout": str(Path(repro_torch.__file__).resolve().parents[2]),
                      "card": _card(), "torch": torch.__version__, "rows": _rows(reps)}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to time too")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the results here (JSON lines)")
    ap.add_argument("--plans", action="store_true",
                    help="also time the readout kernel and K1ᵀ under other layouts and the copy's "
                         "SIMT route at the fixture's tile (this checkout only)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels needs a GPU", file=sys.stderr)
        return 2
    if args.worker:
        _worker(args.reps)
        return 0
    here = Path(__file__).resolve().parents[3]
    order = [here] if args.parent is None else [Path(args.parent).resolve(), here, here,
                                                  Path(args.parent).resolve()]
    results = []
    for checkout in order:
        env = {**os.environ, "PYTHONPATH": str(checkout / "src")}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               "--reps", str(args.reps)], env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if args.plans:
        results.append({"checkout": str(here), "card": _card(),
                        "plan_variants": plan_variants(args.reps)})
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
