"""Wrapper for the readout-apply kernel (``kernels/csrc/readout_apply.cu``).

Replaces no TPU kernel.  The JAX package applies a fitted readout to a
chunk of states with ``einsum(..., preferred_element_type=f32)``
(``repro/pipeline/experiment.py:336-337``), which reads bf16 features as
they are.  PyTorch has no bf16 × f32 → f32 matmul, so the port widened each
bf16 chunk's [B, T, N + 1] features to an f32 copy first; this kernel
reads them in their own type.

    y[b, t, c] = Σ_{f<N} x[b, t, f] · w[b, f, c] + w[b, N, c]

``x`` [B, T, N] f32 or bf16, ``w`` [B, N + 1, C] f32 (bias row last; a
``w`` of batch 1 is broadcast over B), ``y`` [B, T, C] f32.

* A CUDA tensor launches the kernel or raises.  Each product is taken in
  f32 and accumulated in f32; the sum runs in another order than the plain
  version's matmul, so the two agree within f32 round-off of the sum.  The
  kernel's order is fixed, so two calls give the same bits.
* A CPU tensor takes ``readout_apply_plain``: ``with_bias(x).to(f32) @ w``,
  the product as the port computed it before the kernel.
* ``apply_plan`` is the kernel's launch plan and ``row_split`` the head /
  16-byte body / tail split of one row, as the kernel computes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _calls

CHUNK_BYTES = 16         # one vector load (uint4)
MAX_GROUP = 16           # lanes a row
LANE_CHUNKS = 4          # chunks a lane a pass, at most
ROWS_BUDGET = 16 * 1024  # bytes of x's chunks a block has in flight

_ENTRY = ("readout_apply", "readout_apply_launch",
          (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def smem_bytes(itemsize: int, seg: int, rows: int, col_block: int) -> int:
    """The shared memory a block takes: w's slice for a pass, transposed,
    [col_block][16 / itemsize][seg + 1] f32 in whole 16 bytes, and x's body
    chunks of the pass, [rows][seg] × 16 bytes (``readout_apply_smem_bytes``)."""
    ws = -(-col_block * (CHUNK_BYTES // itemsize) * (seg + 1) // 4) * 4
    return 4 * ws + rows * seg * CHUNK_BYTES


@functools.lru_cache(maxsize=256)
def apply_plan(b: int, t: int, n: int, c: int, dtype: torch.dtype) -> dict:
    """The kernel's launch plan for x [b, t, n] of ``dtype`` and c target
    columns: ``elems`` a 16-byte chunk; ``group`` lanes a row (half the
    row's chunks rounded up to a power of two, 4 to 16); ``seg`` chunks a
    row a pass (up to 4 a lane) and ``passes`` (every row's body, at any
    alignment, in ``passes · seg`` chunks); ``row_groups`` (1, 2 or 4) and
    ``rows_per_block`` = row_groups · threads / group rows of one instance
    a block, their chunks of a pass within 16 KB; ``threads`` a block (256
    for rows of 64 chunks a pass or more, else 128, so that short rows
    keep more blocks on an SM; ``python -m repro_torch.launch.time_kernels
    --plans`` times the other layouts at the main-path shapes);
    ``col_block`` target columns a sweep (1, or 4 where c > 1);
    ``blocks_per_b`` and ``grid``;
    and, as every kernel's plan (``_calls``), ``smem_bytes`` a block,
    ``row_bytes`` and ``multi_tile`` (no tile of x is staged across a
    block's boundary).  The dict is shared: do not mutate it."""
    item = dtype.itemsize
    elems = CHUNK_BYTES // item
    chunks = n // elems                       # a row's most body chunks
    group = min(MAX_GROUP, max(4, _pow2_at_least(chunks) // 2))
    seg = group * min(LANE_CHUNKS, _pow2_at_least(-(-chunks // group)))
    passes = max(1, -(-chunks // seg))
    threads = 256 if seg >= 64 else 128
    per_group = threads // group
    need = -(-t // per_group)
    row_groups = max([g for g in (4, 2, 1)
                      if g <= need and g * per_group * seg * CHUNK_BYTES <= ROWS_BUDGET] or [1])
    rows = row_groups * per_group
    col_block = 1 if c == 1 else 4
    blocks_per_b = -(-t // rows)
    return {"elems": elems, "group": group, "seg": seg, "passes": passes,
            "row_groups": row_groups, "rows_per_block": rows, "col_block": col_block,
            "blocks_per_b": blocks_per_b, "grid": b * blocks_per_b, "threads": threads,
            "smem_bytes": smem_bytes(item, seg, rows, col_block), "row_bytes": 0,
            "multi_tile": False}


def row_split(n: int, itemsize: int, row_addr: int) -> tuple[int, int, int]:
    """(head, body chunks, tail) of a row of n elements at byte address
    ``row_addr``: the elements before its first 16-byte boundary, the whole
    16-byte chunks after it, and the rest (the kernel's split)."""
    head = min(n, ((CHUNK_BYTES - row_addr % CHUNK_BYTES) % CHUNK_BYTES) // itemsize)
    body = (n - head) // (CHUNK_BYTES // itemsize)
    return head, body, n - head - body * (CHUNK_BYTES // itemsize)


def readout_apply_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the bias-extended features widened to f32,
    times ``w``: y [B, T, C] f32."""
    ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1).to(torch.float32) @ w


def _launch(x: torch.Tensor, w: torch.Tensor, plan: dict) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the readout-apply kernel reads float32 or bfloat16 features, "
                         f"not {x.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"the readout-apply kernel takes float32 weights, not {w.dtype}")
    b, t, n = x.shape
    cols = w.shape[-1]
    xc, wc = x.contiguous(), w.contiguous()
    y = torch.empty((b, t, cols), dtype=torch.float32, device=x.device)
    if b and t and cols:
        err = _build.launch(
            _build.entry(*_ENTRY), x.device, xc.data_ptr(), int(x.dtype == torch.bfloat16),
            wc.data_ptr(), y.data_ptr(), b, t, n, cols,
            0 if wc.shape[0] == 1 else (n + 1) * cols, plan["group"].bit_length() - 1,
            plan["seg"], plan["row_groups"], plan["col_block"], plan["threads"],
            plan["blocks_per_b"], plan["grid"], plan["passes"], plan["smem_bytes"])
        _build.check(err, "readout_apply")
        readout_apply.launches += 1
    return y


def _plain(x: torch.Tensor, w: torch.Tensor, plan: dict) -> torch.Tensor:
    return readout_apply_plain(x, w)


def readout_apply(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y [B, T, C] f32 = the bias-extended features ``x`` [B, T, N] times the
    readout ``w`` [B or 1, N + 1, C]."""
    if x.ndim != 3 or w.ndim != 3 or w.shape[1] != x.shape[-1] + 1:
        raise ValueError(f"expected x [B, T, N] and w [B, N + 1, C], got {tuple(x.shape)} / "
                         f"{tuple(w.shape)}")
    if w.shape[0] not in (1, x.shape[0]):
        raise ValueError(f"w's batch {w.shape[0]} is neither 1 nor x's batch {x.shape[0]}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if x.device.type == "cuda":
        run = _launch
    elif x.device.type == "cpu":
        run = _plain
    else:
        raise ValueError(f"readout_apply runs on cuda or cpu tensors, not {x.device}")
    plan = apply_plan(*x.shape, w.shape[-1], x.dtype)
    if not (x.shape[0] and x.shape[1]):
        return run(x, w, plan)
    return _calls.call(_COUNTERS, "readout_apply", plan, run, x, w, plan)


readout_apply.launches = 0   # kernel launches (plain-version calls are not counted)
readout_apply.calls = 0      # calls on either route (``_calls``)
_COUNTERS = readout_apply    # the counters' owner, should a test rebind the module's name
