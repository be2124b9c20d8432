"""Wrapper for the tiled block copy (``kernels/csrc/block_copy.cu``).

Port of ``_copy_kernel_program`` (``tests/test_analysis.py:251``), the
fixture of the JAX contract checker's ``VmemBudget`` tests: a kernel that
copies a 2-D array one block at a time, with the block shape given.  It is
the subject of the port checker's ``SmemBudget`` tests
(``repro_torch.analysis.rules``).

* ``copy_plan`` is its launch plan: a block stages one tile in dynamic
  shared memory (tile rows × tile columns × itemsize bytes), a staged row
  is tile columns × itemsize bytes, and the array spans several tiles
  unless the tile covers it.
* ``copy_route`` picks the kernel's route before the launch, from the
  shapes and the pointer: ``tma`` (Hopper's tile copy engine, boxes from
  ``tma_boxes``) where its conditions hold, else ``simt`` (vectors of the
  widest width the row bytes and the pointer allow).
* A CUDA tensor launches the chosen route, or raises: above
  ``SMEM_PER_BLOCK`` before the launch, or when the launch fails.
* A CPU tensor takes ``block_copy_plain``: the same copy, tile by tile.

Every element's bits are copied, so the kernel is bitwise its plain
version for every dtype, on either route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, _calls
from ..dfr_scan.ops import SMEM_PER_BLOCK

TMA_BOX_MAX = 256        # elements a box dimension
TMA_ALIGN = 16           # bytes: base pointers, a row of the array, a box row
TMA_SLOT_ALIGN = 128     # bytes: a box's slot in shared memory
BARRIER_BYTES = 8        # the TMA route's mbarrier, after the tile

_ENTRY = ("block_copy", "block_copy_launch",
          (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
_ROUTE_CODE = {"simt": 0, "tma": 1}


def _tile(x: torch.Tensor, tile) -> tuple[int, int]:
    if x.ndim != 2:
        raise ValueError(f"block_copy copies a 2-D array, got {tuple(x.shape)}")
    th, tw = (int(v) for v in tile)
    if th < 1 or tw < 1:
        raise ValueError(f"tile must be two positive ints, got {tuple(tile)}")
    return th, tw


def copy_plan(shape, dtype: torch.dtype, tile) -> dict:
    """The launch plan for copying a ``shape`` array of ``dtype`` in tiles
    of ``tile`` (rows, columns): a block's dynamic shared memory, the bytes
    of a staged row, and whether the array spans several tiles."""
    item = torch.empty((), dtype=dtype).element_size()
    th, tw = tile
    return {"smem_bytes": th * tw * item, "row_bytes": tw * item,
            "multi_tile": th < shape[0] or tw < shape[1]}


def _largest_divisor(n: int, most: int, step: int = 1) -> int:
    """The largest multiple of ``step`` that divides n and is at most
    ``most`` (``step`` divides n)."""
    return max(d for d in range(step, min(n, most) + 1, step) if n % d == 0)


def tma_boxes(tile, itemsize: int) -> tuple[int, int]:
    """The TMA box (rows, columns) a tile is cut into: the largest divisors
    of the tile's sides up to 256 elements, a box row whole 16-byte units
    (the tile's row must be)."""
    th, tw = tile
    return _largest_divisor(th, TMA_BOX_MAX), _largest_divisor(
        tw, TMA_BOX_MAX, TMA_ALIGN // min(itemsize, TMA_ALIGN))


@functools.lru_cache(maxsize=256)
def _route(shape, itemsize: int, tile, ptr_mod: int) -> dict:
    rows, cols = shape
    th, tw = tile
    tile_bytes = th * tw * itemsize
    if (ptr_mod == 0 and cols * itemsize % TMA_ALIGN == 0 and tw * itemsize % TMA_ALIGN == 0
            and tile_bytes + BARRIER_BYTES <= SMEM_PER_BLOCK):
        box = tma_boxes(tile, itemsize)
        one_box = box == (th, tw)
        if one_box or box[0] * box[1] * itemsize % TMA_SLOT_ALIGN == 0:
            return {"route": "tma", "box": box, "vec_bytes": 0}
    vec = max(v for v in (16, 8, 4, 2, 1)
              if ptr_mod % v == 0 and cols * itemsize % v == 0 and tw * itemsize % v == 0)
    return {"route": "simt", "box": (0, 0), "vec_bytes": vec}


def copy_route(shape, dtype: torch.dtype, tile, data_ptr: int) -> dict:
    """The kernel's route for copying a ``shape`` array of ``dtype`` at
    ``data_ptr`` in ``tile``s: ``{"route": "tma", "box": (rows, cols)}``
    where the base pointer is 16-byte aligned, a row of the array and of
    the tile are whole 16-byte units, the tile and its mbarrier fit a
    block's shared memory and each box's slot starts at a multiple of 128
    bytes; else ``{"route": "simt", "vec_bytes": v}``, the widest vector
    that divides the pointer and both rows.  The output, from
    ``torch.empty``, is aligned as far as any route needs."""
    return _route(tuple(int(s) for s in shape), dtype.itemsize, tuple(tile),
                  int(data_ptr) % TMA_ALIGN)


def block_copy_plain(x: torch.Tensor, tile) -> torch.Tensor:
    """Plain PyTorch version: the copy, one tile at a time."""
    th, tw = _tile(x, tile)
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[0], th):
        for c0 in range(0, x.shape[1], tw):
            out[r0:r0 + th, c0:c0 + tw] = x[r0:r0 + th, c0:c0 + tw]
    return out


def _launch(x: torch.Tensor, tile, plan: dict) -> torch.Tensor:
    if plan["smem_bytes"] > SMEM_PER_BLOCK:
        raise ValueError(f"block_copy: a {tile[0]} x {tile[1]} tile of {x.dtype} takes "
                         f"{plan['smem_bytes']} B of shared memory, above the "
                         f"{SMEM_PER_BLOCK} B a block may use")
    xc = x.contiguous()
    route = copy_route(xc.shape, xc.dtype, tile, xc.data_ptr())
    out = torch.empty_like(xc)
    err = _build.launch(_build.entry(*_ENTRY), x.device, xc.data_ptr(), out.data_ptr(),
                        xc.element_size(), xc.shape[0], xc.shape[1], tile[0], tile[1],
                        plan["smem_bytes"], _ROUTE_CODE[route["route"]], route["vec_bytes"],
                        *route["box"])
    _build.check(err, f"block_copy ({route['route']} route)")
    block_copy.launches += 1
    block_copy.last_route = route["route"]
    return out


def _plain(x: torch.Tensor, tile, plan: dict) -> torch.Tensor:
    return block_copy_plain(x, tile)


def block_copy(x: torch.Tensor, tile) -> torch.Tensor:
    """A copy of the 2-D ``x``, one ``tile`` (rows, columns) a block."""
    tile = _tile(x, tile)
    if x.device.type == "cuda":
        run = _launch
    elif x.device.type == "cpu":
        run = _plain
    else:
        raise ValueError(f"block_copy runs on cuda or cpu tensors, not {x.device}")
    if x.numel() == 0:
        return x.clone()
    plan = copy_plan(tuple(x.shape), x.dtype, tile)
    return _calls.call(_COUNTERS, "block_copy", plan, run, x, tile, plan)


block_copy.launches = 0      # kernel launches (plain-version calls are not counted)
block_copy.calls = 0         # calls on either route (``_calls``)
block_copy.last_route = None  # the route of the last launch ("tma" or "simt")
_COUNTERS = block_copy       # the counters' owner, should a test rebind the module's name
