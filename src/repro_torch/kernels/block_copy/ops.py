"""Wrapper for the tiled block copy (``kernels/csrc/block_copy.cu``).

Port of ``_copy_kernel_program`` (``tests/test_analysis.py:251``), the
fixture of the JAX contract checker's ``VmemBudget`` tests: a kernel that
copies a 2-D array one block at a time, with the block shape given.  It is
the subject of the port checker's ``SmemBudget`` tests
(``repro_torch.analysis.rules``), and is simple on purpose.

* ``copy_plan`` is its launch plan: a block stages one tile in dynamic
  shared memory (tile rows × tile columns × itemsize bytes), a staged row
  is tile columns × itemsize bytes, and the array spans several tiles
  unless the tile covers it.
* A CUDA tensor launches the kernel, or raises: above ``SMEM_PER_BLOCK``
  before the launch.
* A CPU tensor takes ``block_copy_plain``: the same copy, tile by tile.

Every element's bits are copied, so the kernel is bitwise its plain
version for every dtype.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, _calls
from ..dfr_scan.ops import SMEM_PER_BLOCK

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
    out = torch.empty_like(xc)
    fn = _build.load("block_copy").block_copy_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xc.data_ptr(), out.data_ptr(), xc.element_size(), xc.shape[0], xc.shape[1],
                 tile[0], tile[1], plan["smem_bytes"], stream)
    _build.check(err, "block_copy")
    block_copy.launches += 1
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


block_copy.launches = 0   # kernel launches (plain-version calls are not counted)
block_copy.calls = 0      # calls on either route (``_calls``)
_COUNTERS = block_copy    # the counters' owner, should a test rebind the module's name
