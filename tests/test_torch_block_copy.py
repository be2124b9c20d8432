"""The block copy's route choice and TMA boxes
(``repro_torch.kernels.block_copy``), checked on the CPU.

The wrapper picks the kernel's route before the launch, from the shapes
and the base pointer: TMA exactly where a 2-D tensor map can move the
tile (16-byte aligned pointer, a row of the array and of the tile whole
16-byte units, the tile and its 8-byte mbarrier within a block's shared
memory, each box's shared-memory slot at a multiple of 128 bytes), else
the SIMT copy with the widest vector the pointer and both rows allow.
The card
tests (tests/test_torch_cuda.py) run both routes; here the choice and the
boxes are held to the conditions, and the boxes a block issues, at the
array's edges too, are shown to cover its tile exactly once.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.block_copy import ops
from repro_torch.kernels.dfr_scan.ops import SMEM_PER_BLOCK

DTYPES = (torch.uint8, torch.bfloat16, torch.float32, torch.int64)


def _tma_conditions(shape, item, tile, ptr):
    """Pointer and rows whole 16-byte units, and the tile with its 8-byte
    mbarrier within a block's shared memory."""
    rows, cols = shape
    th, tw = tile
    return (ptr % 16 == 0 and cols * item % 16 == 0 and tw * item % 16 == 0
            and th * tw * item + 8 <= SMEM_PER_BLOCK)


def _cases():
    shapes = ((2048, 1024), (37, 101), (5, 7), (100, 200), (600, 96), (64, 1024), (454, 512))
    tiles = ((32, 256), (8, 33), (5, 7), (16, 8), (300, 32), (8, 512), (227, 256), (16, 64),
             (257, 4), (1, 1))
    return itertools.product(shapes, DTYPES, tiles, (0, 2, 4, 8))


def test_copy_route_is_tma_exactly_where_its_conditions_hold():
    for shape, dtype, tile, ptr in _cases():
        if ptr % dtype.itemsize:
            continue                            # a tensor is aligned to its element
        item = dtype.itemsize
        route = ops.copy_route(shape, dtype, tile, 4096 + ptr)
        if route["route"] == "tma":
            assert _tma_conditions(shape, item, tile, ptr), (shape, dtype, tile, ptr)
            th, tw = tile
            bh, bw = route["box"]
            assert (bh, bw) == (th, tw) or bh * bw * item % 128 == 0
        else:
            assert route["route"] == "simt"
            vec = route["vec_bytes"]
            assert ptr % vec == 0 and shape[1] * item % vec == 0 and tile[1] * item % vec == 0
            # the widest such vector
            assert all(ptr % v or shape[1] * item % v or tile[1] * item % v
                       for v in (16, 8, 4, 2) if v > vec)
            if _tma_conditions(shape, item, tile, ptr):
                # only a box slot off a 128-byte multiple keeps it off TMA
                bh, bw = ops.tma_boxes(tile, item)
                assert (bh, bw) != tuple(tile) and bh * bw * item % 128


@pytest.mark.parametrize("tile,dtype,route", [
    ((32, 256), torch.float32, "tma"),          # the contracts fixture's tile
    ((8, 512), torch.float32, "tma"),           # wider than a box: two boxes a row
    ((300, 32), torch.float32, "tma"),          # taller than a box: 150-row boxes
    ((16, 64), torch.bfloat16, "tma"),
    ((227, 256), torch.float32, "simt"),        # fills the block's last bytes, no mbarrier
    ((226, 256), torch.float32, "tma"),
    ((8, 33), torch.float32, "simt"),           # 132-byte tile rows
])
def test_copy_route_at_the_card_tests_tiles(tile, dtype, route):
    shape = (2 * tile[0] + 3, 2 * tile[1] + (16 // dtype.itemsize))
    assert ops.copy_route(shape, dtype, tile, 1 << 20)["route"] == route
    # a base pointer off 16 bytes always takes the SIMT copy
    off = ops.copy_route(shape, dtype, tile, (1 << 20) + dtype.itemsize)
    assert off["route"] == "simt" and off["vec_bytes"] == dtype.itemsize


@pytest.mark.parametrize("tile,item", [((32, 256), 4), ((8, 512), 4), ((300, 32), 4),
                                       ((16, 8), 2), ((257, 1024), 1), ((600, 600), 2),
                                       ((5, 14), 8)])
def test_tma_boxes_cover_a_tile_exactly_once(tile, item):
    th, tw = tile
    bh, bw = ops.tma_boxes(tile, item)
    assert 1 <= bh <= 256 and 1 <= bw <= 256 and bw * item % 16 == 0
    assert th % bh == 0 and tw % bw == 0
    cover = np.zeros(tile, dtype=np.int64)
    slots = set()
    per_row = tw // bw
    for i in range(th // bh):
        for j in range(tw // bw):
            cover[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] += 1
            slots.add((i * per_row + j) * bh * bw * item)
    assert (cover == 1).all()
    assert max(slots) + bh * bw * item == th * tw * item      # the boxes fill the staged tile


@pytest.mark.parametrize("shape,tile", [((100, 200), (32, 48)), ((600, 96), (300, 32)),
                                        ((64, 1030), (8, 512)), ((2048, 1024), (32, 256))])
def test_tma_boxes_a_block_issues_cover_the_array_once(shape, tile):
    """As block_copy_tma issues them: at the ragged right and bottom edges a
    block issues only the boxes that start inside the array (TMA clips
    what they cover beyond it), and the blocks' boxes, clipped, cover every
    element of the array exactly once."""
    rows, cols = shape
    th, tw = tile
    bh, bw = ops.tma_boxes(tile, 4)
    cover = np.zeros(shape, dtype=np.int64)
    for r0 in range(0, rows, th):
        for c0 in range(0, cols, tw):
            n_r = -(-min(th, rows - r0) // bh)
            n_c = -(-min(tw, cols - c0) // bw)
            for i in range(n_r):
                for j in range(n_c):
                    cover[r0 + i * bh:r0 + (i + 1) * bh, c0 + j * bw:c0 + (j + 1) * bw] += 1
    assert (cover == 1).all()


def test_plan_is_unchanged_by_the_route():
    """The plan (the fixture's whole purpose) is the tile's bytes on either
    route; the TMA route's mbarrier comes on top, inside the limit."""
    for tile, route in (((32, 256), "tma"), ((37, 33), "simt")):
        plan = ops.copy_plan((2048, 1024), torch.float32, tile)
        assert plan["smem_bytes"] == tile[0] * tile[1] * 4
        assert plan["row_bytes"] == tile[1] * 4
        assert ops.copy_route((2048, 1024), torch.float32, tile, 0)["route"] == route
