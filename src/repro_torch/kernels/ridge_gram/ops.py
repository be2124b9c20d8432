"""Wrappers for the batched Gram kernel (``kernels/csrc/ridge_gram.cu``).

Ports of ``repro/kernels/ridge_gram/ops.py``: ``gram_accumulate`` (:38,
single instance), ``gram_accumulate_batched`` (:63, ONE launch for a
[B, T, F] stack — the Pallas ``gram_tiled_batched``) and
``gram_accumulate_batched_into`` (:96, fold a chunk into running stacks in
place — the Pallas ``gram_tiled_batched_into``).

* A CUDA tensor launches the hand-written kernel or raises.  Each output
  element is one f32 FMA chain in ascending t, so folding chunks into the
  running stacks is bitwise equal to one pass, for ANY chunk split.
* A CPU tensor takes ``gram_plain_batched``: it folds fixed ``block_t``
  row tiles in order (a matmul per tile), so accumulate-into is bitwise
  equal to one-shot whenever the chunks are multiples of ``block_t``.

``block_t`` is the plain version's fold tile; the kernel ignores it (its
staging depth is fixed, and its result does not depend on tiling).  The
reference's TPU tiling helpers (``effective_block_t``, the padding of F to
128 and of T to ``block_t``) have no counterpart: the kernel masks ragged
edges itself.

Targets are cast to X's dtype (as the reference wrapper does) and read as
f32; a bf16 X is widened to f32 on use.  G and c are f32.  The streaming
fold passes ``round_y=False`` to the accumulate-into entry and its plain
version: its targets stay f32 beside bf16 state chunks, as the reference's
fold hands f32 targets to the Pallas kernel directly.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, _calls

C_MAX = 128   # target columns the kernel takes (each moment block walks 64·C chains)
MAX_INSTANCES = 65535   # instances the kernel takes (its grid's y dimension)
# The kernel's tiling (kTile, kRows, kStages in ridge_gram.cu), for its plan.
TILE, STAGE_ROWS, STAGES = 64, 16, 3

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _canon(x: torch.Tensor, y: torch.Tensor, block_t: int, round_y: bool = True):
    """x [B, T, F] with y [B, T] or [B, T, C] -> (x, y [B, T, C] f32); y
    is first rounded to X's dtype unless ``round_y`` is False."""
    if isinstance(block_t, bool) or not isinstance(block_t, int) or block_t < 1:
        raise ValueError(f"block_t must be a positive int, got {block_t!r}")
    if y.ndim == 2:
        y = y[..., None]
    if x.ndim != 3 or y.ndim != 3 or y.shape[:2] != x.shape[:2]:
        raise ValueError(f"expected x [B, T, F] with y [B, T(, C)], got "
                         f"{tuple(x.shape)} / {tuple(y.shape)}")
    if y.device != x.device:
        raise ValueError("x and y must be on one device")
    return x, (y.to(x.dtype) if round_y else y).to(torch.float32)


def gram_plain_batched(x, y, *, block_t: int = 512, g0=None, c0=None,
                       round_y: bool = True):
    """Plain PyTorch version: (g0 + XᵀX, c0 + XᵀY), folding ``block_t`` row
    tiles in ascending order.  With ``g0``/``c0`` given, they are updated
    in place and returned (the aliasing of the kernel)."""
    x, y = _canon(x, y, block_t, round_y)
    b, t, f = x.shape
    x32 = x.to(torch.float32)
    g = torch.zeros((b, f, f), dtype=torch.float32, device=x.device) if g0 is None else g0
    c = (torch.zeros((b, f, y.shape[-1]), dtype=torch.float32, device=x.device)
         if c0 is None else c0)
    for t0 in range(0, t, block_t):
        xt = x32[:, t0:t0 + block_t]
        g += xt.mT @ xt
        c += xt.mT @ y[:, t0:t0 + block_t]
    return g, c


def gram_plan(x_dtype: torch.dtype, f: int, into=None) -> dict:
    """The launch plan of one call, read on either route (``_calls``): a
    block's dynamic shared memory, ``Ring<XT>::kBytes`` in ridge_gram.cu
    (a ring of STAGES stages, each holding the two strips' STAGE_ROWS rows
    as 16-byte-aligned windows of TILE / (16 / itemsize) + 1 chunks, then
    the f32 compute slot; or the epilogue's two padded tiles, whichever is
    larger), the bytes of one staged row, and whether F spans several
    tiles.  ``into`` is (G0, c0)'s storage for accumulate-into."""
    row = (TILE * torch.empty((), dtype=x_dtype).element_size() // 16 + 1) * 16
    main = STAGES * 2 * STAGE_ROWS * row + STAGE_ROWS * 2 * TILE * 4
    plan = {"smem_bytes": max(main, 2 * TILE * (TILE + 1) * 4), "row_bytes": row,
            "multi_tile": f > TILE}
    if into is not None:
        plan["into"] = into
    return plan


def _counted(wrapper, kernel: str, x, into, fn, *args, **kwargs):
    """``fn`` as one counted kernel call (``_calls``) unless X is empty."""
    b, _, f = x.shape
    if not (b and f):
        return fn(*args, **kwargs)
    return _calls.call(wrapper, kernel, gram_plan(x.dtype, f, into), fn, *args, **kwargs)


def _launch(x, y, g, c, *, has_init: bool) -> bool:
    """Launch the kernel on (g, c); False when there is nothing to launch."""
    b, t, f = x.shape
    cols = y.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the Gram kernel reads float32 or bfloat16 X, not {x.dtype}")
    if not 1 <= cols <= C_MAX:
        raise ValueError(f"the Gram kernel takes 1..{C_MAX} target columns, got {cols}")
    if b > MAX_INSTANCES:
        raise ValueError(f"the Gram kernel takes at most {MAX_INSTANCES} instances, got {b}")
    if b == 0 or f == 0:
        return False
    xk = x.contiguous()
    yk = y.contiguous()
    fn = _build.load("ridge_gram").ridge_gram_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xk.data_ptr(), int(x.dtype == torch.bfloat16), yk.data_ptr(),
                 g.data_ptr(), c.data_ptr(), int(has_init), b, t, f, cols, stream)
    _build.check(err, "ridge_gram")
    return True


def _dispatch(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the Gram runs on cuda or cpu tensors, not {x.device}")
    return x.device.type == "cuda"


def gram_accumulate_batched(x: torch.Tensor, y: torch.Tensor, *, block_t: int = 512):
    """Per-instance (G [B, F, F] f32, c [B, F, C] f32), one kernel launch."""
    x, y = _canon(x, y, block_t)
    if not _dispatch(x):
        return _counted(_K2, "ridge_gram", x, None, gram_plain_batched, x, y, block_t=block_t)
    return _counted(_K2, "ridge_gram", x, None, _launch_one_shot, x, y)


def _launch_one_shot(x, y):
    b, _, f = x.shape
    g = torch.empty((b, f, f), dtype=torch.float32, device=x.device)
    c = torch.empty((b, f, y.shape[-1]), dtype=torch.float32, device=x.device)
    if _launch(x, y, g, c, has_init=False):
        gram_accumulate_batched.launches += 1
    return g, c


def _launch_into(g0, c0, x, y):
    if _launch(x, y, g0, c0, has_init=True):
        gram_accumulate_batched_into.launches += 1
    return g0, c0


def gram_accumulate_batched_into(g0: torch.Tensor, c0: torch.Tensor,
                                 x: torch.Tensor, y: torch.Tensor, *,
                                 block_t: int = 512, round_y: bool = True):
    """(G0 + XᵀX, c0 + XᵀY) per instance, updated in place on ``g0``/``c0``
    (f32, contiguous) and returned.  ``round_y=False`` reads f32 targets
    as they are beside a bf16 X (the streaming fold)."""
    x, y = _canon(x, y, block_t, round_y)
    b, _, f = x.shape
    if tuple(g0.shape) != (b, f, f) or tuple(c0.shape) != (b, f, y.shape[-1]):
        raise ValueError(f"init stacks {tuple(g0.shape)} / {tuple(c0.shape)} do not "
                         f"match x {tuple(x.shape)} / y {tuple(y.shape)}")
    for name, s in (("g0", g0), ("c0", c0)):
        if s.dtype != torch.float32 or not s.is_contiguous() or s.device != x.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    into = (g0.data_ptr(), c0.data_ptr())
    if not _dispatch(x):
        return _counted(_K3, "ridge_gram_into", x, into, gram_plain_batched, x, y,
                        block_t=block_t, g0=g0, c0=c0, round_y=False)
    return _counted(_K3, "ridge_gram_into", x, into, _launch_into, g0, c0, x, y)


def gram_accumulate(x: torch.Tensor, y: torch.Tensor, *, block_t: int = 512):
    """Single instance: (G = XᵀX [F, F] f32, c = XᵀY [F, C] f32)."""
    if y.ndim == 1:
        y = y[:, None]
    g, c = gram_accumulate_batched(x[None], y[None], block_t=block_t)
    return g[0], c[0]


gram_accumulate_batched.launches = 0        # K2 kernel launches
gram_accumulate_batched_into.launches = 0   # K3 kernel launches
gram_accumulate_batched.calls = 0           # K2 calls on either route (``_calls``)
gram_accumulate_batched_into.calls = 0      # K3 calls on either route
# the counters' owners, should a test rebind the module's names
_K2, _K3 = gram_accumulate_batched, gram_accumulate_batched_into
