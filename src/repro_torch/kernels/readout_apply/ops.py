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
  version's matmul, so the two agree within f32 round-off of the sum.
* A CPU tensor takes ``readout_apply_plain``: ``with_bias(x).to(f32) @ w``,
  the product as the port computed it before the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, _calls

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]

# The kernel stages nothing in shared memory: a warp reads its row directly.
PLAN = {"smem_bytes": 0, "row_bytes": 0, "multi_tile": False}


def readout_apply_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the bias-extended features widened to f32,
    times ``w``: y [B, T, C] f32."""
    ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=-1).to(torch.float32) @ w


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the readout-apply kernel reads float32 or bfloat16 features, "
                         f"not {x.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"the readout-apply kernel takes float32 weights, not {w.dtype}")
    b, t, n = x.shape
    cols = w.shape[-1]
    xc, wc = x.contiguous(), w.contiguous()
    y = torch.empty((b, t, cols), dtype=torch.float32, device=x.device)
    if b and t:
        fn = _build.load("readout_apply").readout_apply_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        w_stride = 0 if wc.shape[0] == 1 else (n + 1) * cols
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(xc.data_ptr(), int(x.dtype == torch.bfloat16), wc.data_ptr(), y.data_ptr(),
                     b, t, n, cols, w_stride, stream)
        _build.check(err, "readout_apply")
        readout_apply.launches += 1
    return y


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
        run = readout_apply_plain
    else:
        raise ValueError(f"readout_apply runs on cuda or cpu tensors, not {x.device}")
    if not (x.shape[0] and x.shape[1]):
        return run(x, w)
    return _calls.call(_COUNTERS, "readout_apply", PLAN, run, x, w)


readout_apply.launches = 0   # kernel launches (plain-version calls are not counted)
readout_apply.calls = 0      # calls on either route (``_calls``)
_COUNTERS = readout_apply    # the counters' owner, should a test rebind the module's name
