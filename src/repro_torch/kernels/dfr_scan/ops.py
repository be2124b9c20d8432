"""Wrapper for the DFR scan kernel (``kernels/csrc/dfr_scan.cu``).

Port of ``repro/kernels/dfr_scan/ops.py:71`` (``dfr_scan``), which tiles
the batch onto the TPU's (sublane × 128-lane) vregs and calls the Pallas
kernel ``dfr_scan_tiled`` (``dfr_scan.py:97``).  Here:

* a CUDA tensor launches the hand-written kernel or raises.  The chain
  kernel runs each lane's node chain in one thread of a block's first warp,
  with the block's carry rows in shared memory, while the block's second
  warp writes the states out; ``scan_layout`` gives the blocks of 8 lanes,
  the row pitch and the shared-memory bytes from (B, N, mask mode), and
  raises above the N whose rows do not fit (see the source for what bounds
  the kernel and why).  MackeyGlass takes the helper-warp kernel instead (a
  chain warp that runs only the mul-add, helper warps that compute each
  node's powf and division behind it), at ``helper_layout``'s one lane a
  block while the batch's blocks fit the card's SMs; ``dfr_scan_at``
  launches it on the chain kernel under ``scan_layout``, the route it is
  held to bitwise.  MZISine, whose kernel keeps no rows, has no node limit;
* a CPU tensor takes ``dfr_scan_plain``, the plain PyTorch version (the
  sequential oracle of ``ref.py`` plus the output casts).

The wrapper transposes to the kernel's lane-contiguous layout (j [K, B],
carry [N, B], states [K, N, B]) and back to [B, K, N], as the reference
wrapper does for its [K, S, L] tiling; the helper-warp kernel writes the
states as [B, K, N] itself, so MackeyGlass's states are not permuted (a
call's peak is one state tensor, not two).  ``block_s`` (the TPU sublane tile)
is validated for API parity and otherwise unused: the CUDA blocks need no
sublane tile and no padding.

``mask`` is [N] (one mask broadcast over the batch) or [B, N] (per lane).
``return_final=True`` also returns the final state [B, N] in the input
dtype; feeding it back as ``s0`` resumes the scan bit-exactly for f32
input.  ``out_dtype`` (float32 or bfloat16) narrows only the emitted
states; compute is f32 throughout.

``dfr_scan_grad`` is the scan's gradient for SiliconMR with one mask, the
adjoint scan K1ᵀ (``csrc/dfr_scan_grad.cu``; no TPU kernel stands behind
it: the reference differentiates its ``lax.scan`` with ``jax.grad``).  It
takes K1's f32 states and recomputes the branch bits from them; its plain
version ``dfr_scan_grad_plain`` runs the kernel's ops in its order, so the
two agree bitwise.  The kernel reads every input in the layout the caller
holds ([B, K] and [B, K, N], as K1 emits its states) and writes dj [B, K]
and ds0 [B, N]: the wrapper allocates those two and nothing else for f32
contiguous inputs.  ``grad_layout`` gives its block layout (lanes a block,
the staging ring's depth, the nodes a handoff).  It counts ``launches``
and ``calls`` as K1 does.

Both launches are also ``torch.library`` operators,
``torch.ops.repro_torch.dfr_scan`` and ``dfr_scan_grad``, whose fakes
give their outputs' shapes and dtypes: on ``meta`` tensors (the dry run,
``launch/dryrun.py``) the wrappers go through them and run nothing, where
the plain versions' Python loops would take minutes.  On CUDA tensors the
wrappers call the launches directly, which skips the dispatcher's host
cost a call; the operators' CUDA kernels are the same functions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...core.nonlinear import KERNEL_MACKEY_GLASS, KERNEL_MZI_SINE
from ...device import resolve_dtype
from .. import _build, _calls
from .ref import dfr_scan_ref

BLOCK_S_CHOICES = (1, 2, 4, 8, 16, 32)

# Shared memory one block may use on sm_90 (227 KB, dynamic, after opting in).
SMEM_PER_BLOCK = 232_448
# The H100's streaming multiprocessors.
SMS = 132
# Lanes a block: B = 64 spreads over 8 SMs, the fastest a lane of 8, 16 and
# 32 (PERF.md PR 14).
LANES_PER_BLOCK = 8

# The most f32 constants a model's kernel_spec() may hand the kernel
# (``kMaxParams`` in dfr_scan.cu).
MAX_PARAMS = 16

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p)

# The C entry point's routes (``Route`` in dfr_scan.cu).
ROUTE_CHAIN = 0
ROUTE_HELPERS = 1

# The helper-warp kernel (csrc/dfr_scan.cu, MackeyGlass): the chain hands a
# group of about HELPER_GROUP nodes at a time to one of six helper warps and
# back (the last group of a period takes the remainder), a group being whole
# chunks of the chain's unrolled loop (``helper_chunk``).  One lane a block while
# the batch's blocks fit the card's SMS SMs (a block's helpers then serve
# one lane's chain), up to HELPER_MAX_LANES lanes a block beyond, fewer
# where the rows would not fit; as grad_layout chooses for K1ᵀ.
HELPER_GROUP = 64
HELPER_MAX_LANES = 8


class ScanLayout(NamedTuple):
    """Block layout of the scan kernel: ``lanes`` a block, ``blocks``,
    ``stride`` (floats a carry or mask row) and ``smem_bytes`` (dynamic
    shared memory a block)."""

    lanes: int
    blocks: int
    stride: int
    smem_bytes: int


class HelperLayout(NamedTuple):
    """Block layout of the helper-warp kernel: ``lanes`` a block,
    ``blocks``, ``stride`` (floats a row), ``group`` (nodes a handoff
    between the chain and the helpers) and ``smem_bytes`` (dynamic shared
    memory a block)."""

    lanes: int
    blocks: int
    stride: int
    group: int
    smem_bytes: int


def row_stride(n_nodes: int) -> int:
    """Floats a row of the carry in shared memory: N rounded up to whole
    float4s, and to an odd count of them, so that the float4s of eight
    lanes' rows fall in distinct banks."""
    s = -(-n_nodes // 4) * 4
    return s + 4 if s % 8 == 0 else s


def _rows(lanes: int, per_lane: bool) -> int:
    """Rows a block keeps: two carry rows a lane (this period's and the one
    before), and one mask row (or one a lane)."""
    return 3 * lanes if per_lane else 2 * lanes + 1


def max_nodes(per_lane: bool) -> int:
    """The largest N whose rows fit in a block's shared memory."""
    cap = SMEM_PER_BLOCK // (4 * _rows(LANES_PER_BLOCK, per_lane))
    return cap - (cap - 4) % 8


def scan_layout(b: int, n_nodes: int, per_lane: bool) -> ScanLayout:
    """The chain kernel's block layout for B lanes of N nodes; raises
    ValueError above ``max_nodes(per_lane)``."""
    limit = max_nodes(per_lane)
    if n_nodes > limit:
        mode = "per-lane" if per_lane else "broadcast"
        raise ValueError(f"the scan kernel keeps a block's carry in shared memory: N = "
                         f"{n_nodes} exceeds its limit of {limit} nodes ({mode} mask)")
    stride = row_stride(n_nodes)
    return ScanLayout(LANES_PER_BLOCK, -(-b // LANES_PER_BLOCK), stride,
                      4 * stride * _rows(LANES_PER_BLOCK, per_lane))


def helper_chunk(n_nodes: int) -> int:
    """Nodes a chunk of the helper-warp kernel's unrolled chain: 4·C for the
    largest C of 5, 4, 3 float4s that tiles the period, else one float4 (the
    kernel then steps node by node)."""
    return next((4 * c for c in (5, 4, 3) if n_nodes % (4 * c) == 0), 4)


def helper_group(n_nodes: int) -> int:
    """Nodes a handoff of the helper-warp kernel: the whole chunks nearest
    HELPER_GROUP."""
    chunk = helper_chunk(n_nodes)
    return chunk * max(1, HELPER_GROUP // chunk)


def helper_groups(n_nodes: int, group: int) -> int:
    """Node groups of a period on the helper-warp kernel: N // group, at
    least one, the last taking the remainder (``helper_groups`` in
    dfr_scan.cu)."""
    return max(1, n_nodes // group)


def helper_smem_bytes(lanes: int, n_nodes: int, per_lane: bool, group: int) -> int:
    """Shared memory of a helper-warp block: two mbarriers and a count a
    node group, in whole 16 bytes; then rows of ``row_stride(N)`` floats:
    the mask (one row, or one a lane), and a lane's a row and two carry
    rows."""
    groups = helper_groups(n_nodes, group)
    rows = (lanes if per_lane else 1) + 3 * lanes
    return -(-20 * groups // 16) * 16 + 4 * row_stride(n_nodes) * rows


@functools.cache
def max_helper_nodes(per_lane: bool) -> int:
    """The largest N whose rows fit a block of the helper-warp kernel (one
    lane)."""
    n = SMEM_PER_BLOCK // 16
    while helper_smem_bytes(1, n, per_lane, helper_group(n)) > SMEM_PER_BLOCK:
        n -= 1
    return n


def _helper_layout(b: int, n_nodes: int, per_lane: bool) -> HelperLayout:
    """``helper_layout`` without the node limit."""
    group = helper_group(n_nodes)
    lanes = next((la for la in (1, 2, 4) if -(-b // la) <= SMS), HELPER_MAX_LANES)
    while lanes > 1 and helper_smem_bytes(lanes, n_nodes, per_lane, group) > SMEM_PER_BLOCK:
        lanes //= 2
    return HelperLayout(lanes, -(-b // lanes), row_stride(n_nodes), group,
                        helper_smem_bytes(lanes, n_nodes, per_lane, group))


def helper_layout(b: int, n_nodes: int, per_lane: bool) -> HelperLayout:
    """The helper-warp kernel's block layout for B lanes of N nodes (the
    rule at HELPER_MAX_LANES, ``helper_group``); raises ValueError above
    ``max_helper_nodes``."""
    limit = max_helper_nodes(per_lane)
    if n_nodes > limit:
        mode = "per-lane" if per_lane else "broadcast"
        raise ValueError(f"the scan kernel's helper-warp route keeps a block's rows in shared "
                         f"memory: N = {n_nodes} exceeds its limit of {limit} nodes ({mode} mask)")
    return _helper_layout(b, n_nodes, per_lane)


def _route_of(model_id: int) -> str:
    if model_id == KERNEL_MACKEY_GLASS:
        return "helpers"
    return "parallel" if model_id == KERNEL_MZI_SINE else "chain"


def _layout_of(model_id: int, b: int, n_nodes: int, per_lane: bool):
    route = _route_of(model_id)
    if route == "parallel":
        return None
    if route == "helpers":
        return helper_layout(b, n_nodes, per_lane)
    return scan_layout(b, n_nodes, per_lane)


def scan_route(model) -> str:
    """The route a CUDA call of ``model`` takes: "helpers" (MackeyGlass),
    "parallel" (MZISine) or "chain" (every other form)."""
    return _route_of(model.kernel_spec()[0])


def launch_layout(model, b: int, n_nodes: int, per_lane: bool):
    """The layout a CUDA call of ``model`` launches under (``HelperLayout``,
    ``ScanLayout``, or None for MZISine's kernel, which keeps no rows);
    raises ValueError above the route's node limit."""
    return _layout_of(model.kernel_spec()[0], b, n_nodes, per_lane)


def scan_plan(model, b: int, n_nodes: int, per_lane: bool) -> dict:
    """The launch plan of one call, read on either route (``_calls``): a
    block's dynamic shared memory and the bytes of one of its rows, whole
    float4s, of the kernel the call launches.  Unlike ``scan_layout`` it
    does not raise above the node limit: the contract checker's
    ``SmemBudget`` reports that.  MZISine's kernel keeps no rows."""
    spec = getattr(model, "kernel_spec", None)
    model_id = spec()[0] if spec is not None else None
    if model_id == KERNEL_MZI_SINE:
        return {"smem_bytes": 0, "row_bytes": 0, "multi_tile": False}
    stride = row_stride(n_nodes)
    if model_id == KERNEL_MACKEY_GLASS:
        lay = _helper_layout(b, n_nodes, per_lane)
        return {"smem_bytes": lay.smem_bytes, "row_bytes": 4 * stride,
                "multi_tile": b > lay.lanes}
    return {"smem_bytes": 4 * stride * _rows(LANES_PER_BLOCK, per_lane),
            "row_bytes": 4 * stride, "multi_tile": b > LANES_PER_BLOCK}


def dfr_scan_plain(model, j, mask, s0, *, out_dtype=None):
    """Plain PyTorch version: (states [B, K, N] in ``out_dtype`` (default
    j's dtype), final state [B, N] in j's dtype)."""
    states, fin = dfr_scan_ref(model, j, mask, s0, return_final=True)
    return states.to(resolve_dtype(out_dtype) or j.dtype), fin.to(j.dtype)


def _op_args(model, out_dtype):
    """(model id, constants, emit-bf16 flag) of a kernel call, validated."""
    spec = getattr(model, "kernel_spec", None)
    if spec is None:
        raise NotImplementedError(
            f"the CUDA scan kernel has no form of {type(model).__name__}; "
            "it inlines SiliconMR, SiliconMRLiteral, MackeyGlass, MZISine "
            "and MRCavityCMT")
    model_id, params = spec()
    if len(params) > MAX_PARAMS:
        raise ValueError(f"the scan kernel takes at most {MAX_PARAMS} constants, "
                         f"{type(model).__name__} gives {len(params)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the scan kernel emits float32 or bfloat16, not {out_dtype}")
    return model_id, [float(p) for p in params], out_dtype == torch.bfloat16


def _scan_cuda(j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor, model_id: int,
               params: list[float], out_bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's launch: (states [B, K, N], final state [B, N] in j's dtype)."""
    # MZISine's kernel runs a thread a (node, lane) and keeps no rows
    layout = (_layout_of(model_id, j.shape[0], s0.shape[1], mask.ndim == 2)
              or ScanLayout(0, 0, 0, 0))
    return _scan_launch(j, mask, s0, model_id, params, out_bf16, layout)


def _scan_launch(j, mask, s0, model_id: int, params: list[float], out_bf16: bool, layout):
    """K1 under ``layout``: a ``ScanLayout`` launches the chain kernel (or
    MZISine's), whose [K, N, B] states are permuted to [B, K, N] after; a
    ``HelperLayout`` the helper-warp kernel, which writes [B, K, N]
    itself."""
    b, k_periods = j.shape
    n_nodes = s0.shape[1]
    per_lane = mask.ndim == 2
    out_dtype = torch.bfloat16 if out_bf16 else torch.float32
    # the helper-warp kernel writes [B, K, N] itself; the chain kernel
    # [K, N, B], permuted after
    helpers = isinstance(layout, HelperLayout)
    if helpers:
        route, (lanes, blocks, stride, group, smem) = ROUTE_HELPERS, layout
    else:
        route, group, (lanes, blocks, stride, smem) = ROUTE_CHAIN, 0, layout
    dev = j.device
    fin = torch.empty((n_nodes, b), dtype=torch.float32, device=dev)
    fin.copy_(s0.t())                   # the kernel updates the carry in place
    shape = (b, k_periods, n_nodes) if helpers else (k_periods, n_nodes, b)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    if b and k_periods:
        jt = j.to(torch.float32).t().contiguous()
        mt = (mask.to(torch.float32).t() if per_lane else mask.to(torch.float32)).contiguous()
        fn = _build.entry("dfr_scan", "dfr_scan_launch", _ARGTYPES)
        consts = (ctypes.c_float * len(params))(*params)
        err = _build.launch(fn, dev, jt.data_ptr(), mt.data_ptr(), int(per_lane),
                            fin.data_ptr(), out.data_ptr(), int(out_bf16), b, k_periods,
                            n_nodes, lanes, blocks, stride, group, smem, route, model_id,
                            consts, len(params))
        _build.check(err, "dfr_scan")
        dfr_scan.launches += 1
    states = out if helpers else out.permute(2, 0, 1).contiguous()
    return states, fin.t().to(j.dtype).contiguous()


# K1 as an operator, ``torch.ops.repro_torch.dfr_scan``: its CUDA kernel is
# ``_scan_cuda``; on ``meta`` tensors its fake gives the shapes (the dry run).
_scan_op = torch.library.custom_op("repro_torch::dfr_scan", _scan_cuda, mutates_args=(),
                                   device_types="cuda")


@_scan_op.register_fake
def _(j, mask, s0, model_id, params, out_bf16):
    b, k_periods = j.shape
    out_dtype = torch.bfloat16 if out_bf16 else torch.float32
    return (j.new_empty((b, k_periods, s0.shape[1]), dtype=out_dtype),
            s0.new_empty(s0.shape, dtype=j.dtype))


def _launch(model, j, mask, s0, out_dtype):
    """K1 on CUDA tensors (its launch, called directly: the operator's
    dispatch would cost every call host time), its operator's fake shapes
    on ``meta``.  Raises before anything is allocated for a model the
    kernel has no form of, an f16 output or an N above the node limit."""
    model_id, params, out_bf16 = _op_args(model, out_dtype)
    launch_layout(model, j.shape[0], s0.shape[1], mask.ndim == 2)
    run = _scan_cuda if j.device.type == "cuda" else _scan_op
    return run(j, mask, s0, model_id, params, out_bf16)


def dfr_scan_at(model, j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor, layout, *,
                out_dtype=None):
    """K1 on CUDA tensors under an explicit ``layout``: (states [B, K, N],
    final state [B, N]).  ``scan_layout(B, N, per_lane)`` launches
    MackeyGlass on the chain kernel, the route its helper-warp kernel is
    held to bitwise on the card; a ``HelperLayout`` with other lanes a
    block or another group (``_replace``, its ``smem_bytes`` from
    ``helper_smem_bytes``) times the helper-warp kernel under it.  Counts a
    launch as ``dfr_scan`` does; no caller of the package uses it."""
    if j.device.type != "cuda":
        raise ValueError(f"dfr_scan_at launches the CUDA kernel: j is on {j.device}")
    out_dtype = resolve_dtype(out_dtype) or j.dtype
    model_id, params, out_bf16 = _op_args(model, out_dtype)
    return _scan_launch(j, mask, s0, model_id, params, out_bf16, layout)


def dfr_scan(model, j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor, *,
             block_s: int | None = None, return_final: bool = False,
             out_dtype=None):
    """States [B, K, N]; with ``return_final`` also the final state [B, N]."""
    if block_s is not None and block_s not in BLOCK_S_CHOICES:
        raise ValueError(f"block_s must be one of {BLOCK_S_CHOICES}, got {block_s}")
    if j.ndim != 2:
        raise ValueError(f"j must be [B, K], got {tuple(j.shape)}")
    b = j.shape[0]
    n_nodes = int(mask.shape[-1])
    if mask.ndim == 2 and mask.shape[0] != b:
        raise ValueError(f"per-lane mask batch {mask.shape[0]} != j batch {b}")
    if mask.ndim not in (1, 2) or tuple(s0.shape) != (b, n_nodes):
        raise ValueError(f"mask {tuple(mask.shape)} / s0 {tuple(s0.shape)} do not "
                         f"match j {tuple(j.shape)}")
    if mask.device != j.device or s0.device != j.device:
        raise ValueError("j, mask and s0 must be on one device")
    out_dtype = resolve_dtype(out_dtype) or j.dtype
    if j.device.type in ("cuda", "meta"):
        run = _launch
    elif j.device.type == "cpu":
        run = dfr_scan_plain
    else:
        raise ValueError(f"dfr_scan runs on cuda or cpu tensors, not {j.device}")
    if b and j.shape[1]:
        states, fin = _calls.call(_COUNTERS, "dfr_scan",
                                  scan_plan(model, b, n_nodes, mask.ndim == 2), run,
                                  model, j, mask, s0, out_dtype=out_dtype)
    else:
        states, fin = run(model, j, mask, s0, out_dtype=out_dtype)
    return (states, fin) if return_final else states


dfr_scan.launches = 0   # kernel launches (plain-version calls are not counted)
dfr_scan.calls = 0      # calls on either route that launch (or would launch) the kernel
_COUNTERS = dfr_scan    # the counters' owner, should a test rebind the module's name


# --------------------------------------------------------------------------
# K1ᵀ: the adjoint scan (``kernels/csrc/dfr_scan_grad.cu``)
# --------------------------------------------------------------------------

_GRAD_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 9 + (ctypes.c_float,) * 4 \
    + (ctypes.c_void_p,)

# K1ᵀ's block (csrc/dfr_scan_grad.cu): eight warps, a chain warp, four
# helper warps, a summer and a stager (and one that waits, so that the
# chain has its sub-partition to itself).  The chain hands a group
# of nodes at a time to a helper warp and back: GRAD_GROUP, or
# GRAD_GROUP_WIDE when a block holds one lane and a period has two such
# groups or more (fewer handoffs; a helper then still finishes a group in
# the period's other nodes, which two lanes a block would not: PERF.md PR
# 25).  The stager keeps rows GRAD_PREFETCH_NODES nodes of chain ahead of
# the helpers (about 2 us at 8.3 cycles a node, more than a bulk copy from
# HBM takes), in a ring of 2 to GRAD_MAX_DEPTH period slots.  One lane a
# block while the batch's blocks fit the card's SMS SMs (the chain's time
# is the same whatever the grouping, and a block's helpers then serve one
# lane), up to GRAD_MAX_LANES lanes a block beyond.
GRAD_GROUP = 64
GRAD_GROUP_WIDE = 128
GRAD_PREFETCH_NODES = 512
GRAD_MAX_DEPTH = 32
GRAD_MAX_LANES = 8


class GradLayout(NamedTuple):
    """Block layout of the adjoint scan: ``lanes`` a block, ``blocks``,
    ``stride`` (floats a row), ``depth`` (period slots of the staging
    ring), ``group`` (nodes a handoff between the chain and the helpers)
    and ``smem_bytes`` (dynamic shared memory a block)."""

    lanes: int
    blocks: int
    stride: int
    depth: int
    group: int
    smem_bytes: int


def grad_constants(model) -> tuple[float, float, float, float]:
    """(alpha, gamma, beta, 1 - alpha) in f32 of the forms the adjoint scan
    covers: ``SiliconMR``, with or without TPA saturation.  Any other model
    raises NotImplementedError."""
    from ...core.nonlinear import SiliconMR, _one_minus_f32

    if type(model) is not SiliconMR:
        raise NotImplementedError(
            f"the adjoint scan (K1ᵀ) covers SiliconMR only, not {type(model).__name__}")
    _, (alpha, gamma, beta, _) = model.kernel_spec()
    return alpha, gamma, beta, _one_minus_f32(alpha)


def grad_smem_bytes(lanes: int, n_nodes: int, depth: int, group: int = GRAD_GROUP) -> int:
    """Shared memory of an adjoint-scan block: an mbarrier a ring slot and
    two a node group, j[p], j[p+1] of each lane a slot, and the handoff
    counts (one a node group, one a slot, four), in whole 16 bytes; then
    rows of ``row_stride(N)`` floats: the mask, and a lane's a and c' rows,
    two term rows and ``depth`` state and gradient slots."""
    groups = -(-n_nodes // group)
    head = 8 * (depth + 2 * groups) + 8 * depth * lanes + 4 * (groups + depth + 4)
    return -(-head // 16) * 16 + 4 * row_stride(n_nodes) * (1 + lanes * (4 + 2 * depth))


@functools.cache
def max_grad_nodes() -> int:
    """The largest N whose rows fit a block of the adjoint scan: one lane,
    a ring of two slots."""
    n = SMEM_PER_BLOCK // (4 * 9)
    while _grad_layout(1, n, 1).smem_bytes > SMEM_PER_BLOCK:
        n -= 1
    return n


def _grad_layout(b: int, n_nodes: int, lanes: int | None) -> GradLayout:
    """``grad_layout`` without the node limit, at ``lanes`` a block where
    given (the layout variants ``launch.time_kernels --plans`` times)."""
    lanes = lanes or next((la for la in (1, 2, 4) if -(-b // la) <= SMS), GRAD_MAX_LANES)
    depth = min(GRAD_MAX_DEPTH, max(2, 1 + -(-GRAD_PREFETCH_NODES // n_nodes)))
    while depth > 2 and grad_smem_bytes(lanes, n_nodes, depth) > SMEM_PER_BLOCK:
        depth -= 1
    while lanes > 1 and grad_smem_bytes(lanes, n_nodes, depth) > SMEM_PER_BLOCK:
        lanes //= 2
    group = GRAD_GROUP_WIDE if lanes == 1 and n_nodes >= 2 * GRAD_GROUP_WIDE else GRAD_GROUP
    return GradLayout(lanes, -(-b // lanes), row_stride(n_nodes), depth, group,
                      grad_smem_bytes(lanes, n_nodes, depth, group))


def grad_layout(b: int, n_nodes: int) -> GradLayout:
    """The adjoint scan's block layout for B lanes of N nodes (the rule
    above; fewer lanes a block where the rows would not fit); raises
    ValueError above ``max_grad_nodes()``."""
    limit = max_grad_nodes()
    if n_nodes > limit:
        raise ValueError(f"the adjoint scan keeps a block's rows in shared memory: N = "
                         f"{n_nodes} exceeds its limit of {limit} nodes")
    return _grad_layout(b, n_nodes, None)


def grad_plan(b: int, n_nodes: int) -> dict:
    """The adjoint scan's launch plan, read on either route (``_calls``);
    unlike ``grad_layout`` it does not raise above the node limit."""
    lay = _grad_layout(b, n_nodes, None)
    return {"smem_bytes": lay.smem_bytes, "row_bytes": 4 * lay.stride,
            "multi_tile": b > lay.lanes}


def dfr_scan_grad_plain(model, j, mask, s0, states, g_states, g_fin):
    """Plain PyTorch version of the adjoint scan: (dj [B, K], ds0 [B, N]),
    f32, from K1's f32 ``states`` [B, K, N] and the gradients of the states
    ``g_states`` [B, K, N] and of the final state ``g_fin`` [B, N].  It
    runs the kernel's ops in the kernel's order (each lane's chain backwards
    over periods and nodes, dj summed over nodes N-1 -> 0 from 0), the
    chain-free ones vectorised over lanes and nodes."""
    alpha, gamma, beta, keep = grad_constants(model)
    if mask.ndim != 1:
        raise NotImplementedError("the adjoint scan takes one mask [N], not a per-lane mask")
    f32 = torch.float32
    j, mask, s0 = j.to(f32), mask.to(f32), s0.to(f32)
    states, g_states, g_fin = states.to(f32), g_states.to(f32), g_fin.to(f32)
    b, k_periods = j.shape
    n = mask.shape[0]
    dj = torch.empty((b, k_periods), dtype=f32, device=j.device)
    q = g_fin.clone()
    lam = torch.zeros(b, dtype=f32, device=j.device)
    c_next = torch.ones(b, dtype=f32, device=j.device)
    for k in reversed(range(k_periods)):
        s_k = states[:, k]
        s_km1 = states[:, k - 1] if k else s0
        u = j[:, k, None] * mask
        prev = torch.cat([s_km1[:, -1:], s_k[:, :-1]], dim=1)
        c = torch.where(u > prev, 1.0, keep)
        a = g_states[:, k] + q
        lams = torch.empty_like(a)
        for i in reversed(range(n)):
            lam = a[:, i] + c_next * lam
            lams[:, i] = lam
            c_next = c[:, i]
        gp = alpha * lams
        if beta:
            den = 1.0 + beta * (u + gamma * s_km1)
            gp = gp / (den * den)
        q = gamma * gp
        terms = mask * gp
        acc = torch.zeros(b, dtype=f32, device=j.device)
        for i in reversed(range(n)):
            acc = acc + terms[:, i]
        dj[:, k] = acc
    ds0 = q.clone()
    ds0[:, -1] = q[:, -1] + c_next * lam
    return dj, ds0


def _grad_cuda(j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor, states: torch.Tensor,
               g_states: torch.Tensor, g_fin: torch.Tensor, alpha: float, gamma: float,
               beta: float, keep: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K1ᵀ's launch: (dj [B, K], ds0 [B, N]) f32."""
    return _grad_launch(j, mask, s0, states, g_states, g_fin, (alpha, gamma, beta, keep),
                        grad_layout(j.shape[0], mask.shape[0]))


def _grad_launch(j, mask, s0, states, g_states, g_fin, consts, layout: GradLayout):
    """K1ᵀ under ``layout``, on the inputs as the caller holds them ([B, K]
    and [B, K, N], already f32 and contiguous on the training path): the
    only allocations are dj and ds0."""
    b, k_periods = j.shape
    n_nodes = mask.shape[0]
    f32 = torch.float32
    ins = [t.to(f32).contiguous() for t in (j, mask, s0, states, g_states, g_fin)]
    dj = torch.empty((b, k_periods), dtype=f32, device=j.device)
    ds0 = torch.empty((b, n_nodes), dtype=f32, device=j.device)
    fn = _build.entry("dfr_scan_grad", "dfr_scan_grad_launch", _GRAD_ARGTYPES)
    err = _build.launch(fn, j.device, *(t.data_ptr() for t in ins), dj.data_ptr(),
                        ds0.data_ptr(), b, k_periods, n_nodes, *layout, *consts)
    _build.check(err, "dfr_scan_grad")
    dfr_scan_grad.launches += 1
    return dj, ds0


# K1ᵀ as an operator, ``torch.ops.repro_torch.dfr_scan_grad``: its CUDA
# kernel is ``_grad_cuda``; on ``meta`` tensors its fake gives the shapes.
_grad_op = torch.library.custom_op("repro_torch::dfr_scan_grad", _grad_cuda, mutates_args=(),
                                   device_types="cuda")


@_grad_op.register_fake
def _(j, mask, s0, states, g_states, g_fin, alpha, gamma, beta, keep):
    return (j.new_empty(j.shape, dtype=torch.float32),
            s0.new_empty(s0.shape, dtype=torch.float32))


def _launch_grad(model, j, mask, s0, states, g_states, g_fin):
    """K1ᵀ on CUDA tensors (its launch, called directly), its operator's
    fake shapes on ``meta``."""
    run = _grad_cuda if j.device.type == "cuda" else _grad_op
    return run(j, mask, s0, states, g_states, g_fin, *grad_constants(model))


def dfr_scan_grad(model, j: torch.Tensor, mask: torch.Tensor, s0: torch.Tensor,
                  states: torch.Tensor, g_states: torch.Tensor, g_fin: torch.Tensor):
    """The gradient of ``dfr_scan(model, j, mask, s0, return_final=True)``
    for SiliconMR and one mask [N]: (dj [B, K], ds0 [B, N]) f32 from K1's
    f32 ``states`` [B, K, N] and the incoming gradients ``g_states``
    [B, K, N] and ``g_fin`` [B, N].  A CUDA tensor launches K1ᵀ
    (``csrc/dfr_scan_grad.cu``) or raises; a CPU tensor takes
    ``dfr_scan_grad_plain``.  Other forms and per-lane masks raise
    NotImplementedError on both routes."""
    grad_constants(model)
    if mask.ndim != 1:
        raise NotImplementedError("the adjoint scan takes one mask [N], not a per-lane mask")
    if j.ndim != 2:
        raise ValueError(f"j must be [B, K], got {tuple(j.shape)}")
    b, k_periods = j.shape
    n_nodes = int(mask.shape[0])
    want = {"s0": (s0, (b, n_nodes)), "states": (states, (b, k_periods, n_nodes)),
            "g_states": (g_states, (b, k_periods, n_nodes)), "g_fin": (g_fin, (b, n_nodes))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match j {tuple(j.shape)} "
                             f"and mask {tuple(mask.shape)}: want {shape}")
        if t.device != j.device:
            raise ValueError("every input of the adjoint scan must be on one device")
    if states.dtype != torch.float32:
        raise ValueError(f"the adjoint scan recomputes the branch bits from f32 states, "
                         f"not {states.dtype}")
    if j.device.type in ("cuda", "meta"):
        run = _launch_grad
    elif j.device.type == "cpu":
        run = dfr_scan_grad_plain
    else:
        raise ValueError(f"dfr_scan_grad runs on cuda or cpu tensors, not {j.device}")
    if not (b and k_periods):
        ds0 = g_fin.to(torch.float32).clone()
        return torch.zeros((b, k_periods), dtype=torch.float32, device=j.device), ds0
    return _calls.call(_GRAD_COUNTERS, "dfr_scan_grad", grad_plan(b, n_nodes), run,
                       model, j, mask, s0, states, g_states, g_fin)


dfr_scan_grad.launches = 0   # K1ᵀ launches (plain-version calls are not counted)
dfr_scan_grad.calls = 0      # calls on either route that launch (or would launch) K1ᵀ
_GRAD_COUNTERS = dfr_scan_grad
