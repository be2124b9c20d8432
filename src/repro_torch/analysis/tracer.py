"""Run-time op accounting with stage provenance: the port of ``walker.py``.

The reference's checker traces jaxprs and walks their equations without
running them.  The port has no jaxpr, so its checker runs a program once,
at tiny shapes, under a ``TorchDispatchMode`` (``Trace``) and judges what
it saw:

* every tensor an op returns, as an ``Intermediate`` (shape, dtype, bytes,
  op, path).  The provenance ``path`` is the stack of
  ``pipeline.stages.stage`` marks open at the op, e.g. ``("stream_fit",
  "stream_fold")``: the counterpart of the reference's path of enclosing
  primitives.  It turns "a [2, 96, 16] tensor exists" into "the fit's
  state stage materializes the stream";
* every kernel call (``kernels/_calls.py``), on either route, with its
  launch plan.  A call is one opaque op, as a ``pallas_call`` is in the
  reference's walk: the plain version's own ops (CPU) and the launch's
  staging tensors (CUDA) are not recorded, its outputs are, with the
  kernel's name as their op.  So the CPU and the card record the same
  program;
* every host sync: an op that reads a value back to the host
  (``SYNC_OPS``, e.g. ``.item()``'s ``_local_scalar_dense``), a copy from
  the card to the host, and, with ``sync_debug`` on the card, every
  synchronizing CUDA call that ``torch.cuda.set_sync_debug_mode`` reports,
  filed under the op it surfaced in or after (``torch.linalg.eigh``'s
  check of its error status under ``_linalg_eigh``; ``torch.tensor``'s
  copy of host data to the card under the ``lift_fresh`` that follows it).

``trace_program(fn, *args)`` runs ``fn`` under a ``Trace`` and returns it.
The helpers below (``state_tensor_records`` and the rest) have
``walker.py``'s semantics over the records.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import _calls
from ..pipeline import stages

# Ops that read a device value back to the host, or whose output shape
# depends on the data (so the host must wait for it).
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive",
})

# The message torch.cuda.set_sync_debug_mode gives a synchronizing call.
SYNC_DEBUG_MESSAGE = "called a synchronizing CUDA operation"

# The kernels the wrappers count: name -> (module, wrapper).
KERNELS = {
    "dfr_scan": ("repro_torch.kernels.dfr_scan.ops", "dfr_scan"),
    "dfr_scan_grad": ("repro_torch.kernels.dfr_scan.ops", "dfr_scan_grad"),
    "ridge_gram": ("repro_torch.kernels.ridge_gram.ops", "gram_accumulate_batched"),
    "ridge_gram_into": ("repro_torch.kernels.ridge_gram.ops", "gram_accumulate_batched_into"),
    "block_copy": ("repro_torch.kernels.block_copy.ops", "block_copy"),
    "readout_apply": ("repro_torch.kernels.readout_apply.ops", "readout_apply"),
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass(frozen=True)
class Intermediate:
    """One tensor the program made, with provenance."""

    shape: tuple
    dtype: str
    nbytes: int
    op: str                 # the op (or kernel) that returned it
    path: tuple             # open stage marks, outermost first

    @property
    def elems(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    def where(self) -> str:
        return "/".join(self.path + (self.op,))


@dataclasses.dataclass(frozen=True)
class SyncSite:
    """One host sync: ``op`` is the op it happened in (``"<python>"``
    outside any op), ``how`` what made it one."""

    op: str
    path: tuple
    how: str                # "read-back op" | "device-to-host copy" | "sync debug"

    def where(self) -> str:
        return "/".join(self.path + (self.op,))


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One kernel call, on either route, with its launch plan
    (``smem_bytes``, ``row_bytes``, ``multi_tile``; accumulate-into Gram
    calls also ``into``, the storage of G0 and c0)."""

    kernel: str
    path: tuple
    plan: dict


def kernel_counters() -> dict[str, tuple[int, int]]:
    """Each kernel's (launches, calls) counters now."""
    import importlib

    out = {}
    for name, (module, attr) in KERNELS.items():
        wrapper = getattr(importlib.import_module(module), attr)
        out[name] = (wrapper.launches, wrapper.calls)
    return out


class Trace(TorchDispatchMode):
    """Records what a program run under it does (see the module doc).

    ``sync_debug`` ("warn" or "error") also runs it under
    ``torch.cuda.set_sync_debug_mode``: with "warn" every synchronizing
    CUDA call becomes a ``SyncSite``; with "error" the first one raises,
    after it is recorded if it happened inside an op.
    """

    def __init__(self, *, sync_debug: str | None = None):
        super().__init__()
        self.records: list[Intermediate] = []
        self.syncs: list[SyncSite] = []
        self.kernel_calls: list[KernelCall] = []
        self.result = None
        self.sync_debug = sync_debug
        self._in_kernel = 0
        self._op: str | None = None      # the op in flight
        self._last_op = "<python>"        # the last op dispatched
        self._saved = None

    # -- the dispatch mode --------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        outer, self._op = self._op, name
        try:
            out = func(*args, **kwargs)
        except RuntimeError as err:
            if SYNC_DEBUG_MESSAGE in str(err):
                self._sync(name, "sync debug")
            raise
        finally:
            self._op = outer
            self._last_op = name
        outs = _tensors(out)
        if name in SYNC_OPS:
            self._sync(name, "read-back op")
        ins = _tensors((args, kwargs))
        if (any(t.device.type == "cuda" for t in ins)
                and any(t.device.type == "cpu" for t in outs)):
            self._sync(name, "device-to-host copy")
        if self._in_kernel:           # a kernel call is one op: its outputs
            return out                # are recorded when it returns
        path = stages.current_path()
        for t in outs:
            self.records.append(Intermediate(tuple(t.shape), _dtype_name(t.dtype),
                                             t.numel() * t.element_size(), name, path))
        return out

    def _sync(self, op: str, how: str) -> None:
        self.syncs.append(SyncSite(op, stages.current_path(), how))

    # -- kernel calls (kernels/_calls.py) -------------------------------------
    def kernel_enter(self, kernel: str, plan: dict) -> None:
        if not self._in_kernel:
            self.kernel_calls.append(KernelCall(kernel, stages.current_path(), dict(plan)))
        self._in_kernel += 1

    def kernel_exit(self, kernel: str, out) -> None:
        self._in_kernel -= 1
        if self._in_kernel or out is None:
            return
        path = stages.current_path()
        for t in _tensors(out):
            self.records.append(Intermediate(tuple(t.shape), _dtype_name(t.dtype),
                                             t.numel() * t.element_size(), kernel, path))

    # -- sync-debug warnings ------------------------------------------------
    def _showwarning(self, message, category, filename, lineno, file=None, line=None):
        # torch hands a C++ warning to Python when the outermost call from
        # Python returns, so a sync inside an op (eigh's check of its error
        # status) surfaces after the op: it is filed under the op in flight,
        # else the last op dispatched
        if SYNC_DEBUG_MESSAGE in str(message):
            self._sync(self._op or self._last_op, "sync debug")
            return
        self._saved[1](message, category, filename, lineno, file, line)

    def __enter__(self):
        _calls._listeners.append(self)
        if self.sync_debug is not None:
            catcher = warnings.catch_warnings()
            catcher.__enter__()
            warnings.simplefilter("always")
            self._saved = (catcher, warnings.showwarning,
                           torch.cuda.get_sync_debug_mode())
            warnings.showwarning = self._showwarning
            torch.cuda.set_sync_debug_mode(self.sync_debug)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _calls._listeners.remove(self)
            if self._saved is not None:
                catcher, _, mode = self._saved
                torch.cuda.set_sync_debug_mode(mode)
                catcher.__exit__(None, None, None)
                self._saved = None

    # -- views ----------------------------------------------------------------
    @property
    def shapes(self) -> list[tuple]:
        """The shape of every recorded tensor, in order."""
        return [r.shape for r in self.records]


def trace_program(fn, *args, sync_debug: str | None = None, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` under a ``Trace``; its result is
    ``Trace.result``."""
    with Trace(sync_debug=sync_debug) as trace:
        trace.result = fn(*args, **kwargs)
    return trace


def _records(trace_or_records) -> list[Intermediate]:
    return getattr(trace_or_records, "records", trace_or_records)


def intermediate_records(trace) -> list[Intermediate]:
    """Every ``Intermediate`` of a ``Trace`` (or a list of them)."""
    return list(_records(trace))


def intermediate_shapes(trace) -> list[tuple]:
    """All (shape, nbytes) pairs the program made."""
    return [(r.shape, r.nbytes) for r in _records(trace)]


def max_intermediate_bytes(trace) -> int:
    """Largest single tensor the program made, in bytes."""
    return max((r.nbytes for r in _records(trace)), default=0)


def _dims_match_template(shape, template) -> bool:
    """True if ``shape``'s dims are a permutation of ``template``'s."""
    return sorted(int(d) for d in shape) == sorted(int(d) for d in template)


def state_tensor_records(trace, t_len: int, min_elems: int, *, benign_shapes=()) -> list:
    """All "state-like" tensors: they carry the stream axis (a dim ==
    ``t_len``) at state-tensor scale (>= ``min_elems`` elements) and match
    none of the ``benign_shapes`` templates (dim multisets, order ignored:
    structurally known blocks whose axis happens to equal ``t_len``).
    The records carry provenance (``Intermediate.where()``)."""
    out = []
    for rec in _records(trace):
        if t_len not in rec.shape or rec.elems < min_elems:
            continue
        if any(_dims_match_template(rec.shape, t) for t in benign_shapes):
            continue
        out.append(rec)
    return out


def state_tensor_bytes(trace, t_len: int, min_elems: int, *, benign_shapes=()) -> int:
    """Largest "state-like" tensor in bytes (0: the property holds)."""
    return max((r.nbytes for r in state_tensor_records(
        trace, t_len, min_elems, benign_shapes=benign_shapes)), default=0)


def count_kernel_calls(trace) -> Counter:
    """Calls of each kernel in a ``Trace``, on either route."""
    return Counter(c.kernel for c in trace.kernel_calls)
