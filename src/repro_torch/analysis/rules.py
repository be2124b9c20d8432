"""Declarative program contracts over a run's records: the port of ``rules.py``.

A ``Program`` wraps one entry point (a callable and its example
arguments) and runs it once, lazily, under the tracer
(``tracer.Trace``).  On the card the run also measures the peak device
memory above the arguments, counts each kernel's launches and calls, and
runs under ``torch.cuda.set_sync_debug_mode("warn")`` so that every
synchronizing call is recorded with its op and stage path.  A ``Rule``
judges a Program and returns ``Violation``s; an empty list means the
contract holds.

The catalog, each beside the reference rule it stands for:

- ``NoStateTensor``  (``NoStateTensor``) — no [B, T, N] state tensor;
  on the card, optionally, a peak-memory budget too
- ``MaxKernelCalls`` (``MaxPallasCalls``) — a bounded number of kernel
  calls, stated per chunk × chunks (the chunk loop is Python, so there is
  no ``MaxScans``)
- ``NoDtypeAbove``   (``NoDtypeAbove``) — no float64 (or complex128) op
- ``NoSilentUpcast`` (``NoSilentUpcast``) — no f32 chunk in a bf16 program
- ``NoHostSync``     (``NoHostCallback``) — no host round trip, except the
  sites an entry names in ``allow``
- ``InPlaceHonored`` (``DonationHonored``) — the slab is updated in place
  and the Gram folds into the caller's storage
- ``SmemBudget``     (``VmemBudget``) — every kernel call's shared memory
  fits a block of the card, and a multi-tile block's row is whole 16-byte
  chunks
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.dfr_scan.ops import SMEM_PER_BLOCK
from .tracer import (Intermediate, Trace, _tensors, count_kernel_calls, kernel_counters,
                     state_tensor_records)

# The copy unit of the kernels' staging (16-byte cp.async, ridge_gram.cu).
STAGE_CHUNK_BYTES = 16


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract, with enough provenance to find the culprit."""

    rule: str
    message: str
    path: tuple = ()            # open stage marks (then the op), outermost first
    shape: tuple = None
    dtype: str = None

    def as_dict(self) -> dict:
        d = {"rule": self.rule, "message": self.message, "path": list(self.path)}
        if self.shape is not None:
            d["shape"] = [int(s) for s in self.shape]
        if self.dtype is not None:
            d["dtype"] = self.dtype
        return d

    def __str__(self) -> str:
        where = "/".join(self.path) or "<top>"
        return f"[{self.rule}] {self.message} (at {where})"


def _rec_violation(rule: str, message: str, rec: Intermediate) -> Violation:
    return Violation(rule=rule, message=message, path=rec.path + (rec.op,),
                     shape=rec.shape, dtype=rec.dtype)


def _device_of(args) -> torch.device:
    leaves = _tensors(args)
    return leaves[0].device if leaves else torch.device("cpu")


class Program:
    """One checkable entry point: a callable and its example arguments.

    ``fn(*args)`` runs once, at the first look at its records.
    ``inplace_argnums`` names the arguments whose storage the program
    updates in place (the port's counterpart of donation).  A run that
    raises is kept: ``error`` holds the exception and the records stop
    where it happened.  On a CUDA device the run also fills
    ``peak_bytes`` (device memory above what was allocated before it) and
    ``counts`` ({kernel: (launches, calls)} made by the run).
    """

    def __init__(self, fn, args, *, inplace_argnums=(), name: str = ""):
        self.fn = fn
        self.args = tuple(args)
        self.inplace_argnums = tuple(inplace_argnums)
        self.name = name
        self.device = _device_of(self.args)
        self.error: BaseException | None = None
        self.peak_bytes: int | None = None
        self.counts: dict[str, tuple[int, int]] | None = None
        self._trace: Trace | None = None

    def run(self, *, sync_debug: str | None = None) -> Trace:
        """Run the program under a fresh ``Trace`` and keep that run."""
        cuda = self.device.type == "cuda"
        if sync_debug is None and cuda:
            sync_debug = "warn"
        before = kernel_counters()
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        trace = Trace(sync_debug=sync_debug)
        self.error = None
        try:
            with trace:
                trace.result = self.fn(*self.args)
        except Exception as err:      # a broken run is reported, not raised
            self.error = err
        after = kernel_counters()
        self.counts = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
                       for k in after}
        if cuda:
            torch.cuda.synchronize(self.device)
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device) - base
        self._trace = trace
        return trace

    @property
    def trace(self) -> Trace:
        if self._trace is None:
            self.run()
        return self._trace

    @property
    def records(self) -> list:
        return self.trace.records


class Rule:
    """Base contract: ``check(program)`` returns a list of ``Violation``s."""

    name = "Rule"

    def check(self, program: Program) -> list:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class NoStateTensor(Rule):
    """No tensor carries the stream axis at state-tensor scale.

    ``t_len`` is the stream length, ``min_elems`` the element floor that
    separates a state tensor from the O(B·T) input streams,
    ``benign_shapes`` dim-multiset templates of structurally known blocks
    whose axis happens to equal ``t_len`` (``tracer.state_tensor_records``).
    ``max_bytes`` turns "must not exist" (0) into a budget.  On the card,
    ``max_peak_bytes`` also bounds the run's peak device memory above its
    arguments.
    """

    name = "NoStateTensor"

    def __init__(self, t_len: int, min_elems: int, *, benign_shapes=(), max_bytes: int = 0,
                 max_peak_bytes: int | None = None, what: str = "state tensor"):
        self.t_len = int(t_len)
        self.min_elems = int(min_elems)
        self.benign_shapes = tuple(tuple(s) for s in benign_shapes)
        self.max_bytes = int(max_bytes)
        self.max_peak_bytes = max_peak_bytes
        self.what = what

    def describe(self) -> str:
        bound = f"<= {self.max_bytes}B" if self.max_bytes else "none"
        peak = "" if self.max_peak_bytes is None else f", peak <= {self.max_peak_bytes}B"
        return f"{self.name}(t_len={self.t_len}, min_elems={self.min_elems}, {bound}{peak})"

    def check(self, program: Program) -> list:
        out = []
        for rec in state_tensor_records(program.trace, self.t_len, self.min_elems,
                                        benign_shapes=self.benign_shapes):
            if rec.nbytes > self.max_bytes:
                out.append(_rec_violation(
                    self.name, f"{self.what} {rec.shape} {rec.dtype} = {rec.nbytes}B "
                    f"carries the t_len={self.t_len} axis above {self.max_bytes}B", rec))
        if (self.max_peak_bytes is not None and program.peak_bytes is not None
                and program.peak_bytes > self.max_peak_bytes):
            out.append(Violation(self.name, f"peak device memory {program.peak_bytes}B "
                                 f"above the arguments exceeds {self.max_peak_bytes}B"))
        return out


class MaxKernelCalls(Rule):
    """At most Σ per_chunk × chunks kernel calls, on either route.

    The reference's ``MaxPallasCalls`` counts ``pallas_call`` equations
    in a traced scan body, once per body.  The port's chunk loop is
    Python, so a run calls the kernels once per chunk: each term is
    (calls a chunk, chunks), e.g. ``MaxKernelCalls((2, 3), (1, 2))`` for a
    streamed fit of 3 chunks (K1 + K3 each) and an evaluation of 2 (K1).
    An int is one chunk.
    """

    name = "MaxKernelCalls"

    def __init__(self, *terms):
        self.terms = tuple((t, 1) if isinstance(t, int) else (int(t[0]), int(t[1]))
                           for t in terms) or ((0, 1),)
        self.limit = sum(per * n for per, n in self.terms)

    def describe(self) -> str:
        terms = " + ".join(f"{per}x{n}" for per, n in self.terms)
        return f"{self.name}({terms} = {self.limit})"

    def check(self, program: Program) -> list:
        calls = program.trace.kernel_calls
        if len(calls) <= self.limit:
            return []
        counts = count_kernel_calls(program.trace)
        listing = ", ".join(f"{k} x{n}" for k, n in sorted(counts.items()))
        return [Violation(self.name, f"{len(calls)} kernel calls > limit {self.limit}: "
                          f"{listing}", path=calls[self.limit].path)]


def _dtype(name: str) -> torch.dtype | None:
    dt = getattr(torch, name, None)
    return dt if isinstance(dt, torch.dtype) else None


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


class NoDtypeAbove(Rule):
    """No floating or complex tensor wider than ``limit``: catches a
    float64 a stray literal or numpy array drags into a hot path.  Host
    numpy (the float64 readout of ``core/readout.py``) is not a torch op
    and out of scope, as host code is in the reference."""

    name = "NoDtypeAbove"

    def __init__(self, limit="float32"):
        self.limit = limit if isinstance(limit, torch.dtype) else _dtype(limit)
        self.limit_name = str(self.limit).removeprefix("torch.")

    def describe(self) -> str:
        return f"{self.name}({self.limit_name})"

    def check(self, program: Program) -> list:
        out = []
        limit = _itemsize(self.limit)
        for rec in program.records:
            dt = _dtype(rec.dtype)
            if dt is None or not (dt.is_floating_point or dt.is_complex):
                continue
            # a complex element is two reals: compare the width of its parts
            width = _itemsize(dt) // (2 if dt.is_complex else 1)
            if width > limit:
                out.append(_rec_violation(self.name, f"{rec.dtype} intermediate "
                                          f"{rec.shape} wider than {self.limit_name}",
                                          rec))
        return out


class NoSilentUpcast(Rule):
    """A bf16-chunk program makes no f32-or-wider tensor at chunk scale:
    the halved state traffic is void if a wide copy of each chunk exists
    anyway.  Same shape grammar as ``NoStateTensor``, on wide dtypes."""

    name = "NoSilentUpcast"

    def __init__(self, chunk_len: int, min_elems: int, *, benign_shapes=(), wide="float32"):
        self.chunk_len = int(chunk_len)
        self.min_elems = int(min_elems)
        self.benign_shapes = tuple(tuple(s) for s in benign_shapes)
        self.wide = wide if isinstance(wide, torch.dtype) else _dtype(wide)

    def describe(self) -> str:
        return (f"{self.name}(chunk_len={self.chunk_len}, min_elems={self.min_elems}, "
                f"wide>={str(self.wide).removeprefix('torch.')})")

    def check(self, program: Program) -> list:
        out = []
        wide = _itemsize(self.wide)
        for rec in state_tensor_records(program.trace, self.chunk_len, self.min_elems,
                                        benign_shapes=self.benign_shapes):
            dt = _dtype(rec.dtype)
            if dt is not None and dt.is_floating_point and _itemsize(dt) >= wide:
                out.append(_rec_violation(self.name, f"chunk-scale {rec.dtype} block "
                                          f"{rec.shape} in a narrow-chunk program", rec))
        return out


class NoHostSync(Rule):
    """No host round trip inside the program: no op that reads a value back
    (``tracer.SYNC_OPS``), no copy from the card to the host, and on the
    card no synchronizing CUDA call (``set_sync_debug_mode``).  ``allow``
    names the ops whose syncs the entry is known to have (a site is the op
    it surfaced in or after: ``tracer.Trace``); every such site is listed
    in ROADMAP.md Queue 3."""

    name = "NoHostSync"

    def __init__(self, allow=()):
        self.allow = tuple(allow)

    def describe(self) -> str:
        return f"{self.name}(allow={list(self.allow)})" if self.allow else self.name

    def check(self, program: Program) -> list:
        out = [Violation(self.name, f"host sync ({s.how}) `{s.op}` in the program",
                         path=s.path + (s.op,))
               for s in program.trace.syncs if s.op not in self.allow]
        err = program.error
        if err is not None and "synchroniz" in str(err):
            out.append(Violation(self.name, f"the run raised at a host sync: {err}"))
        return out


class InPlaceHonored(Rule):
    """The program updates its in-place arguments where they lie.

    The port's counterpart of donation: the leaves ``fields`` of every
    argument named by ``Program(inplace_argnums=...)`` (all its tensors
    when ``fields`` is None) come back in the result with the same storage
    and shape.  ``min_into_calls`` counts the accumulate-into Gram calls
    (K3) that fold into the caller's storage (an in-place argument's, or
    else the one running G/c the program's first fold used), the
    counterpart of ``min_pallas_aliases``: a fold that reallocated its
    running stacks each chunk would drop below it.
    """

    name = "InPlaceHonored"

    def __init__(self, *, fields=None, min_into_calls: int = 0):
        self.fields = None if fields is None else tuple(fields)
        self.min_into_calls = int(min_into_calls)

    def describe(self) -> str:
        fields = "all" if self.fields is None else ",".join(self.fields)
        return f"{self.name}(leaves={fields}, into_calls>={self.min_into_calls})"

    def _named(self, program: Program) -> list[tuple[str, int, tuple]]:
        out = []
        for i in program.inplace_argnums:
            arg = program.args[i]
            if self.fields is not None:
                for f in self.fields:
                    leaf = getattr(arg, f)
                    out.append((f"arg{i}.{f}", leaf.data_ptr(), tuple(leaf.shape)))
            else:
                out += [(f"arg{i}[{k}]", t.data_ptr(), tuple(t.shape))
                        for k, t in enumerate(_tensors(arg))]
        return out

    def check(self, program: Program) -> list:
        out = []
        trace = program.trace
        returned = {(t.data_ptr(), tuple(t.shape)) for t in _tensors(trace.result)}
        named = self._named(program)
        for label, ptr, shape in named:
            if (ptr, shape) not in returned:
                out.append(Violation(self.name, f"{label} {shape} does not come back in "
                                     "its own storage: the update was not in place"))
        if self.min_into_calls:
            into = [c for c in trace.kernel_calls if c.kernel == "ridge_gram_into"]
            storage = ({ptr for _, ptr, _ in named} if named
                       else set(into[0].plan["into"]) if into else set())
            got = sum(1 for c in into if set(c.plan["into"]) <= storage)
            if got < self.min_into_calls:
                out.append(Violation(self.name, f"{got} accumulate-into Gram calls fold "
                                     f"into the caller's storage, expected >= "
                                     f"{self.min_into_calls} ({len(into)} calls in all)"))
        return out


class SmemBudget(Rule):
    """Every kernel call's planned dynamic shared memory fits a block of
    the card, and a multi-tile block's row is whole 16-byte chunks.

    The plan is the wrapper's (``kernels/_calls.py``), read on either
    route, so the CPU run flags what the card would refuse, as the
    reference's ``VmemBudget`` flags in interpret mode what Mosaic would.
    The alignment half is Hopper's: the kernels stage tile rows with
    16-byte ``cp.async`` copies (ridge_gram.cu), so a block that spans
    part of an array needs rows of whole 16-byte chunks.  A single-tile
    block is exempt.
    """

    name = "SmemBudget"

    def __init__(self, limit_bytes: int = SMEM_PER_BLOCK, *, check_alignment: bool = True):
        self.limit_bytes = int(limit_bytes)
        self.check_alignment = check_alignment

    def describe(self) -> str:
        return f"{self.name}({self.limit_bytes}B)"

    def check(self, program: Program) -> list:
        out = []
        for call in program.trace.kernel_calls:
            plan = call.plan
            where = call.path + (call.kernel,)
            if plan["smem_bytes"] > self.limit_bytes:
                out.append(Violation(self.name, f"kernel `{call.kernel}` plans "
                                     f"{plan['smem_bytes']}B of shared memory a block > "
                                     f"budget {self.limit_bytes}B", path=where))
            if (self.check_alignment and plan["multi_tile"]
                    and plan["row_bytes"] % STAGE_CHUNK_BYTES):
                out.append(Violation(self.name, f"kernel `{call.kernel}`: a row of "
                                     f"{plan['row_bytes']}B of a multi-tile block is not "
                                     f"whole {STAGE_CHUNK_BYTES}-byte chunks", path=where))
        return out


def card_checks(program: Program, rules) -> list:
    """What only a run on the card shows, beyond the rules: each kernel
    the run called was launched once a call (``launches == calls``), and
    an entry that allows no sync site also runs under
    ``set_sync_debug_mode("error")`` (a fresh run).  Empty off the card."""
    if program.device.type != "cuda":
        return []
    _ = program.trace
    out = [Violation("LaunchesEqualCalls", f"`{k}`: {launches} launches for {calls} calls")
           for k, (launches, calls) in sorted(program.counts.items()) if launches != calls]
    strict = [r for r in rules if isinstance(r, NoHostSync) and not r.allow]
    if strict:
        again = Program(program.fn, program.args, inplace_argnums=program.inplace_argnums,
                        name=program.name)
        again.run(sync_debug="error")
        if again.error is not None:
            out.append(Violation("NoHostSync", "the run under sync debug mode 'error' "
                                 f"raised: {again.error}"))
    return out


def check_rules(program: Program, rules) -> list:
    """Evaluate ``rules`` against ``program``; flat list of violations."""
    out = []
    for rule in rules:
        out.extend(rule.check(program))
    return out


__all__ = [
    "SMEM_PER_BLOCK", "STAGE_CHUNK_BYTES", "InPlaceHonored", "MaxKernelCalls", "NoDtypeAbove",
    "NoHostSync", "NoSilentUpcast", "NoStateTensor", "Program", "Rule", "SmemBudget",
    "Violation", "card_checks", "check_rules",
]
