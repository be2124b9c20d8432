"""repro_torch.analysis — the port's program-contract checker (DESIGN.md §11).

The port of ``repro.analysis``.  The reference turns the repo's structural
claims (no materialized [B, T, N] state tensor, one launch pair a chunk,
the slab updated where it lies, no silent dtype widening, no host round
trip in a tick) into rules over traced jaxprs.  The port has no jaxpr: it
runs each registered entry point once at tiny shapes under a dispatch
mode and judges the run, on the CPU through the kernels' plain versions
and on the card through the kernels themselves.
``python -m repro_torch.analysis --device cuda`` checks them all and writes
ANALYSIS_torch_report.json.

``tracer`` records the run (the counterpart of ``walker``; re-exported by
``repro_torch.pipeline.introspect``), ``rules`` the contract catalog,
``registry`` the entry points, ``cli`` the gate.
"""

from .rules import (SMEM_PER_BLOCK, InPlaceHonored, MaxKernelCalls, NoDtypeAbove, NoHostSync,
                    NoSilentUpcast, NoStateTensor, Program, Rule, SmemBudget, Violation,
                    card_checks, check_rules)
from .tracer import (SYNC_OPS, Intermediate, KernelCall, SyncSite, Trace, count_kernel_calls,
                     intermediate_records, intermediate_shapes, kernel_counters,
                     max_intermediate_bytes, state_tensor_bytes, state_tensor_records,
                     trace_program)

__all__ = [
    "SMEM_PER_BLOCK", "SYNC_OPS", "InPlaceHonored", "Intermediate", "KernelCall",
    "MaxKernelCalls", "NoDtypeAbove", "NoHostSync", "NoSilentUpcast", "NoStateTensor",
    "Program", "Rule", "SmemBudget", "SyncSite", "Trace", "Violation", "card_checks",
    "check_rules", "count_kernel_calls", "intermediate_records", "intermediate_shapes",
    "kernel_counters", "max_intermediate_bytes", "state_tensor_bytes",
    "state_tensor_records", "trace_program",
]
