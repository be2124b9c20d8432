"""Fault injection and chaos soaking for DFR serving (DESIGN.md §12).

``faults`` — seedable, replayable, per-slot fault models (NaN/Inf ticks,
stuck-at nodes, carry corruption, MR thermal detuning, laser droop,
digitizer saturation) wrapped around the serving tick; the neutral spec is
a bitwise identity.

``chaos`` — the soak harness that runs a slab through faults and grades
isolation / containment / re-convergence against a clean run.
"""

from .chaos import make_streams, run_soak
from .faults import (FaultSpec, faulted_rows, faulty_session_step, faulty_step,
                     inject_carry, inject_inputs, no_faults, on_rows)

__all__ = [
    "FaultSpec", "no_faults", "on_rows", "faulted_rows",
    "inject_inputs", "inject_carry", "faulty_session_step", "faulty_step",
    "make_streams", "run_soak",
]
