"""Re-export shim: run-time op accounting lives in ``repro_torch.analysis``.

The port of ``repro/pipeline/introspect.py``, which re-exports the
reference's jaxpr walker.  Here the names are the tracer's
(``repro_torch.analysis.tracer``): a program is run under a dispatch mode
instead of traced.  Import from ``repro_torch.analysis`` in new code.
"""

from ..analysis.tracer import (count_kernel_calls, intermediate_shapes,
                               max_intermediate_bytes, state_tensor_bytes, trace_program)

__all__ = [
    "count_kernel_calls", "intermediate_shapes", "max_intermediate_bytes",
    "state_tensor_bytes", "trace_program",
]
