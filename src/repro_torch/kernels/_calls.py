"""One kernel call, as the wrappers count it and the contract checker sees it.

Every kernel wrapper runs its work (the CUDA launch, or the plain version
for CPU tensors) through ``call``.  ``call`` adds one to the wrapper's
``calls`` counter, on either route, beside the ``launches`` that only the
CUDA route counts, so a run on the card gives ``launches == calls``.  It
also tells every listener (``repro_torch.analysis.tracer.Trace``) which
kernel ran and with what launch plan (dynamic shared memory a block, the
bytes of a staged row, and whether the array spans several tiles).  The
tracer treats the call as one opaque op on either route: the plain
version's own ops are not the program's intermediates, as the Pallas
kernel's body is not in the reference's walk.
"""

from __future__ import annotations

_listeners: list = []


def call(wrapper, kernel: str, plan: dict, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one call of ``kernel`` (counted on
    ``wrapper.calls``) with its launch ``plan``."""
    wrapper.calls += 1
    for listener in _listeners:
        listener.kernel_enter(kernel, plan)
    out = None
    try:
        out = fn(*args, **kwargs)
    finally:
        for listener in reversed(_listeners):
            listener.kernel_exit(kernel, out)
    return out
