"""Per-stage wall clock of one ``Experiment.run``.

The pipeline marks each of its stages with ``stage(name, device)``.  Off
(the default) a mark costs one context-manager entry and records nothing.
Inside ``record_stages()`` every mark synchronises the device before and
after its stage and adds the host seconds in between to the dict that
``record_stages`` yields:

    with record_stages() as seconds:
        Experiment(cfg).run(*batch)
    seconds   # {"input_layer": ..., "states_train": ..., "gram": ..., ...}

The synchronise at each mark keeps a stage's device work inside its own
span (one stage no longer overlaps the next), so a recorded run takes
slightly longer than an unrecorded one.  The record is process-global and
not thread-safe: record one run at a time.

Recording or not, the marks open now form a stack (``current_path()``,
outermost first, e.g. ``("stream_fit", "stream_fold")``): the contract
checker's tracer (``repro_torch.analysis.tracer``) files every op it sees
under it.
"""

from __future__ import annotations

import contextlib
import time

import torch

_seconds: dict[str, float] | None = None
_path: list[str] = []


def current_path() -> tuple[str, ...]:
    """The names of the marked stages open now, outermost first."""
    return tuple(_path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str, device: torch.device):
    """Mark the enclosed stage (``current_path``) and time it into the
    active ``record_stages`` dict."""
    _path.append(name)
    try:
        if _seconds is None:
            yield
            return
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        _seconds[name] = _seconds.get(name, 0.0) + time.perf_counter() - t0
    finally:
        _path.pop()


@contextlib.contextmanager
def record_stages():
    """Record the host seconds of every marked stage run inside the block."""
    global _seconds
    if _seconds is not None:
        raise RuntimeError("record_stages() is already active")
    _seconds = {}
    try:
        yield _seconds
    finally:
        _seconds = None
