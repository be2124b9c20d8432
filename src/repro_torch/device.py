"""Device and dtype resolution for the port's entry points.

Every entry point (``Experiment``, ``generate_states``, ``fit_ridge*``) takes
a ``device`` argument.  ``None`` means ``cuda``: the port is built for the
GPU and runs there unless the caller asks for the CPU (as the tests do).
A ``cuda`` request on a machine without a usable GPU raises; the port never
carries on on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``.

    Raises RuntimeError for a CUDA device when ``torch.cuda.is_available()``
    is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype) -> torch.dtype | None:
    """A torch dtype from a dtype, its name (``"bfloat16"``) or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return resolved


def host_values(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small tensor of host constants (a λ grid, the 4-PAM symbols) on
    ``device``.  ``torch.tensor(values, device="cuda")`` copies host data
    with a blocking copy, which waits for the stream: a host sync in every
    call that makes one.  A non-blocking copy from host memory stages the
    values at once and does not wait for the device."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)
