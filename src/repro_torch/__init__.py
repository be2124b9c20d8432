"""PyTorch/CUDA port of the silicon-MR delayed-feedback reservoir (DFRC).

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``pipeline/``), so that every module here has one counterpart there.  The
two Pallas TPU kernels of the paper's claims path become hand-written CUDA
C++ kernels for Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a machine without a GPU raises
(``repro_torch.device.resolve_device``).  This package imports torch and
numpy only, never jax.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
