"""Runtime: step functions (``steps``) and the fault-tolerant training
driver (``trainer``).

Port of ``repro.runtime``.
"""

from . import steps, trainer

__all__ = ["steps", "trainer"]
