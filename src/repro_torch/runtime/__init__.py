"""Runtime: the serving step functions (``steps``).

Port of ``repro.runtime``; the training step and the fault-tolerant
trainer wait for ROADMAP.md Queue 1, item 13c.
"""

from . import steps

__all__ = ["steps"]
