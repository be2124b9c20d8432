"""Optimisation: AdamW (+schedules, clipping) and gradient compression.

Port of ``repro.optim``.
"""

from . import compression
from .adamw import (AdamWConfig, apply_updates, global_norm, init_opt_state,
                    schedule_lr)

__all__ = [
    "AdamWConfig",
    "apply_updates",
    "compression",
    "global_norm",
    "init_opt_state",
    "schedule_lr",
]
