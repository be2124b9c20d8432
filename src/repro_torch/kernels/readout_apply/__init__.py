from . import ops
from .ops import readout_apply, readout_apply_plain

__all__ = ["ops", "readout_apply", "readout_apply_plain"]
