from . import ops
from .ops import block_copy, block_copy_plain, copy_plan

__all__ = ["block_copy", "block_copy_plain", "copy_plan", "ops"]
