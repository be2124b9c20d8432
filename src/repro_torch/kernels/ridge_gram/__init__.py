from . import ops, ref
from .ops import (gram_accumulate, gram_accumulate_batched,
                  gram_accumulate_batched_into, gram_plain_batched)
from .ref import gram_ref, gram_ref_batched

__all__ = [
    "gram_accumulate",
    "gram_accumulate_batched",
    "gram_accumulate_batched_into",
    "gram_plain_batched",
    "gram_ref",
    "gram_ref_batched",
    "ops",
    "ref",
]
