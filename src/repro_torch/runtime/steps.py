"""Pure serving step functions.

Port of the serving half of ``repro/runtime/steps.py`` (``serve_prefill``
:87, ``serve_decode`` :94).  ``train_step`` waits for ROADMAP.md Queue 1,
item 13c.
"""

from __future__ import annotations

from ..models import decode_step as model_decode
from ..models import prefill as model_prefill


def serve_prefill(cfg, params, tokens, context=None, *, max_len: int | None = None):
    """Prefill: returns (last-position logits [B, V], cache)."""
    max_len = max_len or tokens.shape[1]
    logits, cache = model_prefill(cfg, params, tokens, max_len=max_len, context=context)
    return logits[:, -1, :], cache


def serve_decode(cfg, params, cache, tokens):
    """One decode step: (logits [B, V], new cache)."""
    logits, cache = model_decode(cfg, params, cache, tokens)
    return logits[:, -1, :], cache
