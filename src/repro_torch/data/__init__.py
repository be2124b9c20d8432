"""Data: deterministic host-sharded synthetic token streams.

Port of ``repro.data``.
"""

from .pipeline import DataConfig, Prefetcher, host_batch

__all__ = ["DataConfig", "Prefetcher", "host_batch"]
