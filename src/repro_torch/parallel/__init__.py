"""Distribution: sharding rules, pipeline parallelism, mesh helpers.

Port of ``repro.parallel`` onto ``torch.distributed``.
"""

from . import pipeline, sharding

__all__ = ["pipeline", "sharding"]
