"""Model zoo: composable transformer / reservoir stacks for the assigned archs.

Port of ``repro.models``: the serving path of every block kind (``attn``,
``cross_attn``, ``mamba``, ``mlstm``, ``slstm``, ``reservoir``), the dense
and MoE MLPs and the encoder, and ``param_logical_axes`` for the sharding
rules of ``parallel/``.
"""

from .config import BlockSpec, ModelConfig
from .losses import lm_loss
from .model import (decode_step, forward, init_cache, init_params, param_logical_axes,
                    prefill)

__all__ = [
    "BlockSpec",
    "ModelConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "lm_loss",
    "param_logical_axes",
    "prefill",
]
