"""xlstm-1.3b — xLSTM [arXiv:2405.04517; unverified].

Recurrent xLSTM[7:1]: 48 blocks = 6 units of (7× mLSTM + 1× sLSTM),
d_model 2048, 4 heads, no separate FFN (d_ff = 0; blocks carry their own
projections: mLSTM pre-up-projects ×2, sLSTM post-up-projects ×4/3),
vocab 50304.  4 heads do not divide the model axis -> pure-FSDP strategy.
"""

from ..models.config import BlockSpec, ModelConfig

_UNIT = tuple(BlockSpec("mlstm", "none") for _ in range(7)) + (BlockSpec("slstm", "none"),)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=524288,
    unit=_UNIT,
    mlstm_expand=2,
    strategy="fsdp",
    microbatches=4,
)
