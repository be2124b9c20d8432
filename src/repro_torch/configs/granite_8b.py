"""granite-8b — IBM Granite 8B code model [arXiv:2405.04324; hf].

Dense llama-style: 36L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 49152.  Default hybrid FSDP×TP sharding.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    max_seq_len=32768,
    rope_theta=10_000_000.0,
    strategy="fsdp_tp",
    microbatches=8,
)
