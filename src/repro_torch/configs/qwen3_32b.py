"""qwen3-32b — Qwen3 dense [hf:Qwen/Qwen3-8B family; hf].

Dense: 64L, d_model 5120, 64 heads (GQA kv=8, head_dim 128), d_ff 25600,
vocab 151936, per-head q/k RMSNorm (qk_norm).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    max_seq_len=40960,
    qk_norm=True,
    rope_theta=1_000_000.0,
    strategy="fsdp_tp",
    microbatches=8,
)
