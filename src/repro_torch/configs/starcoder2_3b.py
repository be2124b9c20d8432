"""starcoder2-3b — BigCode StarCoder2 [arXiv:2402.19173; hf].

Dense: 30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152.
24 heads / 2 kv heads do not divide the 16-way model axis -> pure-FSDP
strategy (DESIGN.md §5).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    strategy="fsdp",
    microbatches=8,
)
