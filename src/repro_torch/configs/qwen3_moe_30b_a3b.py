"""qwen3-moe-30b-a3b — Qwen3 MoE 30B (3B active) [hf:Qwen/Qwen3-30B-A3B; hf].

MoE: 48L, d_model 2048, 32 heads (GQA kv=4, head_dim 128), qk_norm,
128 experts top-8, expert d_ff 768, vocab 151936.  Expert parallelism over
the model axis (8 experts / device at TP=16).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    max_seq_len=40960,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    strategy="fsdp_tp_ep",
    microbatches=8,
)
