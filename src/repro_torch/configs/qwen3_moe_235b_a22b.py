"""qwen3-moe-235b-a22b — Qwen3 MoE 235B (22B active) [hf:Qwen/Qwen3-30B-A3B scaling; hf].

MoE: 94L, d_model 4096, 64 heads (GQA kv=4, head_dim 128), qk_norm,
128 experts top-8, expert d_ff 1536, vocab 151936.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    max_seq_len=40960,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    strategy="fsdp_tp_ep",
    microbatches=16,
)
