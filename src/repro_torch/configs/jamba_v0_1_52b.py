"""jamba-v0.1-52b — AI21 Jamba [arXiv:2403.19887; hf].

Hybrid Mamba+attention MoE: 32 layers as 4 Jamba blocks of 8 (attention at
in-block index 4 — the 1:7 attn:mamba ratio), MoE (16 experts, top-2,
expert d_ff 14336) every second layer, d_model 4096, 32 heads (GQA kv=8),
vocab 65536.  Mamba: d_state 16, d_conv 4, expand 2.
"""

from ..models.config import BlockSpec, ModelConfig

_UNIT = tuple(
    BlockSpec(
        mixer=("attn" if i == 4 else "mamba"),
        mlp=("moe" if i % 2 == 1 else "dense"),
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    max_seq_len=262144,
    unit=_UNIT,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    strategy="fsdp_tp_ep",
    microbatches=8,
)
