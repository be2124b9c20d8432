"""gemma-7b — Google Gemma [arXiv:2403.08295; hf].

Dense: 28L, d_model 3072, 16 MHA heads (kv=16), head_dim 256, d_ff 24576,
GeGLU MLP, vocab 256000, attention logit softcap.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    max_seq_len=8192,
    mlp_act="gelu",
    attn_logit_softcap=50.0,
    strategy="fsdp_tp",
    microbatches=8,
)
