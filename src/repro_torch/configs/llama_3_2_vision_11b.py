"""llama-3.2-vision-11b — Meta Llama 3.2 Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

VLM: 40 text layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab
128256; gated cross-attention to image-patch embeddings every 5th layer
(unit = 4×self-attn + 1×cross-attn, 8 units).  Vision frontend is a STUB
per the assignment: input_specs provides precomputed patch embeddings
[B, 1600, d_model].
"""

from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    max_seq_len=32768,
    rope_theta=500_000.0,
    unit=(
        BlockSpec("attn", "dense"),
        BlockSpec("attn", "dense"),
        BlockSpec("attn", "dense"),
        BlockSpec("attn", "dense"),
        BlockSpec("cross_attn", "dense"),
    ),
    n_context_tokens=1600,
    strategy="fsdp_tp",
    microbatches=8,
)
