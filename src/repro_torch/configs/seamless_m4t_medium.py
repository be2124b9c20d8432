"""seamless-m4t-medium — Meta SeamlessM4T medium [arXiv:2308.11596; hf].

Audio enc-dec: 12 encoder layers (bidirectional) over stub audio-frame
embeddings + 12 decoder layers, each with self-attention and cross-attention
(expressed as a 2-block unit, so n_layers = 24 block entries = 12 logical
decoder layers).  d_model 1024, 16 MHA heads, d_ff 4096, vocab 256206.
The speech frontend (conformer feature extractor) is a STUB per the
assignment: input_specs provides precomputed frame embeddings [B, 1024, d].
"""

from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=24,  # 12 logical decoder layers × (self-attn + cross-attn)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    max_seq_len=4096,
    unit=(
        BlockSpec("attn", "none"),
        BlockSpec("cross_attn", "dense"),
    ),
    n_encoder_layers=12,
    n_context_tokens=1024,
    strategy="fsdp_tp",
    microbatches=4,
)
