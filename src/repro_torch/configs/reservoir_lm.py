"""reservoir_lm — the paper's DFRC technique as a first-class LM feature.

A ~100M-param LM whose sequence mixer is the silicon-MR delayed-feedback
reservoir (core/layer.py): fixed photonic dynamics (3 WDM channels × 256
virtual nodes per layer), trained linear readout + gated MLP.  O(S) in
sequence length, so it also runs the long_500k shape.  In the port it
serves through ``launch/serve.py`` with its mixer on the scan kernel.
"""

from ..models.config import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="reservoir_lm",
    family="reservoir",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32000,
    max_seq_len=524288,
    unit=(BlockSpec("reservoir", "dense"),),
    reservoir_nodes=256,
    reservoir_gamma=0.9,
    strategy="fsdp",
    microbatches=4,
)
