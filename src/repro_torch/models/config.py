"""Model configuration for every assigned architecture family.

Port of ``repro/models/config.py`` (the JAX package's; it imports no JAX,
but the port keeps its own copy).  One dataclass covers dense / MoE / VLM /
audio enc-dec / hybrid (Mamba+attn) / xLSTM stacks; per-arch instances
live in ``repro_torch/configs/<id>.py``.  The config is a frozen, hashable
value.

The stack is described as a list of repeating *units* (``stages``); each unit
is a short heterogeneous pattern of blocks (e.g. Jamba's
[mamba ×3, attn, mamba ×4] with MoE every 2nd layer); parameters are
stacked over unit repeats, and the model loops over them.  The port runs
every block kind and MLP kind below.  The fields for
the JAX package's jit and cost-analysis knobs (``analysis_unroll``,
``strategy``) are kept so a reference config carries across field for
field; nothing reads them.  Training reads ``remat`` (``models/model.py``)
and ``microbatches`` (``runtime/steps.train_step``); the serving path
reads neither.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "cross_attn", "mamba", "mlstm", "slstm", "reservoir"]
MLPKind = Literal["none", "dense", "moe"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer inside a unit: sequence mixer + channel mixer."""

    mixer: BlockKind = "attn"
    mlp: MLPKind = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | vlm | audio | hybrid | ssm | reservoir

    # -- trunk dimensions -----------------------------------------------------
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 4096
    vocab_size: int = 32000
    max_seq_len: int = 8192

    # -- attention flavour ----------------------------------------------------
    qk_norm: bool = False       # qwen3-style per-head RMSNorm on q, k
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    causal: bool = True         # decoder; encoders set False

    # -- channel mixer ---------------------------------------------------------
    mlp_act: str = "silu"       # "silu" (SwiGLU) | "gelu" (GeGLU, gemma)

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    # -- unit pattern ----------------------------------------------------------
    # Layer kinds inside one repeating unit; n_layers % len(unit) == 0.
    # Empty tuple -> homogeneous ("attn","dense"/"moe") unit of length 1.
    unit: tuple[BlockSpec, ...] = ()

    # -- Mamba (hybrid family) -------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # -- xLSTM -----------------------------------------------------------------
    mlstm_expand: int = 2
    slstm_proj: float = 4.0 / 3.0

    # -- cross-attention context (VLM / enc-dec) --------------------------------
    n_context_tokens: int = 0   # image patches / encoder frames fed to cross-attn
    d_context: int = 0          # 0 -> d_model (stub frontends emit d_model)

    # -- encoder (audio enc-dec family) -----------------------------------------
    n_encoder_layers: int = 0

    # -- reservoir (paper-technique LM bridge) -----------------------------------
    reservoir_nodes: int = 256
    reservoir_gamma: float = 0.9
    reservoir_alpha_ratio: float = 1.0  # theta / tau_ph

    # -- numerics / execution ----------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"         # "none" | "full" | "dots"
    logit_dtype: str = "float32"
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # -- distribution defaults (overridable at launch) ----------------------------
    strategy: str = "fsdp_tp"   # fsdp_tp | fsdp | fsdp_tp_ep
    microbatches: int = 1       # grad-accumulation steps inside train_step

    # -- cost-calibration (launch/calibrate.py) -----------------------------------
    # lax.scan unroll for the unit/microbatch loops.  XLA's cost_analysis
    # counts a while body once regardless of trip count; the calibration
    # variants set n_layers = k·|unit| with analysis_unroll = k so every
    # body instance is visible to the analysis (DESIGN.md §6).
    analysis_unroll: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.unit:
            mlp = "moe" if self.n_experts else "dense"
            object.__setattr__(self, "unit", (BlockSpec("attn", mlp),))
        if self.n_layers % len(self.unit):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"unit length {len(self.unit)}"
            )
        if self.d_context == 0 and self.n_context_tokens:
            object.__setattr__(self, "d_context", self.d_model)

    # -- derived ---------------------------------------------------------------
    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def moe_layers_per_unit(self) -> int:
        return sum(1 for b in self.unit if b.mlp == "moe")

    @property
    def attn_layers(self) -> int:
        per = sum(1 for b in self.unit if b.mixer in ("attn", "cross_attn"))
        return per * self.n_units

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + trunk), for roofline MODEL_FLOPS."""
        d, v = self.d_model, self.vocab_size
        total = d * v * (1 if self.tie_embeddings else 2)
        for blk in self.unit * self.n_units:
            total += self._mixer_params(blk.mixer) + self._mlp_params(blk.mlp)
            total += 2 * d  # pre-norms
        total += d  # final norm
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (
                self._mixer_params("attn") + self._mlp_params("dense") + 2 * self.d_model
            )
            total += enc
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_moe = 3 * d * self.moe_d_ff
        per_layer_full = self.n_experts * dense_moe
        per_layer_active = self.top_k * dense_moe
        n_moe = self.moe_layers_per_unit * self.n_units
        return self.param_count() - n_moe * (per_layer_full - per_layer_active)

    def _mixer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        if kind == "attn":
            n = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
            if self.qk_norm:
                n += 2 * hd
            return n
        if kind == "cross_attn":
            dc = self.d_context or d
            return d * self.n_heads * hd + dc * 2 * self.n_kv_heads * hd + self.n_heads * hd * d
        if kind == "mamba":
            d_in = d * self.mamba_expand
            n = d * 2 * d_in                       # in_proj (x, z)
            n += d_in * self.mamba_d_conv          # depthwise conv
            n += d_in * (2 * self.mamba_d_state + 1) + d_in  # x->B,C,dt + dt bias
            n += d_in * self.mamba_d_state + d_in  # A_log, D
            n += d_in * d                          # out_proj
            return n
        if kind == "mlstm":
            d_in = d * self.mlstm_expand
            hd_in = d_in // self.n_heads
            n = d * 2 * d_in                       # up-proj (x, z)
            n += 3 * d_in * hd_in * self.n_heads // self.n_heads * 1  # placeholder, refined below
            n = d * 2 * d_in + 3 * d_in * d_in // self.n_heads + 2 * d_in + d_in * d
            return n
        if kind == "slstm":
            return 4 * d * d + 4 * d + int(2 * d * d * self.slstm_proj)
        if kind == "reservoir":
            return d * self.reservoir_nodes + self.reservoir_nodes * d
        raise ValueError(kind)

    def _mlp_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "none":
            return 0
        if kind == "dense":
            return 3 * d * self.d_ff
        if kind == "moe":
            return self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        raise ValueError(kind)
