"""Architecture registry and the paper's accelerator configs per task.

Port of ``repro/configs/__init__.py``:

``get_config(arch)`` -> full ModelConfig exactly as assigned (the 11
architecture files beside this one, data only: no weights);
``smoke_config(arch)`` -> reduced same-family config for CPU tests;
``runnable_cells(arch)`` -> the assignment shapes an arch runs;
``dfrc_tasks()`` -> the paper's own accelerator configs per benchmark task,
as the port's ``DFRCConfig``.

Shapes (assignment):
  train_4k     seq 4096,   global_batch 256   (training)
  prefill_32k  seq 32768,  global_batch 32    (inference prefill)
  decode_32k   seq 32768,  global_batch 128   (one-token decode, full cache)
  long_500k    seq 524288, global_batch 1     (long-context decode)

``long_500k`` needs sub-quadratic sequence mixing -> only jamba / xlstm /
reservoir_lm run it.  ``input_specs(cfg, shape)`` gives stand-ins for every
input of a shape as ``meta`` tensors (the reference's ``ShapeDtypeStruct``s:
the same shapes and dtypes, no memory), for the dry run.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from ..core import DFRCConfig, MackeyGlass, MZISine, SiliconMR

ARCHS = {
    "granite-8b": "granite_8b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-32b": "qwen3_32b",
    "gemma-7b": "gemma_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-1.3b": "xlstm_1_3b",
    "reservoir_lm": "reservoir_lm",
}

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

# Families whose sequence mixing is sub-quadratic end-to-end.
SUBQUADRATIC = {"hybrid", "ssm", "reservoir"}


def get_config(arch: str):
    mod = importlib.import_module(f"{__name__}.{ARCHS[arch]}")
    return mod.CONFIG


def list_archs(include_extras: bool = False) -> list[str]:
    names = list(ARCHS)
    return names if include_extras else [n for n in names if n != "reservoir_lm"]


def runnable_cells(arch: str) -> list[str]:
    """The assignment shapes this arch runs (long_500k only if sub-quadratic)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC:
        cells.append("long_500k")
    return cells


def smoke_config(arch: str):
    """Reduced same-family config: same unit pattern / block kinds, tiny dims."""
    cfg = get_config(arch)
    n_kv = 4 if cfg.n_kv_heads == cfg.n_heads else 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(cfg.unit),
        d_model=64,
        n_heads=4,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        max_seq_len=128,
        n_experts=min(8, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        moe_d_ff=32 if cfg.n_experts else 0,
        # Dropless at smoke scale: with S ~ 10 tokens per group the assigned
        # capacity factor would drop tokens in forward but not in per-token
        # decode, breaking the decode-vs-forward consistency check.
        capacity_factor=8.0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_context_tokens=8 if cfg.n_context_tokens else 0,
        d_context=0,
        reservoir_nodes=16,
        dtype="float32",
        remat="none",
        microbatches=1,
    )


# --------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins; no memory)
# --------------------------------------------------------------------------


def _context_spec(cfg, batch: int):
    if not cfg.n_context_tokens:
        return None
    return torch.empty((batch, cfg.n_context_tokens, cfg.d_context or cfg.d_model),
                       dtype=torch.float32, device="meta")


def input_specs(cfg, shape: str) -> dict:
    """Stand-ins for every input of ``shape``.  Keys match the step fns:

      train:   {tokens, labels, context?}
      prefill: {tokens, context?}
      decode:  {tokens, cache}   (the cache of ``init_cache`` at seq_len)
    """
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]

    def tokens(shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if info["kind"] in ("train", "prefill"):
        specs = {"tokens": tokens((b, s))}
        if info["kind"] == "train":
            specs["labels"] = tokens((b, s))
        ctx = _context_spec(cfg, b)
        if ctx is not None:
            specs["context"] = ctx
        return specs
    if info["kind"] == "decode":
        from ..models import init_cache

        return {"tokens": tokens((b, 1)),
                "cache": init_cache(cfg, b, s, context_len=cfg.n_context_tokens,
                                    device="meta")}
    raise ValueError(shape)


def dfrc_tasks() -> dict[str, dict[str, DFRCConfig]]:
    """Operating points per task: N per the paper's sensitivity analysis,
    washout 60 and the five-λ GCV grid everywhere; MackeyGlass takes ±1
    mask levels, channel equalisation quantizes to 4-PAM symbols."""

    def mk(model, n_nodes, **kw):
        lams = (1e-10, 1e-8, 1e-6, 1e-4, 1e-2)
        return DFRCConfig(model=model, n_nodes=n_nodes, washout=60, ridge_l2=lams, **kw)

    return {
        "narma10": {
            "Silicon MR": mk(SiliconMR(), 900),
            "All Optical (MZI)": mk(MZISine(), 400),
            "Electronic (MG)": mk(MackeyGlass(), 900, mask_levels=(-1.0, 1.0)),
        },
        "santa_fe": {
            "Silicon MR": mk(SiliconMR(), 40),
            "All Optical (MZI)": mk(MZISine(), 400),
            "Electronic (MG)": mk(MackeyGlass(), 400, mask_levels=(-1.0, 1.0)),
        },
        "channel_eq": {
            "Silicon MR": mk(SiliconMR(), 30, quantize=True),
            "All Optical (MZI)": mk(MZISine(), 400, quantize=True),
            "Electronic (MG)": mk(MackeyGlass(), 400, mask_levels=(-1.0, 1.0),
                                  quantize=True),
        },
    }


__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "dfrc_tasks", "get_config", "input_specs",
           "list_archs", "runnable_cells", "smoke_config"]
