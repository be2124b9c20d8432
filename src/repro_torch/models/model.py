"""Model assembly: heterogeneous block units, stacked over repeats.

Port of ``repro/models/model.py``.  The stack is ``cfg.unit`` (a short
pattern of BlockSpecs) repeated ``cfg.n_units`` times.  Parameters for each
unit position are stacked over repeats, leaf for leaf as in the
reference's pytree (so ``convert.lm_params_from_reference`` maps one onto
the other), and the reference's ``lax.scan`` over units is a Python loop
over the stacked leading axis.

Three entry points:
  ``forward``      tokens -> logits (+ MoE aux loss)      [train / eval]
  ``prefill``      tokens -> logits, filled cache         [serving]
  ``decode_step``  one token + cache -> logits, cache     [serving]

Caches are dicts ``{"pos": int, "units": tuple}``, one entry per unit
position stacked over units, as in the reference; ``pos`` is a host int
(the host drives the decode loop, so no step reads a position back from
the device).  Prefill and decode update the cache's buffers in place and
return the same buffers: the reference's server donates them.

Blocks ported: the ``attn`` and ``reservoir`` mixers, and the ``dense``
MLP (or none).  ``cross_attn``, ``mamba``, ``mlstm``, ``slstm``, ``moe``
and the encoder raise NotImplementedError (ROADMAP.md Queue 1, item 13b).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core import layer as reservoir_layer
from ..device import resolve_device, resolve_dtype
from . import layers
from .config import ModelConfig

_UNPORTED = "is not ported yet (ROADMAP.md Queue 1, item 13b)"


def _unported(what: str):
    return NotImplementedError(f"{what} {_UNPORTED}")


# --------------------------------------------------------------------------
# Param defs per block
# --------------------------------------------------------------------------


def _mixer_defs(cfg, kind: str) -> dict:
    if kind == "attn":
        return layers.attn_defs(cfg)
    if kind == "reservoir":
        return reservoir_layer.reservoir_defs(cfg)
    if kind in ("cross_attn", "mamba", "mlstm", "slstm"):
        raise _unported(f"the {kind!r} mixer")
    raise ValueError(kind)


def _mlp_defs(cfg, kind: str) -> dict:
    if kind == "none":
        return {}
    if kind == "dense":
        return layers.mlp_defs(cfg)
    if kind == "moe":
        raise _unported("the 'moe' MLP")
    raise ValueError(kind)


def _block_defs(cfg, blk) -> dict:
    defs = {"norm_mixer": ((cfg.d_model,), ("embed",), "zeros")}
    defs.update({f"mixer/{k}": v for k, v in _mixer_defs(cfg, blk.mixer).items()})
    if blk.mlp != "none":
        defs["norm_mlp"] = ((cfg.d_model,), ("embed",), "zeros")
        defs.update({f"mlp/{k}": v for k, v in _mlp_defs(cfg, blk.mlp).items()})
    return defs


def _split(params: dict, prefix: str) -> dict:
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.n_encoder_layers:
        raise _unported("the encoder (n_encoder_layers > 0)")
    for blk in cfg.unit:
        _block_defs(cfg, blk)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> dict:
    """The params dict of ``cfg`` on ``device`` (default ``cuda``), drawn
    from ``generator`` (a ``torch.Generator`` on that device).

    Structure as the reference's: ``{"embed": {...}, "units": (one dict a
    unit position, each leaf stacked [n_units, ...]), "final_norm":
    {"scale"}}``, every leaf f32.  The draws differ from the reference's
    ``jax.random`` bits; their distributions are the same.
    """
    dev = resolve_device(device)
    _check_ported(cfg)
    params: dict[str, Any] = {
        "embed": layers.init_from_defs(layers.embed_defs(cfg), generator, device=dev)}
    params["units"] = tuple(
        layers.init_from_defs(_block_defs(cfg, blk), generator, lead=(cfg.n_units,), device=dev)
        for blk in cfg.unit)
    params["final_norm"] = layers.init_from_defs(layers.norm_defs(cfg), generator, device=dev)
    return params


# --------------------------------------------------------------------------
# Block application
# --------------------------------------------------------------------------


def _apply_block(cfg, blk, p, x, *, positions, cache=None):
    """Pre-norm mixer + residual, pre-norm MLP + residual.

    Returns (x, new_cache, aux).  ``cache`` is the mixer state for this block
    (None in a plain forward).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(x, p["norm_mixer"], cfg.norm_eps)
    mp = _split(p, "mixer")
    if blk.mixer == "attn":
        y, new_cache = layers.apply_attn(cfg, mp, h, positions=positions,
                                         cache=cache, causal=cfg.causal)
    elif blk.mixer == "reservoir":
        y, new_cache = reservoir_layer.apply_reservoir(cfg, mp, h, cache=cache)
    elif blk.mixer in ("cross_attn", "mamba", "mlstm", "slstm"):
        raise _unported(f"the {blk.mixer!r} mixer")
    else:
        raise ValueError(blk.mixer)
    x = x + y

    if blk.mlp != "none":
        if blk.mlp != "dense":
            raise _unported(f"the {blk.mlp!r} MLP")
        h = layers.rmsnorm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + layers.apply_mlp(cfg, _split(p, "mlp"), h)
    return x, new_cache, aux


def _unit_params(params: dict, u: int) -> tuple:
    """Unit repeat ``u``'s params: each unit position's leaves at index u."""
    return tuple({k: v[u] for k, v in pos.items()} for pos in params["units"])


# --------------------------------------------------------------------------
# Forward (train / eval)
# --------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: dict, tokens, *, context=None):
    """tokens [B, S] -> (logits [B, S, V], moe_aux scalar)."""
    if context is not None or cfg.n_encoder_layers:
        raise _unported("cross-attention context")
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(cfg.n_units):
        unit_params = _unit_params(params, u)
        for pos, blk in enumerate(cfg.unit):
            x, _, a = _apply_block(cfg, blk, unit_params[pos], x, positions=positions)
            aux = aux + a
    x = layers.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return layers.logits_from_hidden(cfg, params["embed"], x), aux


# --------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, context_len: int = 0,
               device=None) -> dict:
    """Stacked per-unit-position cache (zeros; ``pos`` tracks the fill) on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    _check_ported(cfg)
    if context_len:
        raise _unported("cross-attention context")
    u = cfg.n_units
    kv_dt = resolve_dtype(cfg.dtype)
    cache_units = []
    for blk in cfg.unit:
        if blk.mixer == "attn":
            shape = (u, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache_units.append((torch.zeros(shape, dtype=kv_dt, device=dev),
                                torch.zeros(shape, dtype=kv_dt, device=dev)))
        elif blk.mixer == "reservoir":
            n, r = cfg.reservoir_nodes, reservoir_layer._n_channels(cfg)
            cache_units.append((torch.zeros((u, batch, r, n), dtype=torch.float32, device=dev),
                                torch.zeros((u, batch, r), dtype=torch.float32, device=dev)))
        elif blk.mixer in ("cross_attn", "mamba", "mlstm", "slstm"):
            raise _unported(f"the {blk.mixer!r} mixer's cache")
        else:
            raise ValueError(blk.mixer)
    return {"pos": 0, "units": tuple(cache_units)}


def _mixer_cache(blk, unit_cache, u: int, pos: int):
    """Unit repeat ``u``'s mixer cache: views into the stacked buffers
    (an attention cache with its write position)."""
    if blk.mixer == "attn":
        k_buf, v_buf = unit_cache
        return (k_buf[u], v_buf[u], pos)
    return tuple(leaf[u] for leaf in unit_cache)


def _store_cache(blk, unit_cache, u: int, new_cache) -> None:
    """Write a reservoir block's new carry into the stacked buffers; an
    attention block wrote its k, v in place already."""
    if blk.mixer != "attn":
        for leaf, new in zip(unit_cache, new_cache):
            leaf[u].copy_(new)


def _forward_cached(cfg, params, cache, tokens):
    """Shared prefill/decode body: runs [B, S] tokens through cached blocks."""
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    pos0 = cache["pos"]
    positions = pos0 + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for u in range(cfg.n_units):
        unit_params = _unit_params(params, u)
        for pos, blk in enumerate(cfg.unit):
            blk_cache = _mixer_cache(blk, cache["units"][pos], u, pos0)
            x, nc, _ = _apply_block(cfg, blk, unit_params[pos], x,
                                    positions=positions, cache=blk_cache)
            _store_cache(blk, cache["units"][pos], u, nc)
    x = layers.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = layers.logits_from_hidden(cfg, params["embed"], x)
    return logits, {"pos": pos0 + tokens.shape[1], "units": cache["units"]}


def prefill(cfg: ModelConfig, params: dict, tokens, *, max_len: int, context=None):
    """tokens [B, S] -> (logits [B, S, V], cache filled to S of ``max_len``)."""
    if context is not None:
        raise _unported("cross-attention context")
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    return _forward_cached(cfg, params, cache, tokens)


def decode_step(cfg: ModelConfig, params: dict, cache, tokens):
    """One decode step: tokens [B, 1] + cache -> (logits [B, 1, V], cache).
    The cache's buffers are updated in place."""
    return _forward_cached(cfg, params, cache, tokens)
