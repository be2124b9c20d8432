"""Model assembly: heterogeneous block units, stacked over repeats.

Port of ``repro/models/model.py``.  The stack is ``cfg.unit`` (a short
pattern of BlockSpecs) repeated ``cfg.n_units`` times.  Parameters for each
unit position are stacked over repeats, leaf for leaf as in the
reference's pytree (so ``convert.lm_params_from_reference`` maps one onto
the other), and the reference's ``lax.scan`` over units is a Python loop
over the stacked leading axis.  Heterogeneous patterns (Jamba's
mamba/attn interleave, xLSTM's 7:1, VLM cross-attn insertion, enc-dec) are
expressed purely in the unit pattern; an encoder-decoder config also
carries a bidirectional attention + dense-MLP encoder (``encode``).

Three entry points:
  ``forward``      tokens -> logits (+ MoE aux loss)      [train / eval]
  ``prefill``      tokens -> logits, filled cache         [serving]
  ``decode_step``  one token + cache -> logits, cache     [serving]

Under grad, ``cfg.remat`` recomputes each unit in the backward, as the
reference's ``_remat`` wraps its scanned unit step in ``jax.checkpoint``:
``"full"`` checkpoints the unit whole, ``"dots"`` saves its matmul outputs
without batch dims (``aten.mm``, ``aten.addmm``: the counterpart of
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
keeps every activation.  Losses and gradients are the same bits under all
three; the recompute runs the mixer's K1 a second time.  Without grad
(serving, evaluation) nothing is checkpointed.

Caches are dicts ``{"pos": int, "units": tuple}``, one entry per unit
position stacked over units, as in the reference; ``pos`` is a host int
(the host drives the decode loop, so no step reads a position back from
the device).  Prefill and decode update the cache's buffers in place and
return the same buffers: the reference's server donates them.  A
cross-attention entry holds the context's k, v, computed once at prefill
in the context's dtype, as the reference stores them.

Under a mesh every entry point takes the plan explicitly (``plan``: a
``parallel.sharding.Plan``; nothing here reads the active mesh).  The
params are this rank's stored blocks (``param_pspecs``); each block
gathers the leaves it uses at entry (``Plan.leaves``) and runs
tensor-parallel over "model" (``layers``, ``moe``, ``mamba``, ``xlstm``).
The reservoir blocks run whole on the rank's rows (K1 a layer on the
rank's B_local·R lanes).  In ``forward`` (a train plan) a unit's leaves are
gathered inside the function ``remat`` wraps, so a ``"full"`` recompute
gathers them again, and under ``"none"`` autograd keeps the gathered unit
for the backward; the logits are this rank's vocab block of every
position.  In serving the cache holds this rank's blocks under
``cache_pspecs``, allocated as such (``init_cache(plan=...)``), its spec
tree under ``"specs"``; each block computes on its cache blocks where they
lie (a replicated sLSTM cell gathers its own for the step), and the logits
are the last position's, every vocab column on every "model" rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core import layer as reservoir_layer
from ..device import resolve_device, resolve_dtype
from . import layers, mamba, moe, xlstm
from .config import BlockSpec, ModelConfig

_ENCODER_BLOCK = BlockSpec("attn", "dense")

# --------------------------------------------------------------------------
# Param defs per block
# --------------------------------------------------------------------------


def _mixer_defs(cfg, kind: str) -> dict:
    if kind == "attn":
        return layers.attn_defs(cfg)
    if kind == "cross_attn":
        return layers.cross_attn_defs(cfg)
    if kind == "mamba":
        return mamba.mamba_defs(cfg)
    if kind == "mlstm":
        return xlstm.mlstm_defs(cfg)
    if kind == "slstm":
        return xlstm.slstm_defs(cfg)
    if kind == "reservoir":
        return reservoir_layer.reservoir_defs(cfg)
    raise ValueError(kind)


def _mlp_defs(cfg, kind: str) -> dict:
    if kind == "none":
        return {}
    if kind == "dense":
        return layers.mlp_defs(cfg)
    if kind == "moe":
        return moe.moe_defs(cfg)
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


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, *, device=None) -> dict:
    """The params dict of ``cfg`` on ``device`` (default ``cuda``), drawn
    from ``generator`` (a ``torch.Generator`` on that device).

    Structure as the reference's: ``{"embed": {...}, "units": (one dict a
    unit position, each leaf stacked [n_units, ...]), "final_norm":
    {"scale"}}``, and with an encoder ``"encoder": {"units": (one dict
    stacked [n_encoder_layers, ...],), "final_norm"}``; every leaf f32.
    The draws differ from the reference's ``jax.random`` bits; their
    distributions are the same.
    """
    dev = resolve_device(device)

    def stacked_unit(unit, n_repeats):
        return tuple(layers.init_from_defs(_block_defs(cfg, blk), generator, lead=(n_repeats,),
                                           device=dev) for blk in unit)

    params: dict[str, Any] = {
        "embed": layers.init_from_defs(layers.embed_defs(cfg), generator, device=dev)}
    params["units"] = stacked_unit(cfg.unit, cfg.n_units)
    params["final_norm"] = layers.init_from_defs(layers.norm_defs(cfg), generator, device=dev)
    if cfg.n_encoder_layers:
        params["encoder"] = {
            "units": stacked_unit((_ENCODER_BLOCK,), cfg.n_encoder_layers),
            "final_norm": layers.init_from_defs(layers.norm_defs(cfg), generator, device=dev)}
    return params


class LeafDef(NamedTuple):
    """One param leaf's full shape and logical axes."""

    shape: tuple
    axes: tuple


def map_param_defs(fn, cfg: ModelConfig):
    """``init_params``'s structure with ``fn(LeafDef)`` a leaf, from the
    defs alone (nothing is drawn).  Stacked unit leaves are [n_units, ...]
    with a leading ``"layers"`` axis, as in the reference's
    ``param_logical_axes``."""

    def tree(defs, lead=(), lead_axes=()):
        return {name: fn(LeafDef((*lead, *shape), (*lead_axes, *axes)))
                for name, (shape, axes, _init) in defs.items()}

    def stacked_unit(unit, n_repeats):
        return tuple(tree(_block_defs(cfg, blk), (n_repeats,), ("layers",)) for blk in unit)

    out: dict[str, Any] = {"embed": tree(layers.embed_defs(cfg)),
                           "units": stacked_unit(cfg.unit, cfg.n_units),
                           "final_norm": tree(layers.norm_defs(cfg))}
    if cfg.n_encoder_layers:
        out["encoder"] = {"units": stacked_unit((_ENCODER_BLOCK,), cfg.n_encoder_layers),
                          "final_norm": tree(layers.norm_defs(cfg))}
    return out


def param_logical_axes(cfg: ModelConfig) -> dict:
    """Same tree structure as init_params, with logical-axis tuples as leaves.

    Stacked unit leaves get a leading ``"layers"`` axis entry (never sharded).
    """
    return map_param_defs(lambda leaf: leaf.axes, cfg)


def meta_params(cfg: ModelConfig) -> dict:
    """``init_params``'s tree as f32 ``meta`` tensors: shapes, no data."""
    return map_param_defs(lambda leaf: torch.empty(leaf.shape, device="meta"), cfg)


def activation_axes(cfg=None) -> tuple[str, ...]:
    """The mesh axes [B, ...] activations shard their batch over."""
    return ("pod", "data", "model") if cfg is not None and cfg.strategy == "zero3" \
        else ("pod", "data")


# --------------------------------------------------------------------------
# Block application
# --------------------------------------------------------------------------


def _apply_block(cfg, blk, p, x, *, positions, context=None, cache=None, plan=None,
                 seq=None):
    """Pre-norm mixer + residual, pre-norm MLP + residual.

    Returns (x, new_cache, aux).  ``cache`` is the mixer state for this block
    (None in a plain forward); a cross-attention block's cache is its
    context's (k, v), else it computes them from ``context``.  ``plan``: a
    serving plan (``p`` this rank's leaves as the plan hands them over),
    ``seq`` the sequence slice an attention cache block holds.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(x, p["norm_mixer"], cfg.norm_eps)
    mp = _split(p, "mixer")
    new_cache = None
    if blk.mixer == "attn":
        y, new_cache = layers.apply_attn(cfg, mp, h, positions=positions,
                                         cache=cache, causal=cfg.causal, plan=plan, seq=seq)
    elif blk.mixer == "cross_attn":
        if cache is not None:
            ctx_kv = new_cache = cache        # computed at prefill
        elif context is None:
            raise ValueError(f"{cfg.name}: a cross-attention block needs a context")
        else:
            ctx_kv = layers.context_kv(cfg, mp, context, plan)
        y = layers.apply_cross_attn(cfg, mp, h, context_kv=ctx_kv, plan=plan, seq=seq)
    elif blk.mixer == "mamba":
        y, new_cache = mamba.apply_mamba(cfg, mp, h, cache=cache, plan=plan)
    elif blk.mixer == "mlstm":
        y, new_cache = xlstm.apply_mlstm(cfg, mp, h, cache=cache, plan=plan)
    elif blk.mixer == "slstm":
        y, new_cache = xlstm.apply_slstm(cfg, mp, h, cache=cache, plan=plan)
    elif blk.mixer == "reservoir":
        y, new_cache = reservoir_layer.apply_reservoir(cfg, mp, h, cache=cache)
    else:
        raise ValueError(blk.mixer)
    x = x + y

    if blk.mlp != "none":
        h = layers.rmsnorm(x, p["norm_mlp"], cfg.norm_eps)
        if blk.mlp == "dense":
            y = layers.apply_mlp(cfg, _split(p, "mlp"), h, plan=plan)
        elif blk.mlp == "moe":
            y, aux = moe.apply_moe(cfg, _split(p, "mlp"), h, plan=plan)
        else:
            raise ValueError(blk.mlp)
        x = x + y
    return x, new_cache, aux


def _unit_params(units: tuple, u: int, plan=None, path=("units",)) -> tuple:
    """Unit repeat ``u``'s params: each unit position's leaves at index u;
    under a plan, as the unit's blocks use them (``Plan.leaves`` of the
    subtree at ``path``)."""
    if plan is None:
        return tuple({k: v[u] for k, v in pos.items()} for pos in units)
    return tuple(plan.leaves(pos, (*path, i), index=u) for i, pos in enumerate(units))


_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat`` (see the module doc); ``fn`` itself when
    grad is off or ``remat`` is ``"none"``."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, not {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             **kw)


# --------------------------------------------------------------------------
# Forward (train / eval)
# --------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: dict, tokens, *, context=None, plan=None):
    """tokens [B, S] -> (logits [B, S, V], moe_aux scalar).

    ``context`` [B, T, d]: image-patch / audio-frame stub embeddings for
    cross-attention families (encoded first if the config has an encoder).
    ``plan``: a train plan; ``params`` are then this rank's stored blocks,
    ``tokens`` (and ``context``) its rows, and the logits its vocab block
    (module doc).
    """
    embed = params["embed"] if plan is None else plan.leaves(params["embed"], ("embed",))
    x = layers.embed_tokens(cfg, embed, tokens, plan=plan)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    if cfg.n_encoder_layers:
        context = encode(cfg, params, context, plan=plan)

    def unit_step(x, aux, u):
        unit_params = _unit_params(params["units"], u, plan)
        for pos, blk in enumerate(cfg.unit):
            x, _, a = _apply_block(cfg, blk, unit_params[pos], x, positions=positions,
                                   context=context, plan=plan)
            aux = aux + a
        return x, aux

    step = _remat(cfg, unit_step)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(cfg.n_units):
        x, aux = step(x, aux, u)
    norm = params["final_norm"] if plan is None else plan.leaves(params["final_norm"],
                                                                 ("final_norm",))
    x = layers.rmsnorm(x, norm["scale"], cfg.norm_eps)
    return layers.logits_from_hidden(cfg, embed, x, plan=plan), aux


def _encoder_view(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, causal=False, unit=())


def encode(cfg: ModelConfig, params: dict, frames, *, plan=None):
    """Bidirectional encoder over stub frame embeddings [B, T, d], in
    ``cfg.dtype``; under a plan on this rank's blocks, each unit's leaves
    gathered inside the function ``remat`` wraps (module doc)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs context frames")
    enc_cfg = _encoder_view(cfg)
    x = frames.to(resolve_dtype(cfg.dtype))
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    enc = params["encoder"]

    def unit_step(x, u):
        (unit_params,) = _unit_params(enc["units"], u, plan, ("encoder", "units"))
        return _apply_block(enc_cfg, _ENCODER_BLOCK, unit_params, x, positions=positions,
                            plan=plan)[0]

    step = _remat(cfg, unit_step)
    for u in range(cfg.n_encoder_layers):
        x = step(x, u)
    norm = enc["final_norm"] if plan is None else plan.leaves(enc["final_norm"],
                                                              ("encoder", "final_norm"))
    return layers.rmsnorm(x, norm["scale"], cfg.norm_eps)


# --------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# --------------------------------------------------------------------------


def cache_defs(cfg: ModelConfig, batch: int, max_len: int, context_len: int = 0) -> tuple:
    """Each unit position's stacked cache buffers as (shape, dtype, fill):
    attention and cross-attention k, v [n_units, B, length, KV, hd] in
    ``cfg.dtype``, the recurrent states (and the Mamba / mLSTM conv
    windows) f32, as the reference's."""
    u = cfg.n_units
    out = []
    for blk in cfg.unit:
        if blk.mixer in ("attn", "cross_attn"):
            length = max_len if blk.mixer == "attn" else context_len
            kv = ((batch, length, cfg.n_kv_heads, cfg.head_dim), resolve_dtype(cfg.dtype), 0.0)
            defs = (kv, kv)
        elif blk.mixer == "mamba":
            defs = mamba.mamba_cache_defs(cfg, batch)
        elif blk.mixer == "mlstm":
            defs = xlstm.mlstm_cache_defs(cfg, batch)
        elif blk.mixer == "slstm":
            defs = xlstm.slstm_cache_defs(cfg, batch)
        elif blk.mixer == "reservoir":
            n, r = cfg.reservoir_nodes, reservoir_layer._n_channels(cfg)
            defs = (((batch, r, n), torch.float32, 0.0), ((batch, r), torch.float32, 0.0))
        else:
            raise ValueError(blk.mixer)
        out.append(tuple(((u, *shape), dt, fill) for shape, dt, fill in defs))
    return tuple(out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, context_len: int = 0,
               device=None, plan=None) -> dict:
    """Stacked per-unit-position cache (``cache_defs``; ``pos`` tracks the
    fill) on ``device`` (default ``cuda``).

    Under a serving plan, ``batch`` is the global batch, and only this
    rank's block of each buffer under ``cache_pspecs`` is allocated; the
    spec tree rides along as ``"specs"``."""
    from ..parallel import sharding

    dev = resolve_device(device)
    defs = cache_defs(cfg, batch, max_len, context_len)
    if plan is None:
        return {"pos": 0, "units": tuple(tuple(torch.full(shape, fill, dtype=dt, device=dev)
                                               for shape, dt, fill in entry) for entry in defs)}
    shapes = {"pos": 0, "units": tuple(tuple(torch.empty(shape, dtype=dt, device="meta")
                                             for shape, dt, _ in entry) for entry in defs)}
    specs = sharding.cache_pspecs(cfg, plan.mesh, shapes)
    units = tuple(tuple(torch.full(sharding.local_shape(shape, spec, plan.mesh), fill,
                                   dtype=dt, device=dev)
                        for (shape, dt, fill), spec in zip(entry, entry_specs, strict=True))
                  for entry, entry_specs in zip(defs, specs["units"], strict=True))
    return {"pos": 0, "units": units, "specs": specs}


def _mixer_cache(blk, unit_cache, u: int, pos: int):
    """Unit repeat ``u``'s mixer cache: views into the stacked buffers
    (an attention cache with its write position)."""
    if blk.mixer == "attn":
        k_buf, v_buf = unit_cache
        return (k_buf[u], v_buf[u], pos)
    return tuple(leaf[u] for leaf in unit_cache)


def _store_cache(blk, unit_cache, u: int, new_cache) -> None:
    """Write a block's new state into the stacked buffers (in their dtype,
    as the reference casts it); an attention block wrote its k, v in place
    already, and a cross-attention block's decode hands back the buffers
    themselves (``copy_`` returns at once on the same memory)."""
    if blk.mixer != "attn":
        for leaf, new in zip(unit_cache, new_cache, strict=True):
            leaf[u].copy_(new)


def _forward_cached(cfg, params, cache, tokens, *, context=None, plan=None):
    """Shared prefill/decode body: runs [B, S] tokens through cached blocks.
    With ``context`` (prefill) each cross-attention block computes its
    context's k, v and stores them in the cache.  ``plan``: a serving
    plan (``_forward_sharded``)."""
    if plan is not None:
        return _forward_sharded(cfg, params, cache, tokens, context, plan)
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    pos0 = cache["pos"]
    positions = pos0 + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    if cfg.n_encoder_layers and context is not None:
        context = encode(cfg, params, context)
    for u in range(cfg.n_units):
        unit_params = _unit_params(params["units"], u)
        for pos, blk in enumerate(cfg.unit):
            blk_cache = _mixer_cache(blk, cache["units"][pos], u, pos0)
            if blk.mixer == "cross_attn" and context is not None:
                blk_cache = layers.context_kv(cfg, _split(unit_params[pos], "mixer"), context)
            x, nc, _ = _apply_block(cfg, blk, unit_params[pos], x,
                                    positions=positions, cache=blk_cache)
            _store_cache(blk, cache["units"][pos], u, nc)
    x = layers.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = layers.logits_from_hidden(cfg, params["embed"], x)
    return logits, {"pos": pos0 + tokens.shape[1], "units": cache["units"]}


def _sharded_block(cfg, blk, p, x, *, positions, unit_cache, unit_specs, u, pos0, context,
                   plan):
    """One block of ``_forward_sharded`` at unit repeat ``u``, on its cache
    blocks (``unit_specs`` their stacked specs), which it updates in place."""
    from ..parallel import sharding

    leaves = tuple(leaf[u] for leaf in unit_cache)
    specs = tuple(sharding.P(*spec[1:]) for spec in unit_specs)
    seq = None
    if blk.mixer in ("attn", "cross_attn"):
        entry = specs[0][1]
        seq = layers.SeqSlice(sharding.entry_axes(entry),
                              plan.block_index(entry) * leaves[0].shape[1])
    if blk.mixer == "attn":
        blk_cache = (leaves[0], leaves[1], pos0)
    elif blk.mixer == "cross_attn" and context is not None:
        # prefill: attend over the whole context's k, v; keep this rank's slice
        blk_cache = layers.context_kv(cfg, _split(p, "mixer"), context)
        span = leaves[0].shape[1]
        for leaf, new in zip(leaves, blk_cache, strict=True):
            leaf.copy_(new[:, seq.offset:seq.offset + span])
        seq = None
    else:
        blk_cache = leaves
    x, nc, _ = _apply_block(cfg, blk, p, x, positions=positions, cache=blk_cache, plan=plan,
                            seq=seq)
    if blk.mixer not in ("attn", "cross_attn"):
        for leaf, new in zip(leaves, nc, strict=True):
            leaf.copy_(new)
    return x


def _forward_sharded(cfg, params, cache, tokens, context, plan):
    """``_forward_cached`` on this rank of a serving plan: params its stored
    blocks, ``cache`` its cache blocks (``init_cache(plan=...)``), tokens
    and context its rows.  Returns (the last position's logits [B, 1, V],
    cache)."""
    embed = plan.leaves(params["embed"], ("embed",))
    x = layers.embed_tokens(cfg, embed, tokens, plan=plan)
    pos0 = cache["pos"]
    positions = pos0 + torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    if cfg.n_encoder_layers and context is not None:
        context = encode(cfg, params, context, plan=plan)
    for u in range(cfg.n_units):
        for pos, blk in enumerate(cfg.unit):
            p = plan.leaves(params["units"][pos], ("units", pos), index=u)
            x = _sharded_block(cfg, blk, p, x, positions=positions,
                               unit_cache=cache["units"][pos],
                               unit_specs=cache["specs"]["units"][pos], u=u, pos0=pos0,
                               context=context, plan=plan)
    norm = plan.leaves(params["final_norm"], ("final_norm",))
    x = layers.rmsnorm(x, norm["scale"], cfg.norm_eps)
    logits = layers.logits_from_hidden(cfg, embed, x, plan=plan)
    return logits, {**cache, "pos": pos0 + tokens.shape[1]}


def prefill(cfg: ModelConfig, params: dict, tokens, *, max_len: int, context=None, plan=None,
            batch: int | None = None):
    """tokens [B, S] (and ``context`` [B, T, d] for a cross-attention
    family) -> (logits [B, S, V], cache filled to S of ``max_len``).

    Under a serving plan: this rank's param blocks, its rows of a global
    batch of ``batch`` rows (default: the rows given times the batch axes'
    size, i.e. a cut), and (logits [B_local, 1, V] of the last position,
    this rank's cache blocks)."""
    if plan is not None and batch is None:
        batch = tokens.shape[0] * plan.row_blocks
    cache = init_cache(cfg, tokens.shape[0] if plan is None else batch, max_len,
                       context_len=(context.shape[1] if context is not None else 0),
                       device=tokens.device, plan=plan)
    if context is not None:
        # the stored k, v take the (encoded) context's dtype, as the reference's
        ctx_dt = resolve_dtype(cfg.dtype) if cfg.n_encoder_layers else context.dtype
        cache["units"] = tuple(
            tuple(buf.to(ctx_dt) for buf in entry) if blk.mixer == "cross_attn" else entry
            for blk, entry in zip(cfg.unit, cache["units"], strict=True))
    return _forward_cached(cfg, params, cache, tokens, context=context, plan=plan)


def decode_step(cfg: ModelConfig, params: dict, cache, tokens, *, plan=None):
    """One decode step: tokens [B, 1] + cache -> (logits [B, 1, V], cache).
    The cache's buffers are updated in place.  Under a serving plan, this
    rank's param blocks, rows and cache blocks (``prefill``)."""
    return _forward_cached(cfg, params, cache, tokens, plan=plan)
