"""Carry the JAX reference's models, configs and arrays into the port.

The port never imports the reference package.  These helpers read a
reference object by duck typing — its class name and its dataclass or
NamedTuple fields — and build the port's counterpart, so a config, a
fitted readout, a session slab, a server checkpoint or an LM's params and
decode cache made with the reference runs here unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import devices
from .core.accelerator import DFRCConfig
from .core.graph import ReservoirGraph, ReservoirStage
from .core.nonlinear import MODEL_REGISTRY
from .device import resolve_device
from .pipeline.experiment import ExperimentConfig
from .pipeline.session import SessionConfig, SessionState
from .robustness.faults import FaultSpec


def _init_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.init}


def model_from_reference(obj):
    """The port's device model with the same class name and field values,
    looked up in ``MODEL_REGISTRY`` as it stands at the call."""
    by_name = {cls.__name__: cls for cls in MODEL_REGISTRY.values()}
    cls = by_name.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no port of device model {type(obj).__name__!r} "
                        f"(ported: {sorted(by_name)})")
    return cls(**_init_fields(obj))


def _config_from_reference(cfg, cls):
    if type(cfg).__name__ != cls.__name__ or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"expected a reference {cls.__name__}, got {type(cfg).__name__}")
    fields = _init_fields(cfg)
    fields["model"] = model_from_reference(fields["model"])
    if fields.get("topology") is not None:
        fields["topology"] = graph_from_reference(fields["topology"])
    return cls(**fields)


def graph_from_reference(obj) -> ReservoirGraph:
    """The port's ReservoirGraph of a reference ReservoirGraph (or of one
    ReservoirStage, as a one-stage graph): the same stages, each stage's
    model through ``model_from_reference``."""
    def stage(st):
        if type(st).__name__ != "ReservoirStage" or not dataclasses.is_dataclass(st):
            raise TypeError(f"expected a reference ReservoirStage, got {type(st).__name__}")
        fields = _init_fields(st)
        fields["model"] = model_from_reference(fields["model"])
        return ReservoirStage(**fields)

    if type(obj).__name__ == "ReservoirGraph":
        return ReservoirGraph(stages=tuple(stage(st) for st in obj.stages))
    return ReservoirGraph(stages=(stage(obj),))


def config_from_reference(cfg) -> ExperimentConfig:
    """The port's ExperimentConfig with every field of the reference's (a
    topology's stages carried across by ``graph_from_reference``)."""
    return _config_from_reference(cfg, ExperimentConfig)


def dfrc_config_from_reference(cfg) -> DFRCConfig:
    """The port's DFRCConfig with every field of the reference's."""
    return _config_from_reference(cfg, DFRCConfig)


def session_config_from_reference(cfg) -> SessionConfig:
    """The port's SessionConfig with every field of the reference's."""
    return _config_from_reference(cfg, SessionConfig)


def _leaves(obj, names) -> list[np.ndarray]:
    """The named leaves of a NamedTuple-like object as host arrays."""
    missing = [n for n in names if not hasattr(obj, n)]
    if missing:
        raise TypeError(f"{type(obj).__name__} lacks the fields {missing}")
    return [np.asarray(getattr(obj, n)) for n in names]


def dev_params_from_reference(params, *, device=None) -> devices.CMTSweepParams:
    """The port's CMTSweepParams from a reference one (leaves floats or
    numpy/JAX arrays), each leaf an f32 tensor on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    return devices.CMTSweepParams(*(torch.tensor(a, dtype=torch.float32, device=dev)
                                    for a in _leaves(params, devices.CMTSweepParams._fields)))


def fault_spec_from_reference(spec, *, device=None) -> FaultSpec:
    """The port's FaultSpec from a reference FaultSpec (or any object with
    its fields as arrays), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return FaultSpec(*(torch.tensor(a, device=dev) for a in _leaves(spec, FaultSpec._fields)))


def session_state_from_reference(state, *, device=None) -> SessionState:
    """The port's SessionState from a reference slab (or any object with its
    fields as arrays, e.g. a restored checkpoint's), on ``device`` (default
    ``cuda``).  The reference carries its Gram feature-padded to its TPU
    tile, ``g`` [B, Fq, Fq] and ``c`` [B, Fq, C]; the port's are cut to
    F = ``w.shape[1]``."""
    dev = resolve_device(device)
    leaves = dict(zip(SessionState._fields, _leaves(state, SessionState._fields)))
    f = leaves["w"].shape[1]
    leaves["g"] = leaves["g"][:, :f, :f]
    leaves["c"] = leaves["c"][:, :f]
    return SessionState(**{k: torch.tensor(v, device=dev) for k, v in leaves.items()})


def readout_from_numpy(w, *, device=None) -> torch.Tensor:
    """Readout weights [..., N + 1(, C)] as a float32 tensor."""
    return torch.tensor(np.asarray(w, dtype=np.float32), device=device)


def mask_from_numpy(m, *, device=None) -> torch.Tensor:
    """An input mask [N], or a stack [R, N] (per-lane masks, e.g. a reference
    ``WDMExperiment``'s ``masks``), as a float32 tensor."""
    m = np.asarray(m, dtype=np.float32)
    if m.ndim not in (1, 2):
        raise ValueError(f"a mask is [N] or a mask stack [R, N], got shape {m.shape}")
    return torch.tensor(m, device=device)


def _tensor_from_array(a, dev: torch.device) -> torch.Tensor:
    """A host or JAX array as a tensor of the same dtype (bf16 through its
    bits: numpy has no bfloat16 of its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def lm_params_from_reference(params, *, device=None) -> dict:
    """The port's LM params (``repro_torch.models.init_params``' layout) from
    a reference params pytree, its leaves numpy or JAX arrays: the same
    nesting (``{"embed", "units": (one dict a unit position, leaves stacked
    over units), "final_norm"}``, and an encoder-decoder's ``"encoder"``
    subtree), each leaf a tensor of its dtype on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        return _tensor_from_array(node, dev)

    missing = {"embed", "units", "final_norm"} - set(params)
    if missing:
        raise TypeError(f"not a reference LM params tree: no {sorted(missing)}")
    return walk(params)


def train_state_from_reference(state, *, device=None) -> dict:
    """The port's train state (``runtime.steps.init_train_state``' layout)
    from a reference one (``repro.runtime.steps.init_train_state``, or a
    reference step's output): params and the f32 moments ``opt.m``,
    ``opt.v`` through ``lm_params_from_reference``, and ``step`` an int32
    scalar tensor, all on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    missing = {"params", "opt", "step"} - set(state)
    if missing:
        raise TypeError(f"not a reference train state: no {sorted(missing)}")
    return {"params": lm_params_from_reference(state["params"], device=dev),
            "opt": {k: lm_params_from_reference(state["opt"][k], device=dev)
                    for k in ("m", "v")},
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=dev)}


_CACHE_LEAVES = {"attn": 2, "cross_attn": 2, "mamba": 2, "mlstm": 4, "slstm": 4}


def lm_cache_from_reference(cfg, cache, *, device=None) -> dict:
    """The port's decode cache from a reference one (``repro.models.init_cache``
    layout, after a prefill or decode step): ``pos`` as a host int, each
    unit position's stacked buffers (attention and cross-attention k, v;
    Mamba's conv window and h; mLSTM's conv window, C, n, m; sLSTM's c, n,
    m, h) as tensors of their dtype on ``device`` (default ``cuda``).  A
    reservoir block's ``(s_prev, s_last)`` must satisfy the
    reference's invariant ``s_last == s_prev[..., -1]`` (the port carries
    ``s_prev`` alone and derives ``s_last``); raises ValueError if not."""
    dev = resolve_device(device)
    units = []
    for blk, entry in zip(cfg.unit, cache["units"], strict=True):
        leaves = tuple(_tensor_from_array(a, dev) for a in entry)
        if blk.mixer == "reservoir":
            s_prev, s_last = leaves
            if not torch.equal(s_last, s_prev[..., -1]):
                raise ValueError("reservoir cache breaks s_last == s_prev[..., -1]; the port "
                                 "carries s_prev alone and cannot hold a separate s_last")
        elif len(leaves) != _CACHE_LEAVES[blk.mixer]:
            raise ValueError(f"a {blk.mixer!r} cache has {_CACHE_LEAVES[blk.mixer]} buffers, "
                             f"got {len(leaves)}")
        units.append(leaves)
    return {"pos": int(np.asarray(cache["pos"])), "units": tuple(units)}
