"""Carry the JAX reference's models, configs and arrays into the port.

The port never imports the reference package.  These helpers read a
reference object by duck typing — its class name and its dataclass or
NamedTuple fields — and build the port's counterpart, so a config, a
fitted readout, a session slab or a server checkpoint made with the
reference runs here unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.accelerator import DFRCConfig
from .core.nonlinear import MODEL_REGISTRY
from .device import resolve_device
from .pipeline.experiment import ExperimentConfig
from .pipeline.session import SessionConfig, SessionState
from .robustness.faults import FaultSpec

_MODELS_BY_NAME = {cls.__name__: cls for cls in MODEL_REGISTRY.values()}


def _init_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.init}


def model_from_reference(obj):
    """The port's device model with the same class name and field values."""
    cls = _MODELS_BY_NAME.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no port of device model {type(obj).__name__!r} "
                        f"(ported: {sorted(_MODELS_BY_NAME)})")
    return cls(**_init_fields(obj))


def _config_from_reference(cfg, cls):
    if type(cfg).__name__ != cls.__name__ or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"expected a reference {cls.__name__}, got {type(cfg).__name__}")
    fields = _init_fields(cfg)
    fields["model"] = model_from_reference(fields["model"])
    return cls(**fields)


def config_from_reference(cfg) -> ExperimentConfig:
    """The port's ExperimentConfig with every field of the reference's."""
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
