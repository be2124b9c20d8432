"""Carry the JAX reference's models, configs and arrays into the port.

The port never imports the reference package.  These helpers read a
reference object by duck typing — its class name and its dataclass
fields — and build the port's counterpart, so a config or a fitted readout
made with the reference runs here unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.nonlinear import MODEL_REGISTRY
from .pipeline.experiment import ExperimentConfig

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


def config_from_reference(cfg) -> ExperimentConfig:
    """The port's ExperimentConfig with every field of the reference's."""
    if type(cfg).__name__ != "ExperimentConfig" or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"expected a reference ExperimentConfig, got {type(cfg).__name__}")
    fields = _init_fields(cfg)
    fields["model"] = model_from_reference(fields["model"])
    return ExperimentConfig(**fields)


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
