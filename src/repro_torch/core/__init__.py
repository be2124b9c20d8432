"""Paper core in PyTorch: silicon-MR delayed-feedback reservoir computing.

Port of ``repro.core``: masking, the device models, reservoir states,
tasks, metrics, the host readout, the host accelerator API and the
paper's timing and power models.  Composed reservoir graphs are ROADMAP
Queue 1 item 10.
"""

from . import power, tasks, timing
from .accelerator import DFRCAccelerator, DFRCConfig
from .masking import make_mask, masked_input, mls_sequence, sample_and_hold
from .metrics import VAR_EPS, memory_capacity_score, nrmse, ser
from .nonlinear import (LINK_NONLINEARITIES, MODEL_REGISTRY, MZISine,
                        MackeyGlass, NLModel, SiliconMR, SiliconMRLiteral,
                        register_model)
from .readout import Readout, fit_readout
from .reservoir import generate_channel_states, generate_states, init_state

__all__ = [
    "DFRCAccelerator",
    "DFRCConfig",
    "LINK_NONLINEARITIES",
    "MODEL_REGISTRY",
    "MZISine",
    "MackeyGlass",
    "NLModel",
    "Readout",
    "SiliconMR",
    "SiliconMRLiteral",
    "VAR_EPS",
    "fit_readout",
    "generate_channel_states",
    "generate_states",
    "init_state",
    "make_mask",
    "masked_input",
    "memory_capacity_score",
    "mls_sequence",
    "nrmse",
    "power",
    "register_model",
    "sample_and_hold",
    "ser",
    "tasks",
    "timing",
]
