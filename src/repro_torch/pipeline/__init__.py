"""Batched DFRC experiment pipeline (mask → reservoir → ridge readout →
metrics): experiment.py for the API (``Experiment``, the WDM ensemble
``WDMExperiment``), ridge.py for the Gram/GCV readout and the streaming
chunk-loop fits, stages.py for the per-stage wall clock of a run."""

from .experiment import (Experiment, ExperimentConfig, ExperimentResult,
                         WDMExperiment, channel_states)
from .ridge import (apply_readout, fit_ridge, fit_ridge_batched,
                    fit_ridge_streaming, fit_ridge_streaming_shared,
                    fit_ridge_streaming_wdm, gram, guard_readout, solve_gcv,
                    solve_gcv_svd, with_bias)
from .stages import record_stages

__all__ = [
    "Experiment",
    "ExperimentConfig",
    "ExperimentResult",
    "WDMExperiment",
    "apply_readout",
    "channel_states",
    "fit_ridge",
    "fit_ridge_batched",
    "fit_ridge_streaming",
    "fit_ridge_streaming_shared",
    "fit_ridge_streaming_wdm",
    "gram",
    "guard_readout",
    "record_stages",
    "solve_gcv",
    "solve_gcv_svd",
    "with_bias",
]
