"""Batched DFRC experiment pipeline (mask → reservoir → ridge readout →
metrics): experiment.py for the API, ridge.py for the Gram/GCV readout,
stages.py for the per-stage wall clock of a run."""

from .experiment import Experiment, ExperimentConfig, ExperimentResult
from .ridge import (apply_readout, fit_ridge, fit_ridge_batched, gram,
                    guard_readout, solve_gcv, solve_gcv_svd, with_bias)
from .stages import record_stages

__all__ = [
    "Experiment",
    "ExperimentConfig",
    "ExperimentResult",
    "apply_readout",
    "fit_ridge",
    "fit_ridge_batched",
    "gram",
    "guard_readout",
    "record_stages",
    "solve_gcv",
    "solve_gcv_svd",
    "with_bias",
]
