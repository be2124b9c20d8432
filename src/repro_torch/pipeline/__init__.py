"""Batched DFRC experiment pipeline (mask → reservoir → ridge readout →
metrics): experiment.py for the API (``Experiment``, the WDM ensemble
``WDMExperiment``), ridge.py for the Gram/GCV readout and the streaming
chunk-loop fits (composed reservoir graphs included), session.py for the
online-learning sessions a server ticks, stages.py for the per-stage wall
clock of a run."""

from .experiment import (Experiment, ExperimentConfig, ExperimentResult,
                         WDMExperiment, channel_states)
from .ridge import (apply_readout, composed_chunk_states_fn, fit_ridge,
                    fit_ridge_batched, fit_ridge_streaming,
                    fit_ridge_streaming_composed, fit_ridge_streaming_shared,
                    fit_ridge_streaming_wdm, gram, guard_readout, solve_gcv,
                    solve_gcv_svd, with_bias)
from .session import (SessionConfig, SessionState, session_init, session_predict,
                      session_reset, session_solve, session_step, session_update)
from .stages import record_stages

__all__ = [
    "Experiment",
    "ExperimentConfig",
    "ExperimentResult",
    "SessionConfig",
    "SessionState",
    "WDMExperiment",
    "apply_readout",
    "channel_states",
    "composed_chunk_states_fn",
    "fit_ridge",
    "fit_ridge_batched",
    "fit_ridge_streaming",
    "fit_ridge_streaming_composed",
    "fit_ridge_streaming_shared",
    "fit_ridge_streaming_wdm",
    "gram",
    "guard_readout",
    "record_stages",
    "session_init",
    "session_predict",
    "session_reset",
    "session_solve",
    "session_step",
    "session_update",
    "solve_gcv",
    "solve_gcv_svd",
    "with_bias",
]
