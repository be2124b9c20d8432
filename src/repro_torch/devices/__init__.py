"""Physics-fidelity device subsystem — port of ``repro.devices``.

* :mod:`.cmt`       — :class:`MRCavityCMT`, the coupled-mode-theory cavity
  (intracavity energy, free carriers, temperature, sub-stepped inside each
  virtual-node tick), and :class:`CMTSweepParams`, the per-lane operating
  point; the CUDA scan kernel has a form of it (``kernel_spec``).
* :mod:`.calibrate` — ``calibrated_twin`` (the cavity whose zero-power limit
  is ``SiliconMR``'s tick map), small-signal gains, per-tick parity.
* :mod:`.sweep`     — ``SweepGrid``/``run_device_sweep``: a (detuning ×
  loss × power) grid folded into the batch lanes of one ``Experiment.run``.

Importing this package registers ``MRCavityCMT`` in
``core.nonlinear.MODEL_REGISTRY`` under ``"mr_cavity_cmt"``.
"""

from ..core.nonlinear import register_model
from .calibrate import calibrated_twin, calibration_report, node_parity, small_signal_gains
from .cmt import CMTSweepParams, MRCavityCMT
from .sweep import SweepGrid, SweepResult, run_device_sweep

register_model("mr_cavity_cmt", MRCavityCMT)

__all__ = [
    "CMTSweepParams",
    "MRCavityCMT",
    "SweepGrid",
    "SweepResult",
    "calibrated_twin",
    "calibration_report",
    "node_parity",
    "run_device_sweep",
    "small_signal_gains",
]
