"""High-level DFRC accelerator API (paper Fig. 4: input/reservoir/output layers).

Port of ``repro/core/accelerator.py``: masking (input layer), DFR state
generation (reservoir layer) and readout training (output layer) behind a
scikit-style fit/predict object.  The reservoir runs on ``device`` (default
``cuda``; ``state_method="kernel"`` is one launch of the CUDA scan kernel a
series, resumed from the carry); the digitiser noise is drawn with numpy
from ``noise_seed`` exactly as the reference draws it, and the readout is
the float64 host solve of ``core/readout.fit_readout``.

    cfg = DFRCConfig(model=SiliconMR(), n_nodes=900, state_method="kernel")
    acc = DFRCAccelerator(cfg)
    acc.fit(ds.inputs_train, ds.targets_train)
    err = acc.evaluate_nrmse(ds.inputs_test, ds.targets_test)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .masking import make_mask, sample_and_hold
from .metrics import nrmse, ser
from .nonlinear import NLModel, SiliconMR
from .readout import Readout, fit_readout
from .reservoir import generate_states
from .tasks import quantize_symbols


@dataclasses.dataclass(frozen=True)
class DFRCConfig:
    """Every field of the reference's ``DFRCConfig``, with its defaults."""

    model: NLModel = dataclasses.field(default_factory=SiliconMR)
    n_nodes: int = 900
    mask_levels: tuple[float, float] = (0.0, 1.0)
    mask_seed: int = 1
    input_gain: float = 1.0
    normalize_input: bool = True   # affine-map train inputs to [0, 1]
    washout: int = 50              # periods dropped before readout training
    ridge_l2: float | tuple = 1e-6
    # Digitiser noise: RMS relative to the state std, injected into the
    # training states (the physical regulariser; 0.003 ~ an 8-bit ADC).
    state_noise_rel: float = 0.003
    noise_seed: int = 0
    readout_method: str = "ridge"  # "ridge" | "pinv" (paper's Moore-Penrose)
    state_method: str = "fast"     # "fast" | "ref" | "kernel"
    quantize: bool = False         # snap predictions to 4-PAM symbols


class DFRCAccelerator:
    """One physical DFRC accelerator instance, on ``device`` (default ``cuda``)."""

    def __init__(self, config: DFRCConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.mask = make_mask(config.n_nodes, levels=config.mask_levels,
                              seed=config.mask_seed, device=self.device)
        self.readout: Readout | None = None
        self._in_shift = 0.0
        self._in_scale = 1.0
        self._s_carry = None  # reservoir state at the end of the last series

    # -- input layer ----------------------------------------------------------
    def _drive(self, inputs) -> torch.Tensor:
        j = sample_and_hold(torch.as_tensor(np.asarray(inputs, dtype=np.float32),
                                            device=self.device))
        return (j - self._in_shift) * self._in_scale * self.config.input_gain

    # -- reservoir layer --------------------------------------------------------
    def states(self, inputs, *, carry: bool = True) -> torch.Tensor:
        """DFR states [K, N] for an input series [K].

        ``carry=True`` continues from wherever the reservoir last stopped
        (the physical loop never resets between train and test phases).
        """
        j = self._drive(inputs)
        s0 = self._s_carry if carry else None
        states = generate_states(self.config.model, j, self.mask, s0=s0,
                                 method=self.config.state_method, device=self.device)
        if carry:
            self._s_carry = states[-1]
        return states

    # -- output layer -----------------------------------------------------------
    def fit(self, inputs, targets) -> "DFRCAccelerator":
        cfg = self.config
        if cfg.normalize_input:
            arr = np.asarray(inputs, dtype=np.float64)
            self._in_shift = float(arr.min())
            self._in_scale = float(1.0 / (arr.max() - arr.min() + 1e-12))
        self._s_carry = None
        st = self.states(inputs)
        w = cfg.washout
        st_train = st[w:].cpu().numpy()
        if cfg.state_noise_rel:
            rng = np.random.default_rng(cfg.noise_seed)
            sigma = cfg.state_noise_rel * float(st_train.std())
            st_train = st_train + rng.normal(0.0, sigma, st_train.shape)
        self.readout = fit_readout(
            torch.as_tensor(st_train, dtype=torch.float32, device=self.device),
            np.asarray(targets)[w:], l2=cfg.ridge_l2, method=cfg.readout_method)
        return self

    def predict(self, inputs) -> np.ndarray:
        if self.readout is None:
            raise RuntimeError("fit() before predict()")
        y = self.readout(self.states(inputs)).cpu().numpy()
        return quantize_symbols(y) if self.config.quantize else y

    # -- evaluation -------------------------------------------------------------
    def evaluate_nrmse(self, inputs, targets) -> float:
        return nrmse(targets, self.predict(inputs))

    def evaluate_ser(self, inputs, targets) -> float:
        return ser(np.asarray(targets), quantize_symbols(self.predict(inputs)))
