"""Batched DFRC experiment: the paper's claims path in one call.

Port of the materialized branch of ``repro/pipeline/experiment.py``.  One
``Experiment.run`` takes ``[B, T]`` stacks of B independent task instances
and runs, for all of them at once:

1. the input layer — per-instance normalisation to [0, 1], sample-and-hold
   and the MLS mask;
2. the reservoir layer — train states, then test states continued from the
   train run's final state (``state_method``: ``ref`` / ``fast`` /
   ``kernel``; ``kernel`` is the CUDA scan, 2 launches per run);
3. the output layer — sampled digitiser noise on the training states, then
   the GCV-selected ridge readout (``readout_use_kernel=True``: one CUDA
   Gram launch for all B, then a batched f32 eigh; else the SVD of X);
4. evaluation — predictions, NRMSE and 4-PAM SER per instance.

The run happens on ``device`` (default ``cuda``).  The digitiser noise
draws from a ``torch.Generator`` seeded with ``noise_seed`` on that device:
it cannot reproduce ``jax.random``'s bits, so runs with noise agree with
the reference in distribution, and runs with ``state_noise_rel=0`` agree
to f32 round-off.

Not ported in this slice (each raises ``NotImplementedError`` naming its
ROADMAP Queue 1 item): the streaming fused path (``stream_chunk_k``, bf16
stream chunks; item 5), composed topologies (item 10), swept device
parameters (``dev_params``; item 11), and the WDM experiment (item 6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.masking import make_mask, sample_and_hold
from ..core.metrics import VAR_EPS
from ..core.nonlinear import NLModel, SiliconMR
from ..core.reservoir import generate_states
from ..core.tasks import SYMBOLS
from ..device import resolve_device
from .ridge import apply_readout, fit_ridge_batched
from .stages import stage

_SYMBOLS = tuple(float(s) for s in SYMBOLS)


def _as_tuple(l2) -> tuple[float, ...]:
    return tuple(float(v) for v in l2) if isinstance(l2, (tuple, list)) else (float(l2),)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Configuration of one batched DFRC experiment — every field of the
    reference's ``ExperimentConfig``, so configs carry across
    (``repro_torch.convert.config_from_reference``)."""

    model: NLModel = dataclasses.field(default_factory=SiliconMR)
    n_nodes: int = 900
    mask_levels: tuple[float, float] = (0.0, 1.0)
    mask_seed: int = 1
    input_gain: float = 1.0
    normalize_input: bool = True   # per-instance affine map to [0, 1]
    washout: int = 50
    ridge_l2: tuple[float, ...] = (1e-6,)   # always a tuple here (GCV-selected)
    state_noise_rel: float = 0.003
    noise_seed: int = 0
    state_method: str = "fast"     # "fast" | "ref" | "kernel"
    readout_use_kernel: bool = False
    quantize: bool = False
    stream_chunk_k: int | None = None      # ROADMAP Queue 1 item 5
    state_noise_mode: str = "sampled"
    stream_state_dtype: str = "float32"    # ROADMAP Queue 1 item 5
    collect_y_pred: bool = True
    # TPU tiling knobs, kept for API parity.  On the card:
    #   kernel_block_s — validated (one of 1, 2, 4, 8, 16, 32 or None) and
    #     otherwise unused: the CUDA scan runs one thread per lane.
    #   readout_block_t — the fold tile of the Gram's plain version (CPU);
    #     the CUDA Gram kernel's result does not depend on it.
    kernel_block_s: int | None = None
    readout_block_t: int = 512
    topology: object | None = None         # ROADMAP Queue 1 item 10

    def __post_init__(self):
        if not isinstance(self.ridge_l2, tuple):
            object.__setattr__(self, "ridge_l2", _as_tuple(self.ridge_l2))
        if self.topology is not None:
            raise NotImplementedError(
                "composed reservoir topologies are ROADMAP Queue 1 item 10")
        if self.stream_chunk_k is not None:
            raise NotImplementedError(
                "the streaming fused path (stream_chunk_k) is ROADMAP Queue 1 item 5")
        if self.state_noise_mode not in ("sampled", "diagonal"):
            raise ValueError(f"unknown state_noise_mode {self.state_noise_mode!r}")
        if self.stream_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown stream_state_dtype {self.stream_state_dtype!r} "
                "(expected 'float32' or 'bfloat16')")
        if self.stream_state_dtype != "float32":
            raise NotImplementedError(
                "bf16 stream state chunks (stream_state_dtype) are ROADMAP "
                "Queue 1 item 5 (the streaming fused path)")
        if self.state_noise_rel and self.state_noise_mode == "diagonal":
            raise ValueError(
                "state_noise_mode='diagonal' is the streaming-path noise model "
                "(set stream_chunk_k); the unfused route keeps the sampled-noise "
                "path")


@dataclasses.dataclass(frozen=True)
class ExperimentResult:
    """Per-instance outputs of one Experiment.run call (host numpy arrays).

    Single-channel targets keep 2-D shapes; C > 1 output channels add a
    trailing channel axis.  ``y_pred`` is None with ``collect_y_pred=False``.
    """

    y_pred: np.ndarray | None  # [B, T_test] (or [B, T_test, C]); quantized iff cfg.quantize
    nrmse: np.ndarray       # [B]  (mean of per-channel NRMSEs for C > 1)
    ser: np.ndarray         # [B]  (vs 4-PAM quantized predictions)
    lam: np.ndarray         # [B]  selected ridge λ per instance
    readout_w: np.ndarray   # [B, N + 1] (or [B, N + 1, C])

    @property
    def batch(self) -> int:
        return self.nrmse.shape[0]


def _canon_batch(x, name: str, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim == 1:
        return x[None, :]
    if x.ndim == 2:
        return x
    raise ValueError(f"{name} must be [T] or [B, T], got {tuple(x.shape)}")


def _canon_targets(x, name: str, inputs: torch.Tensor) -> torch.Tensor:
    """Targets matching ``inputs`` [B, T]: [B, T] or [B, T, C] (C > 1)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=inputs.device)
    b, t = inputs.shape
    if x.ndim == 1:
        x = x[None, :]
    elif x.ndim == 2 and b == 1 and tuple(x.shape) != (b, t) and x.shape[0] == t:
        x = x[None, :, :]            # [T, C] with 1-D inputs
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if tuple(x.shape[:2]) != (b, t):
        raise ValueError(f"{name} shape {tuple(x.shape)} does not match inputs ({b}, {t})")
    return x


def _quantize(y: torch.Tensor) -> torch.Tensor:
    sym = torch.tensor(_SYMBOLS, dtype=y.dtype, device=y.device)
    return sym[torch.argmin(torch.abs(y[..., None] - sym), dim=-1)]


def _input_layer(cfg: ExperimentConfig, tr_in: torch.Tensor, te_in: torch.Tensor):
    """Per-instance normalisation (from the train split) + sample-and-hold
    + gain -> (j_tr, j_te)."""
    if cfg.normalize_input:
        lo = torch.amin(tr_in, dim=1, keepdim=True)
        scale = 1.0 / (torch.amax(tr_in, dim=1, keepdim=True) - lo + 1e-12)
    else:
        lo, scale = 0.0, 1.0
    return (sample_and_hold((tr_in - lo) * scale * cfg.input_gain),
            sample_and_hold((te_in - lo) * scale * cfg.input_gain))


def _add_state_noise(cfg: ExperimentConfig, st_fit: torch.Tensor) -> torch.Tensor:
    """Digitiser noise: N(0, (rel · std of each instance's states)²)."""
    if not cfg.state_noise_rel:
        return st_fit
    sigma = cfg.state_noise_rel * torch.std(st_fit, dim=(1, 2), keepdim=True, correction=0)
    gen = torch.Generator(device=st_fit.device).manual_seed(cfg.noise_seed)
    noise = torch.randn(st_fit.shape, generator=gen, dtype=st_fit.dtype,
                        device=st_fit.device)
    return st_fit + sigma * noise


def _evaluate(cfg: ExperimentConfig, st_te: torch.Tensor, w_fit: torch.Tensor,
              te_tg: torch.Tensor):
    """Predictions and metrics -> (y_out, nrmse [B], ser [B])."""
    y_raw = apply_readout(st_te, w_fit)                # [B, T_test(, C)]
    y_sym = _quantize(y_raw)
    inst_axes = tuple(range(1, y_raw.ndim))
    err = y_raw - te_tg
    # NRMSE per channel (that channel's variance over T), then channel-mean.
    var = torch.var(te_tg, dim=1, correction=0)
    nrmse_ch = torch.sqrt(torch.mean(err * err, dim=1) / (var + VAR_EPS))
    nrmse = nrmse_ch if nrmse_ch.ndim == 1 else torch.mean(nrmse_ch, dim=-1)
    # SER on quantized-vs-quantized symbols (targets may sit eps off 4-PAM).
    ser = torch.mean((y_sym != _quantize(te_tg)).to(torch.float32), dim=inst_axes)
    return (y_sym if cfg.quantize else y_raw), nrmse, ser


def _run_pipeline(cfg: ExperimentConfig, mask, tr_in, tr_tg, te_in, te_tg):
    """The whole materialized experiment on the inputs' device.  Each stage
    is marked for ``stages.record_stages`` (the readout's marks are inside
    ``fit_ridge_batched``)."""
    dev = tr_in.device
    with stage("input_layer", dev):
        j_tr, j_te = _input_layer(cfg, tr_in, te_in)
    with stage("states_train", dev):
        st_tr, s_carry = generate_states(cfg.model, j_tr, mask, method=cfg.state_method,
                                         block_s=cfg.kernel_block_s, return_final=True,
                                         device=dev)
    with stage("states_test", dev):
        st_te = generate_states(cfg.model, j_te, mask, s0=s_carry, method=cfg.state_method,
                                block_s=cfg.kernel_block_s, device=dev)
    w = cfg.washout
    with stage("noise", dev):
        st_fit = _add_state_noise(cfg, st_tr[:, w:])
    w_fit, lam_idx = fit_ridge_batched(st_fit, tr_tg[:, w:], lambdas=cfg.ridge_l2,
                                       use_kernel=cfg.readout_use_kernel,
                                       block_t=cfg.readout_block_t, device=dev)
    with stage("evaluation", dev):
        y_out, nrmse, ser = _evaluate(cfg, st_te, w_fit, te_tg)
    lam = torch.tensor(cfg.ridge_l2, dtype=torch.float32, device=dev)[lam_idx]
    return (y_out if cfg.collect_y_pred else None), nrmse, ser, lam, w_fit


def _pack_result(y, nrmse, ser, lam, w) -> ExperimentResult:
    """Device outputs -> host ExperimentResult."""
    w = w.cpu().numpy()
    if w.shape[-1] == 1:
        w = w[..., 0]
    return ExperimentResult(
        y_pred=None if y is None else y.cpu().numpy(),
        nrmse=nrmse.cpu().numpy(), ser=ser.cpu().numpy(),
        lam=lam.cpu().numpy(), readout_w=w)


class Experiment:
    """Batched DFRC experiment: fit + predict + metrics for B instances.

    >>> exp = Experiment(ExperimentConfig(model=SiliconMR(), n_nodes=200))
    >>> res = exp.run(tr_in, tr_tg, te_in, te_tg)   # arrays [B, T] (or [T])
    >>> res.nrmse                                    # [B]

    Runs on ``device`` (default ``cuda``; ``"cpu"`` on request).
    """

    def __init__(self, config: ExperimentConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.mask = make_mask(config.n_nodes, levels=config.mask_levels,
                              seed=config.mask_seed, device=self.device)

    def run(self, inputs_train, targets_train, inputs_test, targets_test,
            *, dev_params=None) -> ExperimentResult:
        """Fit readouts and evaluate, one task instance per batch row.

        Inputs are [B, T] (or [T], B = 1); targets may carry a trailing
        channel axis ([B, T, C]).  Train and test lengths may differ.
        """
        if dev_params is not None:
            raise NotImplementedError(
                "dev_params (swept device parameters) are ROADMAP Queue 1 item 11")
        tr_in = _canon_batch(inputs_train, "inputs_train", self.device)
        te_in = _canon_batch(inputs_test, "inputs_test", self.device)
        tr_tg = _canon_targets(targets_train, "targets_train", tr_in)
        te_tg = _canon_targets(targets_test, "targets_test", te_in)
        if tr_in.shape[0] != te_in.shape[0] or tr_tg.ndim != te_tg.ndim or (
                tr_tg.ndim == 3 and tr_tg.shape[-1] != te_tg.shape[-1]):
            raise ValueError(
                f"inconsistent batch shapes: train {tuple(tr_in.shape)}/"
                f"{tuple(tr_tg.shape)}, test {tuple(te_in.shape)}/{tuple(te_tg.shape)}")
        out = _run_pipeline(self.config, self.mask, tr_in, tr_tg, te_in, te_tg)
        with stage("pack", self.device):
            return _pack_result(*out)

    def run_dataset(self, ds) -> ExperimentResult:
        """Convenience for a core.tasks Dataset (single instance, B = 1)."""
        return self.run(ds.inputs_train, ds.targets_train,
                        ds.inputs_test, ds.targets_test)
