"""Batched DFRC experiment: the paper's claims path in one call.

Port of ``repro/pipeline/experiment.py``.  One ``Experiment.run`` takes
``[B, T]`` stacks of B independent task instances and runs, for all of
them at once:

1. the input layer — per-instance normalisation to [0, 1], sample-and-hold
   and the MLS mask;
2. the reservoir layer — train states, then test states continued from the
   train run's final state (``state_method``: ``ref`` / ``fast`` /
   ``kernel``; ``kernel`` is the CUDA scan, 2 launches per run);
3. the output layer — sampled digitiser noise on the training states, then
   the GCV-selected ridge readout (``readout_use_kernel=True``: one CUDA
   Gram launch for all B, then a batched f32 eigh; else the SVD of X);
4. evaluation — predictions, NRMSE and 4-PAM SER per instance.

``stream_chunk_k`` switches the run onto the streaming fused path
(DESIGN.md §8): the fit is ``fit_ridge_streaming`` (one scan launch and one
accumulate-into Gram launch per chunk, the noise as its expected Tikhonov
diagonal) and the test evaluation runs chunk by chunk into running error
accumulators, so no [B, T, N] state tensor exists.  ``WDMExperiment`` is
the WDM ensemble (DESIGN.md §9): the batch axis is R wavelength channels
with per-channel masks (the scan kernel's per-lane mode), materialized or
streamed, with per-channel readouts or one shared readout.

The run happens on ``device`` (default ``cuda``).  The sampled digitiser
noise draws from a ``torch.Generator`` seeded with ``noise_seed`` on that
device: it cannot reproduce ``jax.random``'s bits, so runs with sampled
noise agree with the reference in distribution, and runs with
``state_noise_rel=0`` or diagonal noise agree to f32 round-off.

Under an active mesh (``parallel.sharding.use_mesh``) the instance axis
(batch rows, WDM channels or sweep lanes) splits over the mesh's data axes
by ``sharding.fit_spec`` (the reference's ``maybe_shard`` of the drive and
the states, ``repro/pipeline/experiment.py:407-408, 481-482``): each rank
runs its block of instances through the reservoir, the fit and the
evaluation, and every rank returns the whole result.  A batch the data
axes do not divide stays whole on every rank; a "model" axis replicates
the work.  With the instances the rank cuts what is per instance: the
drive, the targets and the carries, a WDM ensemble's [R, N] masks (a
composed one's per-stage [R, L, N] stacks), and each [B] leaf of
``dev_params`` (scalar leaves stay); a composed graph's [L, N] stacks under
``Experiment`` are every instance's and stay whole.  The per-instance
results come back in one all-gather (``_gather_instances``).  Sampled
digitiser noise is drawn at the whole batch's shape and cut, so a run over
a mesh draws what one process draws.  The shared WDM readout is the one
path whose fit couples instances: its [R·N + 1]² Gram pairs channels that
live on different ranks, which a sum of per-rank Grams would lose.  Its
ranks all-gather each chunk's channel-major features instead, one
collective a chunk in the fit and in the evaluation, and each folds and
solves the whole Gram; its one target stream and its B = 1 results are
every rank's and are neither cut nor gathered.

``Experiment.run(..., dev_params=...)`` sweeps the device's operating
point over the batch lanes (``devices.cmt.CMTSweepParams``, leaves scalar
or [B]) on the ``ref``/``fast`` state paths, materialized or streamed
(``devices.sweep.run_device_sweep``).  ``ExperimentConfig.topology``
replaces the single delay loop with a composed reservoir graph
(``core.graph``, DESIGN.md §13), streamed only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.graph import ReservoirGraph, ReservoirStage, build_stage_masks
from ..core.masking import make_mask, sample_and_hold
from ..core.metrics import VAR_EPS
from ..core.nonlinear import NLModel, SiliconMR
from ..core.reservoir import generate_channel_states, generate_states
from ..core.tasks import SYMBOLS
from ..device import host_values, resolve_device
from ..kernels.readout_apply import readout_apply, readout_apply_plain
from ..parallel import sharding
from .ridge import (_chunk_axis, _row_mask, _shared_chunk_states_fn, apply_readout,
                    composed_chunk_states_fn, fit_ridge_batched, fit_ridge_streaming,
                    fit_ridge_streaming_composed, fit_ridge_streaming_shared,
                    fit_ridge_streaming_wdm)
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
    # Streaming fused path: a chunk length in periods streams fit and eval;
    # the solve is then always the Gram/eigh route (``readout_use_kernel``
    # picks how G accumulates, the Gram kernel or a plain matmul, and how
    # the evaluation applies the readout, the readout-apply kernel or the
    # widened matmul).
    # ``state_noise_mode``: "sampled" draws the noise on the materialized
    # states (materialized route only), "diagonal" adds its expected Gram
    # σ²·T_fit·I (the streaming route).
    stream_chunk_k: int | None = None
    state_noise_mode: str = "sampled"
    # "bfloat16" narrows the streamed state chunks; carry, targets and Gram
    # stay f32.
    stream_state_dtype: str = "float32"
    collect_y_pred: bool = True
    # TPU tiling knobs, kept for API parity.  On the card:
    #   kernel_block_s — validated (one of 1, 2, 4, 8, 16, 32 or None) and
    #     otherwise unused: the CUDA scan runs one thread per lane.
    #   readout_block_t — the fold tile of the Gram's plain version (CPU);
    #     the CUDA Gram kernel's result does not depend on it.
    kernel_block_s: int | None = None
    readout_block_t: int = 512
    # A composed reservoir graph (``core.graph.ReservoirGraph``, or one
    # ``ReservoirStage``, lifted to a one-stage graph) in place of the single
    # delay loop: the readout sees every stage's nodes (topology.width).
    # Streaming only (set ``stream_chunk_k``): the stage chain runs chunk by
    # chunk.  ``n_nodes``/``mask_seed``/``mask_levels`` give way to the
    # stages' own; a depth-1, loops-1 topology is the single-loop fit, bit
    # for bit.
    topology: ReservoirGraph | None = None

    def __post_init__(self):
        if not isinstance(self.ridge_l2, tuple):
            object.__setattr__(self, "ridge_l2", _as_tuple(self.ridge_l2))
        if isinstance(self.topology, ReservoirStage):
            object.__setattr__(self, "topology", ReservoirGraph(stages=(self.topology,)))
        if self.topology is not None:
            if not isinstance(self.topology, ReservoirGraph):
                raise TypeError(f"topology must be a ReservoirGraph or ReservoirStage, "
                                f"got {self.topology!r}")
            if self.stream_chunk_k is None:
                raise ValueError(
                    "a composed topology runs streaming-only (per-chunk stage "
                    "chaining is its memory contract); set stream_chunk_k")
        if self.state_noise_mode not in ("sampled", "diagonal"):
            raise ValueError(f"unknown state_noise_mode {self.state_noise_mode!r}")
        if self.stream_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown stream_state_dtype {self.stream_state_dtype!r} "
                "(expected 'float32' or 'bfloat16')")
        if self.stream_state_dtype != "float32" and self.stream_chunk_k is None:
            raise ValueError(
                "stream_state_dtype narrows the *streaming* state chunks; "
                "set stream_chunk_k (the materialized path keeps f32 states)")
        if self.state_noise_rel:
            if self.stream_chunk_k is not None and self.state_noise_mode != "diagonal":
                raise ValueError(
                    "the streaming path cannot materialize sampled state noise; "
                    "set state_noise_mode='diagonal' (noise as its expected "
                    "Tikhonov diagonal) or state_noise_rel=0")
            if self.stream_chunk_k is None and self.state_noise_mode == "diagonal":
                raise ValueError(
                    "state_noise_mode='diagonal' is the streaming-path noise "
                    "model (set stream_chunk_k); the unfused route keeps the "
                    "sampled-noise path")

    @property
    def _stream_state_dtype_arg(self) -> str | None:
        """stream_state_dtype as the state functions' ``state_dtype``."""
        return None if self.stream_state_dtype == "float32" else self.stream_state_dtype

    @classmethod
    def from_dfrc(cls, cfg) -> "ExperimentConfig":
        """Lift the port's ``DFRCConfig`` onto the batched pipeline.

        The pipeline's readout is always the ridge/GCV path (the paper's
        pinv is the λ→0 limit; ``core/readout.py`` keeps the exact pinv).
        """
        return cls(
            model=cfg.model,
            n_nodes=cfg.n_nodes,
            mask_levels=tuple(cfg.mask_levels),
            mask_seed=cfg.mask_seed,
            input_gain=cfg.input_gain,
            normalize_input=cfg.normalize_input,
            washout=cfg.washout,
            ridge_l2=_as_tuple(cfg.ridge_l2),
            state_noise_rel=cfg.state_noise_rel,
            noise_seed=cfg.noise_seed,
            state_method=cfg.state_method,
            quantize=cfg.quantize,
        )


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
    sym = host_values(_SYMBOLS, y.dtype, y.device)
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


def _add_state_noise(cfg: ExperimentConfig, st_fit: torch.Tensor, *,
                     cut=None) -> torch.Tensor:
    """Digitiser noise: N(0, (rel · std of each instance's states)²).  With
    ``cut=(spec, mesh)`` ``st_fit`` is this rank's block of instances: the
    noise is drawn at the whole batch's shape and the block cut from it.
    Each instance's std is its own reduction, one call an instance: the
    order of a batched reduction's f32 sums depends on the batch's size on
    the card, and an instance's noise scale would then depend on the
    instances beside it (a rank's block against the whole batch)."""
    if not cfg.state_noise_rel:
        return st_fit
    sigma = cfg.state_noise_rel * torch.stack(
        [torch.std(inst, correction=0) for inst in st_fit])[:, None, None]
    gen = torch.Generator(device=st_fit.device).manual_seed(cfg.noise_seed)
    shape = st_fit.shape
    if cut is not None:
        shape = (shape[0] * sharding.shard_count(cut[0][0], cut[1]), *shape[1:])
    noise = torch.randn(shape, generator=gen, dtype=st_fit.dtype, device=st_fit.device)
    if cut is not None:
        noise = sharding.shard(noise, *cut)
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


def _gen_states(cfg: ExperimentConfig, mask, j, *, wdm: bool, s0=None,
                return_final: bool = False, state_dtype=None, dev_params=None):
    """States of both workloads: ``mask`` [N] broadcast over B instances,
    or with ``wdm=True`` per-lane masks [R, N], one channel per row.
    ``dev_params`` rides the single-mask workload only."""
    kw = dict(s0=s0, method=cfg.state_method, block_s=cfg.kernel_block_s,
              return_final=return_final, state_dtype=state_dtype, device=j.device)
    if wdm:
        if dev_params is not None:
            raise NotImplementedError(
                "dev_params sweeps use the single-mask workload; per-channel "
                "WDM masks with per-lane device parameters are not supported")
        return generate_channel_states(cfg.model, j, mask, **kw)
    return generate_states(cfg.model, j, mask, dev_params=dev_params, **kw)


def _eval_streaming(cfg: ExperimentConfig, states_fn, j_te, te_tg3, w_fit, s0):
    """Chunked test evaluation: states per chunk, running error accumulators.

    ``states_fn`` is the per-chunk state producer ``(j_chunk, carry) ->
    (features, carry')`` and ``s0`` its carry after the train split;
    ``te_tg3`` [B, T, C].  Returns (y_raw [B, T, C] or None, acc) with acc
    the running statistics (Σ_t (ŷ − y)², the 4-PAM symbol mismatches and
    the target's Σ(y − y₀), Σ(y − y₀)²), so no [B, T, N] state block and
    no full-stream target pass exists.  With ``cfg.collect_y_pred=False``
    the chunk predictions are dropped once counted: no [B, T, C] block
    either.
    """
    b, t_total = j_te.shape[0], j_te.shape[1]
    c_cols = te_tg3.shape[-1]
    chunk_k = cfg.stream_chunk_k
    dev = j_te.device
    # The variance moments are shifted by the first sample: E[y²] − E[y]²
    # in f32 cancels catastrophically when |mean| ≫ std; on d = y − y₀ it
    # cancels against ~std² only.
    shift = te_tg3[:, :1, :]                                   # [B, 1, C]
    err2 = torch.zeros((b, c_cols), dtype=torch.float32, device=dev)
    ser_cnt = torch.zeros((b,), dtype=torch.float32, device=dev)
    y_sum = torch.zeros((b, c_cols), dtype=torch.float32, device=dev)
    y_sq = torch.zeros((b, c_cols), dtype=torch.float32, device=dev)
    s = s0
    y_chunks = []
    apply = readout_apply if cfg.readout_use_kernel else readout_apply_plain
    chunks = zip(_chunk_axis(j_te, chunk_k), _chunk_axis(te_tg3, chunk_k))
    for i, (j_c, y_c) in enumerate(chunks):
        states, s = states_fn(j_c, s)
        y_hat = apply(states, w_fit)                                 # [B, chunk, C] f32
        valid = _row_mask(i * chunk_k, chunk_k, 0, t_total, dev)[None, :, None]
        err = (y_hat - y_c) * valid
        err2 = err2 + torch.sum(err * err, dim=1)
        mism = (_quantize(y_hat) != _quantize(y_c)) & (valid > 0)
        ser_cnt = ser_cnt + torch.sum(mism.to(torch.float32), dim=(1, 2))
        yv = (y_c - shift) * valid
        y_sum = y_sum + torch.sum(yv, dim=1)
        y_sq = y_sq + torch.sum(yv * yv, dim=1)
        if cfg.collect_y_pred:
            y_chunks.append(y_hat[:, :t_total - i * chunk_k])
    acc = (err2, ser_cnt, y_sum, y_sq)
    if not cfg.collect_y_pred:
        return None, acc
    return torch.cat(y_chunks, dim=1), acc


def _streaming_metrics(acc, t_test: int, *, channel_axis: bool):
    """NRMSE/SER from the running accumulators, with the materialized
    path's conventions: per-channel NRMSE (that channel's variance, from the
    shifted moments) then the channel mean; SER over quantized symbols."""
    err2, ser_cnt, y_sum, y_sq = acc
    mean = y_sum / t_test
    var = torch.clamp(y_sq / t_test - mean * mean, min=0.0)    # [B, C]
    nrmse_ch = torch.sqrt((err2 / t_test) / (var + VAR_EPS))
    nrmse = torch.mean(nrmse_ch, dim=-1) if channel_axis else nrmse_ch[:, 0]
    ser = ser_cnt / (t_test * err2.shape[-1])
    return nrmse, ser


def _run_streaming(cfg: ExperimentConfig, mask, j_tr, tr_tg, j_te, te_tg, *,
                   wdm: bool, shared: bool, dev_params=None, cut=None):
    """The streaming branch: chunked fit, then chunked evaluation (``cut``:
    the shared readout's channels are this rank's block, see
    ``ridge.fit_ridge_streaming_shared``)."""
    dev = j_tr.device
    noise_rel = cfg.state_noise_rel if cfg.state_noise_mode == "diagonal" else 0.0
    kw = dict(washout=cfg.washout, chunk_k=cfg.stream_chunk_k, lambdas=cfg.ridge_l2,
              state_method=cfg.state_method, block_s=cfg.kernel_block_s,
              use_kernel=cfg.readout_use_kernel, block_t=cfg.readout_block_t,
              state_dtype=cfg._stream_state_dtype_arg, noise_rel=noise_rel, device=dev)
    te_tg3 = te_tg[..., None] if te_tg.ndim == 2 else te_tg
    if cfg.topology is not None:
        # the stage chain: fit and evaluation build their per-chunk state
        # producer with one function, so test states run the fit's ops
        w_fit, lam_idx, s_carry = fit_ridge_streaming_composed(cfg.topology, mask, j_tr,
                                                               tr_tg, **kw)
        eval_fn = composed_chunk_states_fn(cfg.topology, mask, state_method=cfg.state_method,
                                           block_s=cfg.kernel_block_s,
                                           state_dtype=cfg._stream_state_dtype_arg, device=dev)
        with stage("stream_eval", dev):
            y_raw3, acc = _eval_streaming(cfg, eval_fn, j_te, te_tg3, w_fit, s_carry)
    elif shared:
        # one [R·N + 1] readout; the channel axis rides the chunk loop as a
        # trailing input dim (B = 1 for the Gram)
        w_1, lam_1, s_1 = fit_ridge_streaming_shared(cfg.model, mask, j_tr, tr_tg[0], cut=cut,
                                                     **kw)
        w_fit, lam_idx = w_1[None], lam_1[None]
        eval_fn = _shared_chunk_states_fn(cfg.model, mask, state_method=cfg.state_method,
                                          block_s=cfg.kernel_block_s,
                                          state_dtype=cfg._stream_state_dtype_arg,
                                          device=dev, cut=cut)
        with stage("stream_eval", dev):
            y_raw3, acc = _eval_streaming(cfg, eval_fn, j_te.T[None], te_tg3, w_fit,
                                          (s_1[None],))
    else:
        if wdm:
            w_fit, lam_idx, s_carry = fit_ridge_streaming_wdm(cfg.model, mask, j_tr, tr_tg, **kw)
        else:
            w_fit, lam_idx, s_carry = fit_ridge_streaming(cfg.model, mask, j_tr, tr_tg,
                                                          dev_params=dev_params, **kw)

        def eval_fn(j_c, s):
            return _gen_states(cfg, mask, j_c, wdm=wdm, s0=s, return_final=True,
                               state_dtype=cfg._stream_state_dtype_arg, dev_params=dev_params)

        with stage("stream_eval", dev):
            y_raw3, acc = _eval_streaming(cfg, eval_fn, j_te, te_tg3, w_fit, s_carry)
    nrmse, ser = _streaming_metrics(acc, te_tg3.shape[1], channel_axis=te_tg.ndim == 3)
    lam = host_values(cfg.ridge_l2, torch.float32, dev)[lam_idx]
    if y_raw3 is None:
        return None, nrmse, ser, lam, w_fit
    y_raw = y_raw3 if te_tg.ndim == 3 else y_raw3[..., 0]
    return (_quantize(y_raw) if cfg.quantize else y_raw), nrmse, ser, lam, w_fit


def _run_pipeline(cfg: ExperimentConfig, mask, tr_in, tr_tg, te_in, te_tg, *,
                  wdm: bool = False, shared: bool = False, dev_params=None):
    """The whole experiment on the inputs' device.  Each stage is marked
    for ``stages.record_stages`` (the readout's marks are inside the fits).

    ``wdm=True``: the batch axis is R wavelength channels and ``mask`` a
    per-channel [R, N] stack.  ``shared=True`` (streaming WDM only): ONE
    readout over all channels' states, targets [1, K(, C)].
    ``dev_params``: the per-lane device operating point (single mask).
    With ``cfg.topology``, ``mask`` is the tuple of per-stage mask stacks.

    Under an active mesh each rank runs its block of the instance axis
    (module doc): per-instance masks, targets and [B] ``dev_params``
    leaves are cut with it, and the per-instance results are gathered; the
    shared readout gathers each chunk's features instead and returns its
    B = 1 results as they are.
    """
    dev = tr_in.device
    with stage("input_layer", dev):
        j_tr, j_te = _input_layer(cfg, tr_in, te_in)
    mesh = sharding.active_mesh()
    if mesh is None:
        return _run_from_drive(cfg, mask, j_tr, tr_tg, j_te, te_tg, wdm=wdm, shared=shared,
                               dev_params=dev_params)
    # the instance axis (rows, channels or lanes) over the data axes
    cut = (sharding.fit_spec(mesh, j_tr.shape, sharding.BATCH_AXES), mesh)

    def local(t):
        return sharding.shard(t, *cut)

    if wdm:   # per-channel masks: [R, N], or per-stage [R, L, N] stacks
        mask = tuple(map(local, mask)) if cfg.topology is not None else local(mask)
    if dev_params is not None:
        dev_params = type(dev_params)(*(leaf if np.ndim(leaf) == 0 else
                                        local(torch.as_tensor(leaf)) for leaf in dev_params))
    if not shared:   # the shared readout's one target stream is every rank's
        tr_tg, te_tg = local(tr_tg), local(te_tg)
    out = _run_from_drive(cfg, mask, local(j_tr), tr_tg, local(j_te), te_tg, wdm=wdm,
                          shared=shared, dev_params=dev_params, cut=cut)
    return out if shared else _gather_instances(out, cut)


def _gather_instances(out, cut):
    """This rank's per-instance results -> the whole batch's, on every
    rank: every result packed a row an instance, in one all-gather over
    each axis of the cut."""
    spec, mesh = cut
    if not sharding.entry_axes(spec[0]):
        return out
    parts = [t for t in out if t is not None]
    b = parts[0].shape[0]
    rows = sharding.gather(torch.cat([t.reshape(b, -1) for t in parts], dim=1), spec, mesh)
    whole = iter(r.reshape(-1, *t.shape[1:]) for r, t in zip(
        torch.split(rows, [t[0].numel() for t in parts], dim=1), parts))
    return tuple(None if t is None else next(whole) for t in out)


def _run_from_drive(cfg, mask, j_tr, tr_tg, j_te, te_tg, *, wdm=False, shared=False,
                    dev_params=None, cut=None):
    """The pipeline from the drive on: reservoir, fit, evaluation (``cut``:
    this rank's block of instances, see ``_add_state_noise``)."""
    dev = j_tr.device
    if cfg.stream_chunk_k is not None:
        return _run_streaming(cfg, mask, j_tr, tr_tg, j_te, te_tg, wdm=wdm, shared=shared,
                              dev_params=dev_params, cut=cut)
    with stage("states_train", dev):
        st_tr, s_carry = _gen_states(cfg, mask, j_tr, wdm=wdm, return_final=True,
                                     dev_params=dev_params)
    with stage("states_test", dev):
        st_te = _gen_states(cfg, mask, j_te, wdm=wdm, s0=s_carry, dev_params=dev_params)
    w = cfg.washout
    with stage("noise", dev):
        st_fit = _add_state_noise(cfg, st_tr[:, w:], cut=cut)
    w_fit, lam_idx = fit_ridge_batched(st_fit, tr_tg[:, w:], lambdas=cfg.ridge_l2,
                                       use_kernel=cfg.readout_use_kernel,
                                       block_t=cfg.readout_block_t, device=dev)
    with stage("evaluation", dev):
        y_out, nrmse, ser = _evaluate(cfg, st_te, w_fit, te_tg)
    lam = host_values(cfg.ridge_l2, torch.float32, dev)[lam_idx]
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

    Runs on ``device`` (default ``cuda``; ``"cpu"`` on request).  With
    ``config.topology`` the mask is the tuple of per-stage [L, N] stacks.
    """

    def __init__(self, config: ExperimentConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        if config.topology is not None:
            self.mask = build_stage_masks(config.topology, device=self.device)
        else:
            self.mask = make_mask(config.n_nodes, levels=config.mask_levels,
                                  seed=config.mask_seed, device=self.device)

    def run(self, inputs_train, targets_train, inputs_test, targets_test,
            *, dev_params=None) -> ExperimentResult:
        """Fit readouts and evaluate, one task instance per batch row.

        Inputs are [B, T] (or [T], B = 1); targets may carry a trailing
        channel axis ([B, T, C]).  Train and test lengths may differ.
        ``dev_params`` sweeps the device's operating point over the batch
        lanes (e.g. ``devices.cmt.CMTSweepParams``; leaves scalar or [B]),
        on the ``ref``/``fast`` state paths.
        """
        tr_in = _canon_batch(inputs_train, "inputs_train", self.device)
        te_in = _canon_batch(inputs_test, "inputs_test", self.device)
        tr_tg = _canon_targets(targets_train, "targets_train", tr_in)
        te_tg = _canon_targets(targets_test, "targets_test", te_in)
        if tr_in.shape[0] != te_in.shape[0] or tr_tg.ndim != te_tg.ndim or (
                tr_tg.ndim == 3 and tr_tg.shape[-1] != te_tg.shape[-1]):
            raise ValueError(
                f"inconsistent batch shapes: train {tuple(tr_in.shape)}/"
                f"{tuple(tr_tg.shape)}, test {tuple(te_in.shape)}/{tuple(te_tg.shape)}")
        if dev_params is not None:
            if self.config.topology is not None:
                raise ValueError(
                    "dev_params with a composed topology is not supported; "
                    "sweep the single-loop workload")
            if self.config.state_method == "kernel":
                raise ValueError(
                    "dev_params rides the torch state paths; set state_method='fast' "
                    "or 'ref' (the scan kernel takes the dataclass operating point)")
            b = tr_in.shape[0]
            for leaf in dev_params:
                shape = tuple(np.shape(leaf))
                if len(shape) > 1 or (len(shape) == 1 and shape[0] != b):
                    raise ValueError(
                        f"dev_params leaves must be scalars or [{b}] (one value per "
                        f"batch lane), got shape {shape}")
        out = _run_pipeline(self.config, self.mask, tr_in, tr_tg, te_in, te_tg,
                            dev_params=dev_params)
        with stage("pack", self.device):
            return _pack_result(*out)

    def run_dataset(self, ds) -> ExperimentResult:
        """Convenience for a core.tasks Dataset (single instance, B = 1)."""
        return self.run(ds.inputs_train, ds.targets_train,
                        ds.inputs_test, ds.targets_test)


def channel_states(model: NLModel, j, masks, *, s0=None, method: str = "fast",
                   block_s: int | None = None, return_final: bool = False,
                   state_dtype=None, device=None):
    """WDM ensemble states: ``j`` [R, K] (one series per wavelength
    channel) with ``masks`` [R, N] -> states [R, K, N]; ``s0`` [R, N]
    carries each channel across calls.  ``method="kernel"`` runs all R
    channels as ONE scan-kernel launch (per-lane masks).

    ``core.reservoir.generate_channel_states`` under the name the
    reference's pipeline exports it (``repro.pipeline.channel_states``, a
    jitted wrapper there); kept for that API's parity, it adds nothing.
    """
    return generate_channel_states(model, j, masks, s0=s0, method=method,
                                   block_s=block_s, return_final=return_final,
                                   state_dtype=state_dtype, device=device)


class WDMExperiment:
    """WDM ensemble experiment: R wavelength channels, one delay loop.

    The paper's chip-scale scaling scenario (Section VI): R microring
    wavelength channels share one physical delay loop, each with its own
    input stream, MLS mask and readout.  Software-side this is
    ``Experiment`` with the batch axis read as channels and a per-channel
    [R, N] mask stack (DESIGN.md §9): materialized, the states are one
    per-lane scan launch per split and the fit ``fit_ridge_batched``; with
    ``config.stream_chunk_k`` set, the fit is ``fit_ridge_streaming_wdm``
    and the evaluation streams, so no [R, K, N] tensor exists.

    >>> cfg = ExperimentConfig(n_nodes=100, stream_chunk_k=512)
    >>> res = WDMExperiment(cfg, n_channels=16).run(tr_in, tr_tg, te_in, te_tg)
    >>> res.nrmse                                    # [R] — per channel

    Channel masks default to ``make_mask(n_nodes, seed=mask_seed + r)``;
    pass ``masks`` [R, N] to override.  ``shared_readout=True`` (streaming
    only) trains ONE [R·N + 1] readout over the concatenation of every
    channel's states against ONE target stream ([K] or [K, C]; inputs stay
    [R, K]); results are then ensemble-level (B = 1).  ``config.topology``
    (a composed graph per channel) builds per-stage [R, L, N] mask stacks,
    channel r and loop l seeded ``mask_seed + r·L + l``, and runs the
    composed streaming fit with the channels as instances.  Runs on
    ``device`` (default ``cuda``).
    """

    def __init__(self, config: ExperimentConfig, n_channels: int, *, masks=None,
                 shared_readout: bool = False, device=None):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        self.config = config
        self.n_channels = n_channels
        self.shared_readout = shared_readout
        self.device = resolve_device(device)
        if shared_readout and config.stream_chunk_k is None:
            raise ValueError(
                "shared_readout accumulates ONE cross-channel Gram on the "
                "streaming path; set stream_chunk_k")
        if shared_readout and config.topology is not None:
            raise ValueError(
                "shared_readout with a composed topology is not supported; "
                "pick one readout generalisation per run")
        if config.topology is not None:
            if masks is not None:
                raise ValueError("with config.topology the per-stage mask stacks "
                                 "are derived; masks= is not accepted")
            self.masks = build_stage_masks(config.topology, channels=n_channels,
                                           device=self.device)
            return
        if masks is None:
            masks = torch.stack([
                make_mask(config.n_nodes, levels=config.mask_levels,
                          seed=config.mask_seed + r, device=self.device)
                for r in range(n_channels)])
        else:
            masks = torch.as_tensor(masks, dtype=torch.float32, device=self.device)
        if tuple(masks.shape) != (n_channels, config.n_nodes):
            raise ValueError(
                f"masks {tuple(masks.shape)} do not match (R, N) = "
                f"({n_channels}, {config.n_nodes})")
        self.masks = masks

    def run(self, inputs_train, targets_train, inputs_test, targets_test) -> ExperimentResult:
        """Fit per-channel readouts and evaluate, one channel per batch row.

        Inputs are [R, K]; targets may carry a trailing output-channel axis
        ([R, K, C]).  Results are per wavelength channel: ``nrmse``/``ser``/
        ``lam`` [R], ``readout_w`` [R, N + 1(, C)] — or ensemble-level with
        ``shared_readout=True``.
        """
        tr_in = _canon_batch(inputs_train, "inputs_train", self.device)
        te_in = _canon_batch(inputs_test, "inputs_test", self.device)
        if tr_in.shape[0] != self.n_channels or te_in.shape[0] != self.n_channels:
            raise ValueError(
                f"expected {self.n_channels} channel rows, got train "
                f"{tuple(tr_in.shape)} / test {tuple(te_in.shape)}")
        # the shared readout has ONE target stream: canonicalise it against a
        # B = 1 view of the inputs
        rows = 1 if self.shared_readout else self.n_channels
        tr_tg = _canon_targets(targets_train, "targets_train", tr_in[:rows])
        te_tg = _canon_targets(targets_test, "targets_test", te_in[:rows])
        if tr_tg.ndim != te_tg.ndim or (
                tr_tg.ndim == 3 and tr_tg.shape[-1] != te_tg.shape[-1]):
            raise ValueError(
                f"inconsistent target shapes: train {tuple(tr_tg.shape)}, "
                f"test {tuple(te_tg.shape)}")
        out = _run_pipeline(self.config, self.masks, tr_in, tr_tg, te_in, te_tg,
                            wdm=True, shared=self.shared_readout)
        with stage("pack", self.device):
            return _pack_result(*out)
