"""Entry-point registry: every ported hot path, with its contract set.

The port of ``registry.py``: the same entry names at the same tiny shapes,
built on the port's functions.  Each builder takes the device, makes its
arguments (seeded, on that device) and returns ``(Program, rules)``; the
checker runs the program once there.  On the CPU the kernels run as their
plain versions, on the card as themselves.

All 20 of the reference's entries are here.  ``reservoir_lm_train_step``
states ``MaxKernelCalls`` where the reference states ``MaxPallasCalls(0)``:
the port's mixer is a kernel, K1 once in the forward and its adjoint K1ᵀ
once in the backward.

Registering an entry: write a builder ``(device) -> (Program, rules)`` and
decorate it with ``@register(name, description)``.  Keep shapes minimal:
the properties checked do not depend on them.

Kernel-call limits are stated per chunk × chunks (``MaxKernelCalls``):
the reference's one traced scan body is the port's Python chunk loop.
``NoHostSync(allow=...)`` names the syncs a path is known to have: the
error checks of ``torch.linalg.eigh`` and ``torch.linalg.svd``, which read
their ``info`` back to the host on the card (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..pipeline.stages import stage
from .rules import (InPlaceHonored, MaxKernelCalls, NoDtypeAbove, NoHostSync, NoSilentUpcast,
                    NoStateTensor, Program, SmemBudget)

# Tiny shapes shared by the pipeline entries (the reference's).
_B, _N, _T_TR, _T_TE, _CHUNK, _W0 = 2, 16, 96, 64, 32, 16
_LAMS = (1e-6, 1e-4)
_FIT_CHUNKS = -(-_T_TR // _CHUNK)
_EVAL_CHUNKS = -(-_T_TE // _CHUNK)

# The library calls that read their error status back to the host.
_EIGH = ("_linalg_eigh",)
_SVD = ("_linalg_svd",)


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    description: str
    build: object          # (device) -> (Program, tuple[Rule, ...])


ENTRY_POINTS = {}


def register(name: str, description: str):
    def deco(fn):
        ENTRY_POINTS[name] = EntryPoint(name, description, fn)
        return fn
    return deco


def _streams(device, *shapes, seed: int = 0):
    """Seeded uniform [0, 1) f32 streams of ``shapes`` on ``device``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.uniform(0.0, 1.0, s), dtype=torch.float32, device=device)
                 for s in shapes)


def _experiment_setup(device, **cfg_kw):
    from ..core import SiliconMR
    from ..pipeline import Experiment, ExperimentConfig
    base = dict(model=SiliconMR(), n_nodes=_N, washout=_W0, ridge_l2=_LAMS,
                state_noise_rel=0.0)
    base.update(cfg_kw)
    cfg = ExperimentConfig(**base)
    mask = Experiment(cfg, device=device).mask
    args = _streams(device, (_B, _T_TR), (_B, _T_TR), (_B, _T_TE), (_B, _T_TE))
    return cfg, mask, args


def _pipeline_program(name, device, **cfg_kw):
    from ..pipeline.experiment import _run_pipeline
    cfg, mask, args = _experiment_setup(device, **cfg_kw)
    return Program(lambda a, b, c, d: _run_pipeline(cfg, mask, a, b, c, d), args, name=name)


def _state_rules(what="state tensor"):
    return (NoStateTensor(_T_TR, _B * _T_TR * _N, what=f"train {what}"),
            NoStateTensor(_T_TE, _B * _T_TE * _N, what=f"test {what}"))


@register("experiment_ref", "Experiment pipeline, reference reservoir, SVD readout")
def _experiment_ref(device):
    prog = _pipeline_program("experiment_ref", device, state_method="ref",
                             readout_use_kernel=False)
    return prog, (NoHostSync(allow=_SVD), NoDtypeAbove("float32"), MaxKernelCalls(0))


@register("experiment_fast", "Experiment pipeline, vectorised reservoir, SVD readout")
def _experiment_fast(device):
    prog = _pipeline_program("experiment_fast", device, state_method="fast",
                             readout_use_kernel=False)
    return prog, (NoHostSync(allow=_SVD), NoDtypeAbove("float32"), MaxKernelCalls(0))


@register("experiment_kernel", "Experiment pipeline, materialized kernel path (K1 + K2)")
def _experiment_kernel(device):
    prog = _pipeline_program("experiment_kernel", device, state_method="kernel",
                             readout_use_kernel=True)
    # train K1 + test K1 + one batched Gram (K2)
    return prog, (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"), MaxKernelCalls(3),
                  SmemBudget())


@register("experiment_streaming", "Experiment pipeline, streamed fit + eval (no [B,T,N] tensor)")
def _experiment_streaming(device):
    prog = _pipeline_program("experiment_streaming", device, state_method="kernel",
                             readout_use_kernel=True, stream_chunk_k=_CHUNK)
    # K1 + K3 a fit chunk, K1 + the readout-apply kernel an eval chunk
    rules = (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"),
             MaxKernelCalls((2, _FIT_CHUNKS), (2, _EVAL_CHUNKS)), SmemBudget(),
             *_state_rules())
    return prog, rules


def _streaming_fit_program(name, device, *, wdm=False, state_dtype=None):
    from ..core import SiliconMR, make_mask
    from ..pipeline import fit_ridge_streaming, fit_ridge_streaming_wdm
    model = SiliconMR()
    kw = dict(washout=_W0, chunk_k=_CHUNK, lambdas=_LAMS, state_method="kernel",
              use_kernel=True, state_dtype=state_dtype, device=device)
    j, y = _streams(device, (_B, _T_TR), (_B, _T_TR))
    if wdm:
        masks = torch.stack([make_mask(_N, seed=30 + i, device=device) for i in range(_B)])
        fit, mask = fit_ridge_streaming_wdm, masks
    else:
        fit, mask = fit_ridge_streaming, make_mask(_N, seed=1, device=device)
    return Program(lambda jj, yy: fit(model, mask, jj, yy, **kw), (j, y), name=name)


def _streaming_fit_rules():
    return (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"),
            MaxKernelCalls((2, _FIT_CHUNKS)),          # K1 + K3 a chunk
            SmemBudget(),
            NoStateTensor(_T_TR, _B * _T_TR * _N, what="full-stream tensor"),
            InPlaceHonored(min_into_calls=_FIT_CHUNKS))  # every fold into one G/c


@register("fit_ridge_streaming", "Streamed ridge fit: K1 + K3 a chunk, accumulate-into Gram")
def _fit_ridge_streaming(device):
    return _streaming_fit_program("fit_ridge_streaming", device), _streaming_fit_rules()


@register("fit_ridge_streaming_bf16",
          "Streamed ridge fit with bf16 state chunks (no silent f32 chunk)")
def _fit_ridge_streaming_bf16(device):
    prog = _streaming_fit_program("fit_ridge_streaming_bf16", device, state_dtype="bfloat16")
    # The f32 carry [B, N] and the input chunk (no node axis) stay f32; a
    # wide block at state-chunk scale (B × chunk × N) does not.
    return prog, _streaming_fit_rules() + (NoSilentUpcast(_CHUNK, _B * _CHUNK * _N),)


@register("fit_ridge_streaming_wdm", "WDM streamed fit: all channels in one K1 + K3 a chunk")
def _fit_ridge_streaming_wdm(device):
    return (_streaming_fit_program("fit_ridge_streaming_wdm", device, wdm=True),
            _streaming_fit_rules())


# Device-physics entries (DESIGN.md §14): the CMT cavity's sub-stepped tick
# holds the same contracts as the closed-form models.
def _cmt_model():
    from ..core import SiliconMR
    from ..devices import calibrated_twin
    return calibrated_twin(SiliconMR(), power_mw=1.0)


@register("experiment_cmt_kernel", "CMT-cavity pipeline through K1's CMT form (substeps in-thread)")
def _experiment_cmt_kernel(device):
    prog = _pipeline_program("experiment_cmt_kernel", device, model=_cmt_model(),
                             state_method="kernel", readout_use_kernel=True)
    # the launch budget of experiment_kernel: richer physics adds no call
    return prog, (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"), MaxKernelCalls(3),
                  SmemBudget())


def _device_sweep_program(name, device, *, state_dtype="float32", use_kernel=False):
    from ..devices import CMTSweepParams
    from ..pipeline.experiment import _run_pipeline
    cfg, mask, args = _experiment_setup(
        device, model=_cmt_model(), state_method="fast", stream_chunk_k=_CHUNK,
        stream_state_dtype=state_dtype, readout_use_kernel=use_kernel)
    lanes = (torch.zeros((_B,), dtype=torch.float32, device=device),   # detune
             torch.ones((_B,), dtype=torch.float32, device=device),    # loss_scale
             torch.ones((_B,), dtype=torch.float32, device=device))    # power

    def fn(a, b, c, d, pd, pl, pp):
        return _run_pipeline(cfg, mask, a, b, c, d, dev_params=CMTSweepParams(pd, pl, pp))

    return Program(fn, args + lanes, name=name)


@register("device_sweep", "Swept-params CMT robustness map: grid as lanes, one streamed run")
def _device_sweep(device):
    prog = _device_sweep_program("device_sweep", device)
    return prog, (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"),
                  MaxKernelCalls(0),          # torch states and a matmul Gram throughout
                  *_state_rules())


@register("device_sweep_bf16", "Swept CMT map, bf16 state chunks (no silent f32 chunk upcast)")
def _device_sweep_bf16(device):
    prog = _device_sweep_program("device_sweep_bf16", device, state_dtype="bfloat16",
                                 use_kernel=True)
    # The fast path computes its states in f32 by design (only the emitted
    # chunk narrows: generate_states' docstring), so the [B, chunk, N]
    # block is declared benign, as in the reference.  Anything else wide at
    # chunk scale, e.g. a re-widened [B, chunk, N + 1] feature block, trips,
    # in the fit and in the streamed evaluation alike (the readout-apply
    # kernel reads the bf16 features as they are).
    benign = ((_B, _CHUNK, _N),)
    rules = (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"),
             # K3 a fit chunk, the readout-apply kernel an eval chunk
             MaxKernelCalls((1, _FIT_CHUNKS), (1, _EVAL_CHUNKS)),
             SmemBudget(), *_state_rules(),
             NoSilentUpcast(_CHUNK, _B * _CHUNK * _N, benign_shapes=benign))
    return prog, rules


# Composed-graph shapes: a depth-3 chain whose smallest stage sets the
# NoStateTensor floor, so any stage materializing its full-T [B·L, T, N]
# block trips the rule while the O(B·T) streams stay under it.
def _trace_graph(depth: int):
    from ..core import ReservoirStage, SiliconMR, chain
    stages = [ReservoirStage(model=SiliconMR(), n_nodes=_N, loops=2, mask_seed=1),
              ReservoirStage(model=SiliconMR(), n_nodes=_N, mask_seed=7),
              ReservoirStage(model=SiliconMR(), n_nodes=8, mask_seed=13, link="sin2")]
    return chain(*stages[-depth:])


@register("fit_ridge_streaming_composed",
          "Composed depth-3 streamed fit: the stage chain a chunk, one K3 a chunk")
def _fit_ridge_streaming_composed(device):
    from ..core import build_stage_masks
    from ..pipeline import fit_ridge_streaming_composed
    graph = _trace_graph(3)
    masks = build_stage_masks(graph, device=device)
    kw = dict(washout=_W0, chunk_k=_CHUNK, lambdas=_LAMS, state_method="kernel",
              use_kernel=True, device=device)
    j, y = _streams(device, (_B, _T_TR), (_B, _T_TR))
    prog = Program(lambda jj, yy: fit_ridge_streaming_composed(graph, masks, jj, yy, **kw),
                   (j, y), name="fit_ridge_streaming_composed")
    w_min = min(st.n_nodes for st in graph.stages)
    rules = (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"),
             MaxKernelCalls((graph.depth + 1, _FIT_CHUNKS)),   # K1 a stage + K3
             SmemBudget(),
             NoStateTensor(_T_TR, _B * _T_TR * w_min, what="full-stream stage tensor"),
             InPlaceHonored(min_into_calls=_FIT_CHUNKS))
    return prog, rules


@register("fit_ridge_streaming_shared",
          "Shared-readout WDM fit: one cross-channel Gram, K1 + K3 a chunk")
def _fit_ridge_streaming_shared(device):
    from ..core import SiliconMR, make_mask
    from ..pipeline import fit_ridge_streaming_shared
    model = SiliconMR()
    masks = torch.stack([make_mask(_N, seed=40 + i, device=device) for i in range(_B)])
    kw = dict(washout=_W0, chunk_k=_CHUNK, lambdas=_LAMS, state_method="kernel",
              use_kernel=True, device=device)
    j, y = _streams(device, (_B, _T_TR), (_T_TR,))
    prog = Program(lambda jj, yy: fit_ridge_streaming_shared(model, masks, jj, yy, **kw),
                   (j, y), name="fit_ridge_streaming_shared")
    return prog, _streaming_fit_rules()


@register("experiment_composed", "Depth-2 composed Experiment: streamed fit + eval, no stage tensor")
def _experiment_composed(device):
    graph = _trace_graph(2)
    prog = _pipeline_program("experiment_composed", device, state_method="kernel",
                             readout_use_kernel=True, stream_chunk_k=_CHUNK, topology=graph)
    w_min = min(st.n_nodes for st in graph.stages)
    rules = (NoHostSync(allow=_EIGH), NoDtypeAbove("float32"),
             # fit: K1 a stage + K3 a chunk; eval: K1 a stage + the
             # readout-apply kernel a chunk
             MaxKernelCalls((graph.depth + 1, _FIT_CHUNKS), (graph.depth + 1, _EVAL_CHUNKS)),
             SmemBudget(),
             NoStateTensor(_T_TR, _B * _T_TR * w_min, what="train stage tensor"),
             NoStateTensor(_T_TE, _B * _T_TE * w_min, what="test stage tensor"))
    return prog, rules


def _session_program(name, device, *, refresh, **cfg_kw):
    from ..core import make_mask
    from ..pipeline.session import SessionConfig, _session_step, session_init
    cfg = SessionConfig(n_nodes=_N, chunk_k=_CHUNK, **cfg_kw)
    mask = make_mask(cfg.n_nodes, seed=0, device=device)
    state = session_init(cfg, _B, device=device)
    j, y = _streams(device, (_B, _CHUNK), (_B, _CHUNK))
    # ``_session_step`` updates the slab it is handed (the donated slab of
    # the reference's server)
    return Program(lambda st, jc, yc: _session_step(cfg, mask, st, jc, yc, refresh=refresh),
                   (state, j, y), inplace_argnums=(0,), name=name)


def _session_rules(allow=()):
    return (NoHostSync(allow=allow), NoDtypeAbove("float32"),
            NoStateTensor(4096, _B * 4096 * _N, what="full-stream tensor"))


# The slab's Gram and moment stacks, the O(B·F²) leaves a tick folds in place.
_SLAB = ("g", "c")


@register("session_step", "Online session tick (carry + Gram fold)")
def _session_step_entry(device):
    return _session_program("session_step", device, refresh=False), _session_rules()


@register("session_step_refresh", "Online session tick with a weight refresh (GCV solve)")
def _session_step_refresh(device):
    return (_session_program("session_step_refresh", device, refresh=True),
            _session_rules(_EIGH))


@register("session_step_kernel", "Online session tick on the kernel path (one K1 + one K3)")
def _session_step_kernel(device):
    prog = _session_program("session_step_kernel", device, refresh=False,
                            state_method="kernel", use_kernel=True)
    # K1, K3 and the readout-apply kernel's prediction
    return prog, _session_rules() + (MaxKernelCalls(3), SmemBudget(),
                                     InPlaceHonored(fields=_SLAB, min_into_calls=1))


@register("serve_dfr_step", "DFRServer step: the SessionState slab updates in place")
def _serve_dfr_step(device):
    prog = _session_program("serve_dfr_step", device, refresh=True, forgetting=0.99)
    return prog, _session_rules(_EIGH) + (InPlaceHonored(fields=_SLAB),)


def _faulted_program(name, device, *, refresh, **cfg_kw):
    from ..core import make_mask
    from ..pipeline.session import SessionConfig, session_init
    from ..robustness.faults import faulty_session_step, no_faults
    cfg = SessionConfig(n_nodes=_N, chunk_k=_CHUNK, **cfg_kw)
    mask = make_mask(cfg.n_nodes, seed=0, device=device)
    state = session_init(cfg, _B, device=device)
    spec = no_faults(_B, device=device)
    j, y = _streams(device, (_B, _CHUNK), (_B, _CHUNK))

    def fn(sp, st, jc, yc, tick):
        return faulty_session_step(cfg, mask, sp, st, jc, yc, tick, refresh=refresh)

    return Program(fn, (spec, state, j, y, 0), inplace_argnums=(1,), name=name)


@register("session_step_faulted", "Fault-injected session tick: injections + quarantine")
def _session_step_faulted(device):
    # the clean tick's contracts: fault models are operand transforms on
    # the device, never host round trips or new tensors
    return (_faulted_program("session_step_faulted", device, refresh=True),
            _session_rules(_EIGH))


@register("session_step_faulted_kernel",
          "Fault-injected session tick on the kernel path (still one K1 + one K3)")
def _session_step_faulted_kernel(device):
    prog = _faulted_program("session_step_faulted_kernel", device, refresh=False,
                            state_method="kernel", use_kernel=True)
    # K1, K3 and the readout-apply kernel's prediction
    return prog, _session_rules() + (MaxKernelCalls(3), SmemBudget(),
                                     InPlaceHonored(fields=_SLAB, min_into_calls=1))


@register("reservoir_lm_train_step",
          "reservoir_lm train step (grad accumulation, the train state updated in place)")
def _reservoir_lm_train_step(device):
    from ..configs import smoke_config
    from ..optim import AdamWConfig
    from ..runtime.steps import init_train_state, train_step
    cfg = smoke_config("reservoir_lm")
    opt = AdamWConfig()
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    b, s = 2 * max(1, cfg.microbatches), 16
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device),
             "labels": torch.zeros((b, s), dtype=torch.int32, device=device)}
    prog = Program(lambda st, bt: train_step(cfg, opt, st, bt), (state, batch),
                   inplace_argnums=(0,), name="reservoir_lm_train_step")
    # one layer, one microbatch, no remat: K1 once (forward), K1ᵀ once (backward)
    return prog, (NoHostSync(), NoDtypeAbove("float32"), MaxKernelCalls(1, 1),
                  InPlaceHonored())


def seeded_violation_entry() -> EntryPoint:
    """A deliberately violating entry (a materialized [B, T, N] state
    tensor under ``NoStateTensor``): the gate's self-test, which must exit
    nonzero."""
    def build(device):
        from ..core import SiliconMR, make_mask
        from ..core.reservoir import generate_states
        from ..pipeline import fit_ridge_batched
        model = SiliconMR()
        mask = make_mask(_N, seed=1, device=device)

        def fit(j, y):
            with stage("states_train", j.device):
                st = generate_states(model, j, mask, method="fast", device=j.device)
            return fit_ridge_batched(st[:, _W0:], y[:, _W0:], lambdas=_LAMS,
                                     use_kernel=False, device=j.device)

        prog = Program(fit, _streams(device, (_B, _T_TR), (_B, _T_TR)),
                       name="seeded_violation")
        return prog, (NoStateTensor(_T_TR, _B * _T_TR * _N),)
    return EntryPoint("seeded_violation",
                      "Deliberate NoStateTensor violation (gate self-test)", build)


def entry_point_names() -> list:
    return sorted(ENTRY_POINTS)


def get_entry_points(names=None, *, include_seeded=False) -> list:
    """Resolve ``names`` (None = all registered) to EntryPoint objects."""
    eps = dict(ENTRY_POINTS)
    if include_seeded:
        seeded = seeded_violation_entry()
        eps[seeded.name] = seeded
    if names is None:
        return [eps[n] for n in sorted(eps)]
    missing = [n for n in names if n not in eps]
    if missing:
        raise KeyError(f"unknown entry point(s) {missing}; known: {sorted(eps)}")
    return [eps[n] for n in names]
