"""Port parity: composed reservoir graphs (repro_torch.core.graph, DESIGN.md §13).

Mirrors tests/test_composed.py case by case.  Both packages' graphs are
built from one description: the reference's graph, carried into the port
by ``repro_torch.convert.graph_from_reference``.  The same numpy inputs go
through both on the CPU, where the port's kernel wrappers take their plain
versions; the JAX side runs its ``fast`` path, as its own tests do.

Tolerances:

* port vs JAX states and carries: ≤ 2e-6 (f32 node chains; the link's
  f32 mean is summed in another order, and the next stage's drive carries
  that round-off through its own chain);
* port vs JAX streamed composed fit: the same λ index, predictions on the
  oracle's features within 0.02 — the reference's own bound between its
  streamed fit and its materialized oracle (the f32 Gram of a multi-loop
  stage is rank-deficient, so w is unique only up to its null space; two
  f32 Grams summed in another order move it along that space: 7.3e-3
  measured on the CPU);
* within the port: depth 1 equals the single-loop path bitwise, the chain
  resumes bitwise at any split, the lane fold equals L separate reservoirs
  bitwise;
* the composed Experiment and the per-channel WDM topology: ≤ 1e-3 NRMSE.

The reference's jaxpr "no full-K stage tensor" contract becomes the shape
record of the port's contract tracer (``repro_torch.analysis.tracer.Trace``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ReservoirStage as JStage
from repro.core import SiliconMR as JMR
from repro.core import build_stage_masks as jbuild_stage_masks
from repro.core import chain as jchain
from repro.core import graph_states as jgraph_states
from repro.core.graph import stage_link_drive as jstage_link_drive
from repro.core.graph import stage_states as jstage_states
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro.pipeline import WDMExperiment as JWDMExperiment
from repro.pipeline import fit_ridge_streaming_composed as jfit_composed
from repro_torch.analysis.tracer import Trace
from repro_torch.convert import config_from_reference, graph_from_reference
from repro_torch.core import (LINK_NONLINEARITIES, ReservoirGraph, ReservoirStage, SiliconMR,
                              build_stage_masks, chain, generate_states, graph_states,
                              make_mask, single, stage_link_drive, stage_states, tasks)
from repro_torch.pipeline import (Experiment, ExperimentConfig, WDMExperiment,
                                  composed_chunk_states_fn, fit_ridge_batched,
                                  fit_ridge_streaming, fit_ridge_streaming_composed,
                                  solve_gcv, with_bias)
from repro_torch.pipeline.ridge import _fold_chunk, _plan_fold

MODEL = SiliconMR()
LAMS = (1e-6, 1e-4)
B, K, N, W0, CHUNK = 3, 90, 12, 10, 32   # K % CHUNK != 0: ragged tail
STATE_TOL = 2e-6
PRED_TOL = 0.02
NRMSE_TOL = 1e-3


def _stream(seed, b=B, k=K):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (b, k)).astype(np.float32),
            rng.standard_normal((b, k)).astype(np.float32))


def _jgraph2():
    """The reference's depth-2 chain with a multi-loop first stage
    (width 2·12 + 7 = 31)."""
    return jchain(JStage(model=JMR(), n_nodes=N, loops=2, mask_seed=3),
                  JStage(model=JMR(), n_nodes=7, mask_seed=11, link="sin2"))


def _graphs():
    """(reference graph, the port's graph of it)."""
    jg = _jgraph2()
    return jg, graph_from_reference(jg)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# Graph construction and validation
# ---------------------------------------------------------------------------


def test_graph_shapes_and_layout_match_reference():
    jg, g = _graphs()
    assert (g.depth, g.width, g.carry_layout) == (jg.depth, jg.width, jg.carry_layout)
    assert g.carry_layout == ((2, N), (1, 7)) and g.width == 2 * N + 7
    assert not single(g) and single(chain(ReservoirStage(n_nodes=5)))
    masks, jmasks = build_stage_masks(g), jbuild_stage_masks(jg)
    assert [tuple(m.shape) for m in masks] == [(2, N), (1, 7)]
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(_np(m), np.asarray(jm))
    assert not torch.equal(masks[0][0], masks[0][1])
    assert torch.equal(masks[0][0], make_mask(N, seed=3))
    assert build_stage_masks(g, device="cpu")[0].device.type == "cpu"


def test_graph_validation():
    with pytest.raises(ValueError, match="at least one stage"):
        ReservoirGraph(stages=())
    with pytest.raises(ValueError, match="loops"):
        ReservoirStage(loops=0)
    with pytest.raises(ValueError, match="n_nodes"):
        ReservoirStage(n_nodes=0)
    with pytest.raises(ValueError, match="unknown link"):
        ReservoirStage(link="tanh")
    with pytest.raises(TypeError, match="ReservoirStage"):
        ReservoirGraph(stages=(object(),))
    with pytest.raises(ValueError, match="stage mask stacks"):
        graph_states(_graphs()[1], torch.zeros((B, K)), (torch.zeros((2, N)),), device="cpu")
    with pytest.raises(ValueError, match="stage mask stacks"):
        composed_chunk_states_fn(_graphs()[1], (torch.zeros((2, N)),), device="cpu")
    g = _graphs()[1]
    with pytest.raises(ValueError, match="per-instance masks"):
        stage_states(g.stages[0], torch.zeros((B, K)), torch.zeros((B + 1, 2, N)), None,
                     device="cpu")
    assert isinstance(ReservoirGraph(stages=[ReservoirStage()]).stages, tuple)


def test_per_channel_masks_unique_and_equal_to_reference():
    jg, g = _graphs()
    masks = build_stage_masks(g, channels=3)
    jmasks = jbuild_stage_masks(jg, channels=3)
    assert tuple(masks[0].shape) == (3, 2, N) and tuple(masks[1].shape) == (3, 1, 7)
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(_np(m), np.asarray(jm))
    flat = _np(masks[0]).reshape(6, N)
    assert len({tuple(row) for row in flat}) == 6     # no (channel, loop) reuse


# ---------------------------------------------------------------------------
# Depth 1 == the single-loop reservoir, bitwise, within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["ref", "fast", "kernel"])
def test_depth1_states_bitwise(method):
    j, _ = _stream(0)
    g = chain(ReservoirStage(model=MODEL, n_nodes=N, mask_seed=5))
    ref, fin_ref = generate_states(MODEL, j, make_mask(N, seed=5), method=method,
                                   return_final=True, device="cpu")
    got, fin = graph_states(g, j, build_stage_masks(g), method=method, return_final=True,
                            device="cpu")
    assert torch.equal(got, ref)
    assert torch.equal(fin[0][:, 0], fin_ref)


@pytest.mark.parametrize("per_instance", [False, True], ids=["shared", "per_channel"])
def test_depth1_per_instance_masks_are_channel_states(per_instance):
    """A loops-1 stage with per-instance masks is a literal
    ``generate_channel_states`` call; with shared masks ``generate_states``."""
    from repro_torch.core import generate_channel_states

    j, _ = _stream(8)
    st = ReservoirStage(model=MODEL, n_nodes=N, mask_seed=4)
    masks = build_stage_masks(chain(st), channels=B if per_instance else None)[0]
    feats, carry = stage_states(st, torch.as_tensor(j), masks, None, method="kernel",
                                device="cpu")
    if per_instance:
        ref, fin = generate_channel_states(MODEL, j, masks[:, 0], method="kernel",
                                           return_final=True, device="cpu")
    else:
        ref, fin = generate_states(MODEL, j, masks[0], method="kernel", return_final=True,
                                   device="cpu")
    assert torch.equal(feats, ref) and torch.equal(carry[:, 0], fin)


@pytest.mark.parametrize("method", ["fast", "kernel"])
def test_depth1_streaming_fit_bitwise(method):
    """The composed streamed fit at depth 1 is fit_ridge_streaming, bit for
    bit: weights, λ index and the train -> test carry."""
    j, y = _stream(1)
    g = chain(ReservoirStage(model=MODEL, n_nodes=N, mask_seed=5))
    kw = dict(washout=W0, chunk_k=CHUNK, lambdas=LAMS, state_method=method, use_kernel=True,
              device="cpu")
    w_ref, i_ref, s_ref = fit_ridge_streaming(MODEL, make_mask(N, seed=5), j, y, **kw)
    w_c, i_c, s_c = fit_ridge_streaming_composed(g, build_stage_masks(g), j, y, **kw)
    assert torch.equal(w_c, w_ref) and torch.equal(i_c, i_ref)
    assert torch.equal(s_c[0][:, 0], s_ref)


def test_depth1_experiment_topology_bitwise():
    """A depth-1 topology reproduces the single-loop streamed Experiment
    exactly — predictions, metrics, weights, λ; a bare ReservoirStage is
    lifted to a one-stage graph."""
    ds = tasks.narma10(420, seed=2)
    base = dict(n_nodes=N, washout=W0, state_noise_rel=0.0, stream_chunk_k=CHUNK,
                state_method="fast", ridge_l2=LAMS)
    r0 = Experiment(ExperimentConfig(**base), device="cpu").run_dataset(ds)
    stage = ReservoirStage(model=MODEL, n_nodes=N, mask_seed=1)
    cfg = ExperimentConfig(**base, topology=stage)
    assert cfg.topology == chain(stage)
    r1 = Experiment(cfg, device="cpu").run_dataset(ds)
    for f in ("y_pred", "nrmse", "ser", "readout_w", "lam"):
        np.testing.assert_array_equal(getattr(r0, f), getattr(r1, f))


# ---------------------------------------------------------------------------
# The composed chain: against the reference, the oracle, and resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["fast", "kernel"])
def test_graph_states_match_reference(method):
    j, _ = _stream(2)
    jg, g = _graphs()
    jm = jbuild_stage_masks(jg)
    want, jfin = jgraph_states(jg, jnp.asarray(j), jm, method="fast", return_final=True)
    got, fin = graph_states(g, j, build_stage_masks(g), method=method, return_final=True,
                            device="cpu")
    assert tuple(got.shape) == (B, K, g.width)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=STATE_TOL, rtol=0)
    for a, b in zip(fin, jfin):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=STATE_TOL, rtol=0)
    one, _ = graph_states(g, j[0], build_stage_masks(g), method=method, return_final=True,
                          device="cpu")
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("method", ["fast", "kernel"])
def test_composed_fit_matches_materialized_oracle_and_reference(method):
    """Streamed composed fit ≈ the Gram fit of the materialized
    ``graph_states`` features: the same λ, the per-stage carries the
    oracle's, predictions at parity; and ≈ the reference's streamed fit
    (the same λ, predictions within PRED_TOL).  Prediction-level, as in the
    reference: a multi-loop stage's shared drive makes the Gram
    rank-deficient, so w is unique only up to its null space."""
    j, y = _stream(2)
    jg, g = _graphs()
    masks = build_stage_masks(g)
    w_s, i_s, s_s = fit_ridge_streaming_composed(
        g, masks, j, y, washout=W0, chunk_k=CHUNK, lambdas=LAMS, state_method=method,
        use_kernel=True, device="cpu")
    feats, carr = graph_states(g, j, masks, method=method, return_final=True, device="cpu")
    w_m, i_m = fit_ridge_batched(feats[:, W0:], torch.as_tensor(y)[:, W0:], lambdas=LAMS,
                                 use_kernel=True, device="cpu")
    assert torch.equal(i_s, i_m)
    x = with_bias(feats[:, W0:])
    np.testing.assert_allclose(_np(x @ w_s), _np(x @ w_m), atol=PRED_TOL)
    for got, want in zip(s_s, carr):
        assert torch.equal(got, want)
    jw, ji, _ = jfit_composed(jg, jbuild_stage_masks(jg), jnp.asarray(j), jnp.asarray(y),
                              washout=W0, chunk_k=CHUNK, lambdas=LAMS, state_method="fast",
                              use_kernel=False)
    np.testing.assert_array_equal(_np(i_s), np.asarray(ji))
    np.testing.assert_allclose(_np(x @ w_s), _np(x) @ np.asarray(jw)[:, :g.width + 1],
                               atol=PRED_TOL)


@pytest.mark.parametrize("cuts", [[13], [32, 64], [7, 40, 41, 89]],
                         ids=["mid", "aligned", "ragged"])
def test_composed_resume_bit_exact(cuts):
    """The chain cut at fixed splits replays the uninterrupted run exactly:
    the features and every stage's carry."""
    j, _ = _stream(3)
    g = _graphs()[1]
    masks = build_stage_masks(g)
    full, fin = graph_states(g, j, masks, method="fast", return_final=True, device="cpu")
    bounds = [0] + cuts + [K]
    s, parts = None, []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        states, s = graph_states(g, j[:, lo:hi], masks, s0=s, method="fast",
                                 return_final=True, device="cpu")
        parts.append(states)
    assert torch.equal(torch.cat(parts, dim=1), full)
    for got, want in zip(s, fin):
        assert torch.equal(got, want)


def test_composed_fold_resumed_at_uneven_cuts_is_one_pass():
    """What chip_smoke.py's ``composed`` phase checks on the card: the chain
    run in four uneven pieces from the handed carries, each folded into the
    same running Gram stacks, gives the features and carries of one pass
    bitwise, and its (G, c) to f32 round-off.  On the card K3's fold is
    bitwise one pass for any split too (its plain version here folds in
    row blocks, which a cut moves)."""
    j, y = _stream(4, k=200)
    g = chain(ReservoirStage(model=MODEL, n_nodes=N, loops=2, mask_seed=3, link="sin2",
                             link_gain=0.28),
              ReservoirStage(model=MODEL, n_nodes=6, loops=2, mask_seed=10),
              ReservoirStage(model=MODEL, n_nodes=4, mask_seed=17))
    fn = composed_chunk_states_fn(g, build_stage_masks(g), state_method="kernel",
                                  device="cpu")
    yv = torch.as_tensor(y)[..., None]
    plan = _plan_fold(g.width + 1, 200, use_kernel=True, block_t=512, batch=B)

    def run(bounds):
        gm = torch.zeros((B, g.width + 1, g.width + 1))
        cm = torch.zeros((B, g.width + 1, 1))
        s = tuple(torch.zeros((B, lp, n)) for lp, n in g.carry_layout)
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            feats, s = fn(torch.as_tensor(j[:, lo:hi]), s)
            parts.append(feats)
            _fold_chunk(plan, gm, cm, torch.zeros(B), with_bias(feats), yv[:, lo:hi])
        return gm, cm, s, torch.cat(parts, dim=1)

    one, cut = run([0, 200]), run([0, 37, 38, 121, 200])
    assert torch.equal(one[3], cut[3])
    for a, b in zip(one[2], cut[2]):
        assert torch.equal(a, b)
    torch.testing.assert_close(cut[0], one[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cut[1], one[1], rtol=1e-5, atol=1e-5)
    y2 = torch.sum(yv * yv, dim=(1, 2))
    assert torch.equal(solve_gcv(one[0], one[1], y2, 200, LAMS)[1],
                       solve_gcv(cut[0], cut[1], y2, 200, LAMS)[1])


@pytest.mark.parametrize("per_instance", [False, True], ids=["shared", "per_channel"])
def test_multi_loop_stage_is_lane_fold(per_instance):
    """A loops = 2 stage with two different masks equals two separate
    single-mask reservoirs on the same drive (the lane fold pairs drive b
    with loop l's mask; swapping ``repeat``/``repeat_interleave`` would not),
    and equals the reference's stage."""
    from repro_torch.core import generate_channel_states

    j, _ = _stream(4)
    st = ReservoirStage(model=MODEL, n_nodes=N, loops=2, mask_seed=3)
    masks = build_stage_masks(chain(st), channels=B if per_instance else None)[0]
    assert not torch.equal(masks[..., 0, :], masks[..., 1, :])
    feats, carry = stage_states(st, torch.as_tensor(j), masks, None, method="kernel",
                                device="cpu")
    for lp in range(2):
        if per_instance:
            ref, fin = generate_channel_states(MODEL, j, masks[:, lp], method="kernel",
                                               return_final=True, device="cpu")
        else:
            ref, fin = generate_states(MODEL, j, masks[lp], method="kernel",
                                       return_final=True, device="cpu")
        assert torch.equal(feats[..., lp * N:(lp + 1) * N], ref)
        assert torch.equal(carry[:, lp], fin)
    jst = JStage(model=JMR(), n_nodes=N, loops=2, mask_seed=3)
    jm = jbuild_stage_masks(jchain(jst), channels=B if per_instance else None)[0]
    want, jcarry = jstage_states(jst, jnp.asarray(j), jm, None, method="fast")
    np.testing.assert_allclose(_np(feats), np.asarray(want), atol=STATE_TOL, rtol=0)
    np.testing.assert_allclose(_np(carry), np.asarray(jcarry), atol=STATE_TOL, rtol=0)


@pytest.mark.parametrize("link", sorted(LINK_NONLINEARITIES))
def test_link_drive_bounded_and_matches_reference(link):
    """The saturable link keeps any feature scale inside (-1, 1); every
    link's drive, gained or not, equals the reference's to f32 round-off."""
    f = np.random.default_rng(0).uniform(0, 1, (2, 16, 4)).astype(np.float32)
    for gain in (1.0, 0.28, 50.0):
        st = ReservoirStage(model=MODEL, n_nodes=4, link=link, link_gain=gain)
        p = stage_link_drive(st, torch.as_tensor(f))
        assert tuple(p.shape) == (2, 16) and p.dtype == torch.float32
        want = jstage_link_drive(JStage(model=JMR(), n_nodes=4, link=link, link_gain=gain),
                                 jnp.asarray(f))
        np.testing.assert_allclose(_np(p), np.asarray(want), rtol=1e-6, atol=1e-6)
        if link == "sat":
            assert float(p.abs().max()) < 1.0
    bf = torch.as_tensor(f).to(torch.bfloat16)
    st = ReservoirStage(model=MODEL, n_nodes=4, link=link)
    assert torch.equal(stage_link_drive(st, bf), stage_link_drive(st, bf.float()))


def test_input_gain_scales_the_drive():
    j, _ = _stream(5)
    st = ReservoirStage(model=MODEL, n_nodes=N, input_gain=0.5, mask_seed=2)
    feats, _ = stage_states(st, torch.as_tensor(j), build_stage_masks(chain(st))[0], None,
                            device="cpu")
    ref = generate_states(MODEL, torch.as_tensor(j) * 0.5, make_mask(N, seed=2), device="cpu")
    assert torch.equal(feats, ref)
    jst = JStage(model=JMR(), n_nodes=N, input_gain=0.5, mask_seed=2)
    want, _ = jstage_states(jst, jnp.asarray(j), jbuild_stage_masks(jchain(jst))[0], None)
    np.testing.assert_allclose(_np(feats), np.asarray(want), atol=STATE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Experiment and WDMExperiment with a topology
# ---------------------------------------------------------------------------


def test_topology_requires_streaming_and_a_graph():
    g = chain(ReservoirStage(model=MODEL, n_nodes=N))
    with pytest.raises(ValueError, match="stream_chunk_k"):
        ExperimentConfig(n_nodes=N, topology=g, state_noise_rel=0.0)
    with pytest.raises(TypeError, match="ReservoirGraph"):
        ExperimentConfig(n_nodes=N, topology=object(), stream_chunk_k=CHUNK,
                         state_noise_rel=0.0)
    cfg = ExperimentConfig(n_nodes=N, topology=g, stream_chunk_k=CHUNK, state_noise_rel=0.0)
    exp = Experiment(cfg, device="cpu")
    assert len(exp.mask) == 1 and tuple(exp.mask[0].shape) == (1, N)
    with pytest.raises(ValueError, match="composed topology"):
        exp.run(np.zeros(80), np.zeros(80), np.zeros(80), np.zeros(80), dev_params={})


def test_experiment_topology_matches_reference():
    """The composed streamed Experiment on NARMA10 (B = 2), through the
    kernel paths, against the reference's: NRMSE within NRMSE_TOL, the same
    λ, readouts of width graph.width + 1; the config carried across by
    ``config_from_reference``.  At λ = 1e-4: at 1e-6 the rank-deficient
    Gram makes the reference's own NRMSE move by 3.5e-3 when its inputs
    move by 2e-7 relative (measured on these seeds)."""
    batch = tuple(np.stack([getattr(tasks.narma10(420, seed=s), f) for s in range(2)])
                  for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))
    jcfg = JConfig(model=JMR(), n_nodes=N, washout=W0, state_noise_rel=0.0,
                   stream_chunk_k=CHUNK, ridge_l2=(1e-4,), topology=_jgraph2())
    cfg = dataclasses.replace(config_from_reference(jcfg), state_method="kernel",
                              readout_use_kernel=True)
    assert cfg.topology == graph_from_reference(jcfg.topology)
    got = Experiment(cfg, device="cpu").run(*batch)
    want = JExperiment(jcfg).run(*batch)
    assert got.readout_w.shape == (2, 2 * N + 7 + 1)
    np.testing.assert_allclose(got.nrmse, want.nrmse, atol=NRMSE_TOL, rtol=0)
    np.testing.assert_array_equal(got.lam, want.lam)


def test_wdm_per_channel_topology_matches_reference():
    """WDMExperiment with a composed topology: per-channel stage masks (the
    reference's), per-channel readouts of width graph.width + 1, NRMSE
    within NRMSE_TOL of the reference's."""
    ds = tasks.narma10(420, seed=4)
    jg, g = _graphs()
    base = dict(n_nodes=N, washout=W0, state_noise_rel=0.0, stream_chunk_k=CHUNK,
                state_method="fast", ridge_l2=LAMS)
    r = 2
    args = [np.stack([getattr(ds, f)] * r)
            for f in ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    exp = WDMExperiment(ExperimentConfig(**base, topology=g), r, device="cpu")
    jexp = JWDMExperiment(JConfig(model=JMR(), **base, topology=jg), r)
    for m, jm in zip(exp.masks, jexp.masks):
        np.testing.assert_array_equal(_np(m), np.asarray(jm))
    res, want = exp.run(*args), jexp.run(*args)
    assert res.nrmse.shape == (r,) and np.isfinite(res.nrmse).all()
    assert res.readout_w.shape == (r, g.width + 1)
    np.testing.assert_allclose(res.nrmse, want.nrmse, atol=NRMSE_TOL, rtol=0)


def test_wdm_topology_validation():
    g = chain(ReservoirStage(model=MODEL, n_nodes=N))
    cfg = ExperimentConfig(n_nodes=N, state_noise_rel=0.0, stream_chunk_k=CHUNK, topology=g)
    with pytest.raises(ValueError, match="shared_readout"):
        WDMExperiment(cfg, 2, shared_readout=True, device="cpu")
    with pytest.raises(ValueError, match="masks="):
        WDMExperiment(cfg, 2, masks=torch.zeros((2, N)), device="cpu")


def test_convert_carries_the_topology():
    jg = _jgraph2()
    jcfg = JConfig(model=JMR(), n_nodes=N, state_noise_rel=0.0, stream_chunk_k=CHUNK,
                   topology=jg)
    cfg = config_from_reference(jcfg)
    assert isinstance(cfg.topology, ReservoirGraph)
    for st, jst in zip(cfg.topology.stages, jg.stages):
        assert isinstance(st.model, SiliconMR)
        for f in dataclasses.fields(jst):
            want = getattr(jst, f.name)
            got = getattr(st, f.name)
            assert (dataclasses.asdict(got) == dataclasses.asdict(want) if f.name == "model"
                    else got == want)
    assert graph_from_reference(jg.stages[1]) == chain(cfg.topology.stages[1])
    with pytest.raises(TypeError, match="ReservoirStage"):
        graph_from_reference(object())


# ---------------------------------------------------------------------------
# The memory contract: no stage holds a full-K block
# ---------------------------------------------------------------------------


def test_composed_fit_holds_no_full_stream_stage_tensor():
    """Depth 3 with a multi-loop stage, K = 170 (a ragged tail): the streamed
    composed fit creates no tensor with the stream axis beside any stage's
    width (or the graph's), while the materialized oracle does."""
    g = chain(ReservoirStage(model=MODEL, n_nodes=N, loops=2, mask_seed=1),
              ReservoirStage(model=MODEL, n_nodes=N, mask_seed=7),
              ReservoirStage(model=MODEL, n_nodes=8, mask_seed=13))
    k = 170
    j, y = _stream(7, k=k)
    masks = build_stage_masks(g)
    lengths = (k, k - W0, -(-k // CHUNK) * CHUNK)
    widths = (N, 2 * N, 8, g.width, g.width + 1)

    def full(shapes):
        return [s for s in shapes if set(s) & set(lengths) and set(s) & set(widths)]

    with Trace() as rec:
        fit_ridge_streaming_composed(g, masks, j, y, washout=W0, chunk_k=CHUNK,
                                     lambdas=LAMS, state_method="kernel", device="cpu")
    assert not full(rec.shapes), full(rec.shapes)
    assert (B, CHUNK, g.width + 1) in rec.shapes
    with Trace() as rec_m:
        graph_states(g, j, masks, method="kernel", device="cpu")
    assert full(rec_m.shapes)
