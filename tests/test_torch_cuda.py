"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA GPU (and nvcc, which builds the kernels at first
use); without one they skip.  Run them on the GPU with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: SiliconMR 1e-6, and exact on the scan kernel's edge grid (the
kernel evaluates the plain version's separately rounded f32 ops);
SiliconMRLiteral 1e-5 of its largest state; MackeyGlass and MZISine 1e-5
(powf/sinf vs torch's pow/sin); bf16 states 4e-2, and on the edge grid the
f32 states rounded, bitwise; Gram rtol 1e-5 / atol 1e-4 (f32 sums in
another order, also from a non-symmetric G0); chunk resume, accumulate-into
over any split and the symmetry of G bitwise.  The streamed
Gram equals the materialized one bitwise (K1 resumes bitwise, each Gram
element is one ascending-t fmaf chain, masked rows are exact zeros); a
bf16 streamed run's Gram equals the CPU run's to the Gram tolerance (the
same rounded chunks, f32 sums in another order) and its NRMSE is within
0.06 of f32 chunks.  Sessions: one K1 and one K3 launch a tick, no
synchronising call in a fold-only tick, session == streaming fit bitwise
(λ = 1.0 and 0.99), K1 with non-finite carry and drive rows bitwise its
plain version as int patterns, and a server's restore bitwise.  The
readout-apply kernel within 1e-6 of its plain version relative to the
sum's magnitude (f32 products and sums, in another order), the same bits
from call to call, at N on either side of its chunk and lane edges and
rows off 16 bytes; the block copy bitwise on both its routes (TMA and
SIMT), each case asserting the route it took; the LM's
reservoir mixer on K1 bitwise its plain route; an LM's decode within the
reference's 2e-4 / 2e-3 of its forward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import MackeyGlass, MZISine, SiliconMR, SiliconMRLiteral, make_mask
from repro_torch.kernels.dfr_scan import ops as scan_ops
from repro_torch.kernels.ridge_gram import ops as gram_ops
from repro_torch.pipeline import Experiment, ExperimentConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _scan_inputs(dev, b=37, k=21, n=45):
    rng = np.random.default_rng(b + k + n)
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    return j, s0


@pytest.mark.parametrize("model,levels,tol", [(SiliconMR(), (0.0, 1.0), 1e-6),
                                              (SiliconMR(beta_tpa=0.5), (0.0, 1.0), 1e-6),
                                              (MackeyGlass(), (-1.0, 1.0), 1e-5),
                                              (MZISine(), (0.0, 1.0), 1e-5)])
def test_scan_kernel_matches_plain(dev, model, levels, tol):
    j, s0 = _scan_inputs(dev)
    mask = make_mask(s0.shape[1], levels=levels, device=dev)
    before = scan_ops.dfr_scan.launches
    out, fin = scan_ops.dfr_scan(model, j, mask, s0, return_final=True)
    assert scan_ops.dfr_scan.launches == before + 1
    ref, ref_fin = scan_ops.dfr_scan_plain(model, j, mask, s0)
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(fin, ref_fin, rtol=0, atol=tol)
    a, f1 = scan_ops.dfr_scan(model, j[:, :8], mask, s0, return_final=True)
    b, f2 = scan_ops.dfr_scan(model, j[:, 8:], mask, f1, return_final=True)
    assert torch.equal(torch.cat([a, b], dim=1), out) and torch.equal(f2, fin)


SCAN_FORMS = [("mr", SiliconMR(), (0.0, 1.0), 0.0, False),
              ("mr_tpa", SiliconMR(beta_tpa=0.5), (0.0, 1.0), 0.0, False),
              ("literal", SiliconMRLiteral(), (0.0, 1.0), 1e-5, True),
              ("mg", MackeyGlass(), (-1.0, 1.0), 1e-5, False),
              ("mzi", MZISine(), (0.0, 1.0), 1e-5, False)]


@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per_lane"])
@pytest.mark.parametrize("form", SCAN_FORMS, ids=[f[0] for f in SCAN_FORMS])
def test_scan_kernel_edge_grid(dev, form, per_lane):
    """The kernel's block layout at its edges: N at the float4 group's and
    the warp's edges, the path widths and the largest N the layout takes; B
    at the 8-lane block's edges; K = 1, 2, 37 in turn (1, 2 above N = 100,
    where the plain version's node loop is longest).  States and carry vs
    the plain version (SiliconMR exact; Literal relative to its largest
    state); bf16 states are the f32 states rounded, bitwise, with the same
    carry; resuming at an uneven split is bitwise."""
    _, model, levels, tol, relative = form
    rng = np.random.default_rng(7)
    for a, n in enumerate((1, 31, 32, 33, 100, 900, scan_ops.max_nodes(per_lane))):
        ks = (1, 2, 37) if n <= 100 else (1, 2)
        for c, b in enumerate((1, 33, 64, 65)):
            k = ks[(a + c) % len(ks)]
            j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
            s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
            mask = torch.as_tensor(rng.choice(levels, (b, n) if per_lane else (n,)),
                                   dtype=torch.float32, device=dev)
            what = f"B={b} K={k} N={n}"
            out, fin = scan_ops.dfr_scan(model, j, mask, s0, return_final=True)
            ref, ref_fin = scan_ops.dfr_scan_plain(model, j, mask, s0)
            scale = max(1.0, float(ref.abs().max())) if relative else 1.0
            err = max(float((out - ref).abs().max()), float((fin - ref_fin).abs().max()))
            assert err <= tol * scale, (what, err)
            out16, fin16 = scan_ops.dfr_scan(model, j, mask, s0, out_dtype=torch.bfloat16,
                                             return_final=True)
            assert torch.equal(out16, out.to(torch.bfloat16)) and torch.equal(fin16, fin), what
            if k > 1:
                cut = k // 3 + 1
                st1, f1 = scan_ops.dfr_scan(model, j[:, :cut], mask, s0, return_final=True)
                st2, f2 = scan_ops.dfr_scan(model, j[:, cut:], mask, f1, return_final=True)
                assert torch.equal(torch.cat([st1, st2], dim=1), out), what
                assert torch.equal(f2, fin), what


@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per_lane"])
def test_scan_kernel_mzi_sine_has_no_node_limit(dev, per_lane):
    """MZISine's kernel keeps no rows in shared memory: above the chain
    kernel's node limit it runs and matches the plain version (1e-5), where
    SiliconMR raises."""
    n = scan_ops.max_nodes(per_lane) + 1
    rng = np.random.default_rng(11)
    j = torch.as_tensor(rng.uniform(0, 1, (33, 2)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (33, n)), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.choice((0.0, 1.0), (33, n) if per_lane else (n,)),
                           dtype=torch.float32, device=dev)
    out, fin = scan_ops.dfr_scan(MZISine(), j, mask, s0, return_final=True)
    ref, ref_fin = scan_ops.dfr_scan_plain(MZISine(), j, mask, s0)
    assert max(float((out - ref).abs().max()), float((fin - ref_fin).abs().max())) <= 1e-5
    with pytest.raises(ValueError, match="limit"):
        scan_ops.dfr_scan(SiliconMR(), j, mask, s0)


def test_scan_kernel_bf16_states_and_per_lane_masks(dev):
    j, s0 = _scan_inputs(dev)
    n = s0.shape[1]
    mask = make_mask(n, device=dev)
    out16 = scan_ops.dfr_scan(SiliconMR(), j, mask, s0, out_dtype=torch.bfloat16)
    ref = scan_ops.dfr_scan_plain(SiliconMR(), j, mask, s0)[0]
    assert out16.dtype == torch.bfloat16
    torch.testing.assert_close(out16.float(), ref, rtol=0, atol=4e-2)
    masks = torch.stack([make_mask(n, seed=s, device=dev) for s in range(1, j.shape[0] + 1)])
    lane = scan_ops.dfr_scan(SiliconMR(), j, masks, s0)
    torch.testing.assert_close(lane, scan_ops.dfr_scan_plain(SiliconMR(), j, masks, s0)[0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per_lane"])
@pytest.mark.parametrize("m", [1, 4])
def test_scan_kernel_cmt_form_matches_plain(dev, per_lane, m):
    """K1's CMT form (any substep count) against its plain version within
    1e-5 (expf/expm1f against torch's exp/expm1), one launch a call, bf16
    states the f32 states rounded and chunk resume bitwise."""
    from repro_torch.devices import calibrated_twin

    model = calibrated_twin(SiliconMR(), power_mw=1.0, n_substeps=m)
    j, s0 = _scan_inputs(dev, b=37, k=6, n=45)
    mask = (torch.stack([make_mask(45, seed=s, device=dev) for s in range(37)]) if per_lane
            else make_mask(45, device=dev))
    before = scan_ops.dfr_scan.launches
    out, fin = scan_ops.dfr_scan(model, j, mask, s0, return_final=True)
    assert scan_ops.dfr_scan.launches == before + 1
    ref, ref_fin = scan_ops.dfr_scan_plain(model, j, mask, s0)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(fin, ref_fin, rtol=0, atol=1e-5)
    out16 = scan_ops.dfr_scan(model, j, mask, s0, out_dtype=torch.bfloat16)
    assert torch.equal(out16, out.to(torch.bfloat16))
    a, f1 = scan_ops.dfr_scan(model, j[:, :2], mask, s0, return_final=True)
    b, f2 = scan_ops.dfr_scan(model, j[:, 2:], mask, f1, return_final=True)
    assert torch.equal(torch.cat([a, b], dim=1), out) and torch.equal(f2, fin)


def test_swept_fast_path_on_the_card_matches_the_cpu(dev):
    """dev_params on the card's ``fast`` path: the same eager ops as on the
    CPU, within 1e-5 (libm exp/expm1 of the two devices)."""
    from repro_torch.core import generate_states
    from repro_torch.devices import SweepGrid, calibrated_twin

    model = calibrated_twin(SiliconMR())
    grid = SweepGrid(detune=(-1.0, 0.5), loss_scale=(1.0, 1.5), power=(0.0, 2.0))
    j = np.random.default_rng(2).uniform(0, 1, (grid.size, 7)).astype(np.float32)
    mask = make_mask(16, seed=3)
    got = generate_states(model, j, mask, method="fast", dev_params=grid.lanes(), device=dev)
    want = generate_states(model, j, mask, method="fast", dev_params=grid.lanes(), device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_matches_plain(dev, dtype):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((3, 517, 203)), dtype=dtype, device=dev)
    y = torch.as_tensor(rng.standard_normal((3, 517, 2)), dtype=torch.float32, device=dev)
    before = gram_ops.gram_accumulate_batched.launches
    g, c = gram_ops.gram_accumulate_batched(x, y)
    assert gram_ops.gram_accumulate_batched.launches == before + 1
    gp, cp = gram_ops.gram_plain_batched(x, y)
    torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(c, cp, rtol=1e-5, atol=1e-4)


def _gram_batches(dev, f):
    """Two batch sizes for feature width F: B = 2, and one whose triangle
    grid of 64-wide tile pairs gives every SM 4 blocks, so that both thread
    layouts of the kernel run."""
    pairs = -(-f // 64) * (-(-f // 64) + 1) // 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 2, 4 * sms // pairs + 1


@pytest.mark.parametrize("f,cols,dtype", [(70, 1, torch.float32), (901, 1, torch.float32),
                                          (64, 1, torch.float32), (65, 128, torch.float32),
                                          (1, 1, torch.float32), (63, 128, torch.bfloat16),
                                          (901, 1, torch.bfloat16)])
def test_gram_into_bitwise_equals_one_shot_for_any_split(dev, f, cols, dtype):
    """Folding an uneven split with K3 from zero stacks equals one K2 pass
    bitwise (each element one ascending-t fmaf chain, whatever the tile),
    and K2's G and K3's G from a symmetric running Gram equal their
    transposes bitwise."""
    rng = np.random.default_rng(f + cols)
    for b in _gram_batches(dev, f):
        x = torch.as_tensor(rng.standard_normal((b, 301, f)), dtype=dtype, device=dev)
        y = torch.as_tensor(rng.standard_normal((b, 301, cols)), dtype=torch.float32,
                            device=dev)
        g1, c1 = gram_ops.gram_accumulate_batched(x, y)
        assert torch.equal(g1, g1.mT)
        g, c = torch.zeros_like(g1), torch.zeros_like(c1)
        for lo, hi in ((0, 7), (7, 200), (200, 301)):
            gram_ops.gram_accumulate_batched_into(g, c, x[:, lo:hi], y[:, lo:hi])
            assert torch.equal(g, g.mT)
        assert torch.equal(g, g1) and torch.equal(c, c1)


@pytest.mark.parametrize("f", [1, 65, 901])
def test_gram_into_non_symmetric_g0_adds_onto_it(dev, f):
    """K3 from a G0 that is not symmetric still gives G0 + XᵀX (the
    reference's semantics for any G0): rtol 1e-5 of the plain version."""
    rng = np.random.default_rng(f)
    for b in _gram_batches(dev, f):
        x = torch.as_tensor(rng.standard_normal((b, 133, f)), dtype=torch.float32, device=dev)
        y = torch.as_tensor(rng.standard_normal((b, 133, 2)), dtype=torch.float32, device=dev)
        g0 = torch.rand((b, f, f), device=dev)
        c0 = torch.rand((b, f, 2), device=dev)
        g, c = gram_ops.gram_accumulate_batched_into(g0.clone(), c0.clone(), x, y)
        gp, cp = gram_ops.gram_plain_batched(x, y, g0=g0.clone(), c0=c0.clone())
        torch.testing.assert_close(g, gp, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(c, cp, rtol=1e-5, atol=1e-4)


def test_experiment_kernel_path_matches_ref_path(dev):
    from repro_torch.core import tasks

    ds = [tasks.narma10(360, seed=s) for s in range(4)]
    batch = [np.stack([getattr(d, f) for d in ds])
             for f in ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    runs = {}
    for method, use_kernel in (("kernel", True), ("ref", False)):
        cfg = ExperimentConfig(n_nodes=32, washout=40, ridge_l2=(1e-4,), state_noise_rel=0.0,
                               state_method=method, readout_use_kernel=use_kernel)
        runs[method] = Experiment(cfg, device=dev).run(*batch)
    assert np.max(np.abs(runs["kernel"].nrmse - runs["ref"].nrmse)) <= 1e-3


def _narma(n_seeds, length=720):
    from repro_torch.core import tasks

    ds = [tasks.narma10(length, seed=s) for s in range(n_seeds)]
    return [np.stack([getattr(d, f) for d in ds])
            for f in ("inputs_train", "targets_train", "inputs_test", "targets_test")]


def test_streamed_gram_equals_materialized_k2_bitwise(dev, monkeypatch):
    """One K1 and one K3 launch per chunk; the G and c the streamed fit
    solves equal the materialized K2 Gram bitwise (ragged last chunk)."""
    from repro_torch.core import generate_states
    from repro_torch.pipeline import fit_ridge_batched, fit_ridge_streaming, ridge

    rng = np.random.default_rng(8)
    b, k, n, w0, chunk = 4, 300, 40, 30, 64
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.standard_normal((b, k)), dtype=torch.float32, device=dev)
    mask = make_mask(n, seed=1, device=dev)
    seen = []
    solve = ridge.solve_gcv

    def spy(g, c, *args):
        seen.append((g.clone(), c.clone()))
        return solve(g, c, *args)

    monkeypatch.setattr(ridge, "solve_gcv", spy)
    before = (scan_ops.dfr_scan.launches, gram_ops.gram_accumulate_batched_into.launches)
    w_s, idx_s, s_end = fit_ridge_streaming(SiliconMR(), mask, j, y, washout=w0, chunk_k=chunk,
                                            lambdas=(1e-6, 1e-4), device=dev)
    assert (scan_ops.dfr_scan.launches - before[0],
            gram_ops.gram_accumulate_batched_into.launches - before[1]) == (5, 5)
    st = generate_states(SiliconMR(), j, mask, method="kernel", device=dev)
    w_m, idx_m = fit_ridge_batched(st[:, w0:], y[:, w0:], lambdas=(1e-6, 1e-4),
                                   use_kernel=True, device=dev)
    (g_s, c_s), (g_m, c_m) = seen
    assert torch.equal(g_s, g_m) and torch.equal(c_s, c_m)
    assert torch.equal(s_end, st[:, -1])
    same = idx_s == idx_m
    assert torch.equal(w_s[same], w_m[same])


def test_bf16_streamed_run_matches_cpu_and_f32(dev, monkeypatch):
    """bf16 chunks on the card: the kernel's bf16 states are its f32 states
    rounded (bitwise the plain version's), the streamed Gram equals the CPU
    run's to f32 round-off, and the NRMSE is within 0.06 of f32 chunks."""
    from repro_torch.pipeline import ridge

    j, s0 = _scan_inputs(dev)
    mask = make_mask(s0.shape[1], device=dev)
    out16 = scan_ops.dfr_scan(SiliconMR(), j, mask, s0, out_dtype=torch.bfloat16)
    assert torch.equal(out16, scan_ops.dfr_scan_plain(SiliconMR(), j, mask, s0,
                                                      out_dtype=torch.bfloat16)[0])
    grams = []
    solve = ridge.solve_gcv

    def spy(g, c, *args):
        grams.append((g.cpu(), c.cpu()))
        return solve(g, c, *args)

    monkeypatch.setattr(ridge, "solve_gcv", spy)
    batch = _narma(4)
    kw = dict(n_nodes=32, washout=40, ridge_l2=(1e-6, 1e-4), state_noise_rel=0.0,
              state_method="kernel", readout_use_kernel=True, stream_chunk_k=64)
    runs = {}
    for name, dtype, where in (("card", "bfloat16", dev), ("cpu", "bfloat16", "cpu"),
                               ("f32", "float32", dev)):
        cfg = ExperimentConfig(stream_state_dtype=dtype, **kw)
        runs[name] = Experiment(cfg, device=where).run(*batch)
    (g_card, c_card), (g_cpu, c_cpu) = grams[:2]
    torch.testing.assert_close(g_card, g_cpu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(c_card, c_cpu, rtol=1e-5, atol=1e-4)
    assert np.max(np.abs(runs["card"].nrmse - runs["f32"].nrmse)) <= 0.06
    assert np.all(np.isfinite(runs["card"].nrmse))


def test_per_lane_wdm_equals_per_channel_single_mask_runs(dev, monkeypatch):
    """Channel r of a streamed WDM run (K1 per-lane masks) equals a
    single-mask run with mask_seed + r: the states and the streamed Gram
    bitwise; the NRMSE to 1e-4 (a batched eigh against a single one)."""
    from repro_torch.core import generate_states
    from repro_torch.pipeline import WDMExperiment, channel_states, ridge

    r, n = 4, 32
    batch = _narma(r)
    kw = dict(n_nodes=n, washout=40, ridge_l2=(1e-4,), state_noise_rel=0.0,
              state_method="kernel", readout_use_kernel=True, stream_chunk_k=64)
    grams = []
    solve = ridge.solve_gcv

    def spy(g, c, *args):
        grams.append(g.clone())
        return solve(g, c, *args)

    monkeypatch.setattr(ridge, "solve_gcv", spy)
    wdm = WDMExperiment(ExperimentConfig(**kw), r, device=dev)
    j = torch.rand((r, 200), device=dev)
    lanes = channel_states(SiliconMR(), j, wdm.masks, method="kernel", device=dev)
    res = wdm.run(*batch)
    for ch in range(r):
        one = generate_states(SiliconMR(), j[ch:ch + 1], make_mask(n, seed=1 + ch, device=dev),
                              method="kernel", device=dev)
        assert torch.equal(lanes[ch:ch + 1], one)
        single = Experiment(ExperimentConfig(mask_seed=1 + ch, **kw), device=dev).run(
            *[a[ch:ch + 1] for a in batch])
        assert torch.equal(grams[-1][0], grams[0][ch])
        assert abs(float(single.nrmse[0]) - float(res.nrmse[ch])) <= 1e-4


# ---------------------------------------------------------------------------
# online sessions and the server on the card (K1 and K3 a tick)
# ---------------------------------------------------------------------------


def _serve_cfg(**kw):
    from repro_torch.pipeline.session import SessionConfig

    base = dict(model=SiliconMR(), n_nodes=64, washout=32, chunk_k=32, refresh_every=4,
                ridge_l2=(1e-8, 1e-6, 1e-4), state_method="kernel", use_kernel=True)
    base.update(kw)
    return SessionConfig(**base)


def _serve_streams(dev, b, k, seed=0):
    from repro_torch.robustness import make_streams

    j, y = make_streams(b, k, seed=seed)
    return torch.as_tensor(j, device=dev), torch.as_tensor(y, device=dev)


@pytest.mark.parametrize("refresh", [False, True], ids=["fold", "fold_solve"])
def test_session_tick_launches_one_scan_and_one_gram_into(dev, refresh):
    from repro_torch.pipeline.session import _session_step, session_init

    cfg = _serve_cfg()
    j, y = _serve_streams(dev, 64, 64)
    state = session_init(cfg, 64, device=dev)
    _, state = _session_step(cfg, make_mask(64, seed=0, device=dev), state, j[:, :32],
                             y[:, :32])
    counts = (scan_ops.dfr_scan.launches, gram_ops.gram_accumulate_batched.launches,
              gram_ops.gram_accumulate_batched_into.launches)
    _session_step(cfg, make_mask(64, seed=0, device=dev), state, j[:, 32:], y[:, 32:],
                  refresh=refresh)
    assert (scan_ops.dfr_scan.launches - counts[0],
            gram_ops.gram_accumulate_batched.launches - counts[1],
            gram_ops.gram_accumulate_batched_into.launches - counts[2]) == (1, 0, 1)


def test_fold_only_tick_does_not_synchronize(dev):
    """The fold-only tick reads nothing back from the device: under CUDA's
    sync debug mode "error" any synchronising call inside it raises."""
    from repro_torch.pipeline.session import _session_step, session_init

    cfg = _serve_cfg()
    mask = make_mask(64, seed=0, device=dev)
    j, y = _serve_streams(dev, 64, 64)
    nv = torch.full((64,), 32, dtype=torch.int32, device=dev)
    reset = torch.zeros((64,), dtype=torch.bool, device=dev)
    state = session_init(cfg, 64, device=dev)
    _, state = _session_step(cfg, mask, state, j[:, :32], y[:, :32], n_valid=nv, reset=reset)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state = _session_step(cfg, mask, state, j[:, 32:], y[:, 32:], n_valid=nv,
                                 reset=reset)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.g).all())


@pytest.mark.parametrize("lam", [1.0, 0.99])
def test_session_equals_streaming_fit_bitwise_through_the_kernels(dev, lam):
    from repro_torch.pipeline import fit_ridge_streaming
    from repro_torch.pipeline.session import session_init, session_solve, session_update

    cfg = _serve_cfg(forgetting=lam)
    mask = make_mask(64, seed=0, device=dev)
    j, y = _serve_streams(dev, 65, 256)
    w, idx, s_end = fit_ridge_streaming(cfg.model, mask, j, y, washout=32, chunk_k=32,
                                        lambdas=cfg.ridge_l2, use_kernel=True,
                                        forgetting=lam, device=dev)
    state = session_init(cfg, 65, device=dev)
    for lo in range(0, 256, 32):
        state = session_update(cfg, mask, state, j[:, lo:lo + 32], y[:, lo:lo + 32])
    state = session_solve(cfg, state)
    assert torch.equal(state.w, w) and torch.equal(state.s, s_end)
    assert torch.equal(state.lam_idx, idx.to(torch.int32))


@pytest.mark.parametrize("n", [1, 33, 64])
def test_scan_kernel_non_finite_rows_equal_plain_as_int_bits(dev, n):
    rng = np.random.default_rng(n)
    b, k = 65, 32
    s0 = rng.uniform(0, 0.3, (b, n)).astype(np.float32)
    s0[3] = np.nan
    s0[7] = np.inf
    s0[11, n // 2] = np.nan
    j = rng.uniform(0, 1, (b, k)).astype(np.float32)
    j[5, 10] = np.nan
    j[9] = np.nan
    j[64, k - 1] = np.nan
    jt, st = torch.as_tensor(j, device=dev), torch.as_tensor(s0, device=dev)
    mask = make_mask(n, device=dev)
    out, fin = scan_ops.dfr_scan(SiliconMR(), jt, mask, st, return_final=True)
    ref, ref_fin = scan_ops.dfr_scan_plain(SiliconMR(), jt, mask, st)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(fin.view(torch.int32), ref_fin.view(torch.int32))
    assert (~torch.isfinite(fin).all(dim=1)).nonzero().flatten().tolist() == [3, 5, 7, 9, 11,
                                                                               64]


def test_server_restore_is_bitwise_on_the_card(tmp_path, dev):
    from repro_torch.launch.serve_dfr import DFRServer, channel_eq_requests
    from repro_torch.robustness import no_faults, on_rows

    spec = on_rows(no_faults(16, device=dev), [1], nan_prob=0.05, until_tick=6)
    reqs = channel_eq_requests(40, 256, 32, seed=4)

    def fresh(ckpt, every=4):
        s = DFRServer(_serve_cfg(forgetting=0.99), 16, fault_spec=spec, fault_seed=2,
                      checkpoint_dir=str(ckpt), checkpoint_every=every, device=dev)
        s.warmup()
        return s

    ref = fresh(tmp_path / "ref")
    for r in reqs:
        ref.submit(dataclasses.replace(r, y_hat=[]))
    ref.drain()
    crash = fresh(tmp_path / "ck")
    for r in reqs:
        crash.submit(dataclasses.replace(r, y_hat=[]))
    for _ in range(10):
        crash.step()
    crash.close()
    resumed = fresh(tmp_path / "ck")
    assert resumed.restore() == 8
    assert resumed.state.g.device.type == "cuda"
    resumed.drain()
    assert resumed.counters == ref.counters
    assert [r.rid for r in resumed.completed] == [r.rid for r in ref.completed]
    for a, b in zip(resumed.completed, ref.completed):
        assert np.concatenate(a.y_hat).tobytes() == np.concatenate(b.y_hat).tobytes()


# ---------------------------------------------------------------------------
# the block-copy fixture kernel and the contract gate on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype,tile", [((2048, 1024), torch.float32, (32, 256)),
                                              ((32, 256), torch.bfloat16, (16, 8)),
                                              ((37, 101), torch.float32, (8, 33)),
                                              ((5, 7), torch.int64, (5, 7))])
def test_block_copy_is_bitwise_its_plain_version(dev, shape, dtype, tile):
    from repro_torch.kernels.block_copy import ops as copy_ops

    x = torch.randn(shape, device=dev).to(dtype) if dtype.is_floating_point else \
        torch.randint(-9, 9, shape, device=dev, dtype=dtype)
    before = (copy_ops.block_copy.launches, copy_ops.block_copy.calls)
    out = copy_ops.block_copy(x, tile)
    assert (copy_ops.block_copy.launches - before[0],
            copy_ops.block_copy.calls - before[1]) == (1, 1)
    assert torch.equal(out, copy_ops.block_copy_plain(x, tile)) and torch.equal(out, x)
    assert copy_ops.block_copy.last_route == copy_ops.copy_route(shape, dtype, tile,
                                                                 x.data_ptr())["route"]


def _copy_input(dev, shape, dtype, offset=0):
    """A contiguous [rows, cols] array of ``dtype`` whose data starts
    ``offset`` elements into its buffer (off a 16-byte boundary if > 0)."""
    n = shape[0] * shape[1] + offset
    buf = (torch.randn(n, device=dev).to(dtype) if dtype.is_floating_point
           else torch.randint(-2 ** 30, 2 ** 30, (n,), device=dev, dtype=dtype))
    return buf[offset:].view(shape)


@pytest.mark.parametrize("shape,dtype,tile,offset,route", [
    # the TMA route: the fixture's tile, a tile wider and one taller than a
    # 256-element box, ragged right and bottom edges, bf16
    ((2048, 1024), torch.float32, (32, 256), 0, "tma"),
    ((64, 1040), torch.float32, (8, 512), 0, "tma"),
    ((610, 96), torch.float32, (300, 32), 0, "tma"),
    ((100, 200), torch.float32, (32, 48), 0, "tma"),
    ((256, 520), torch.bfloat16, (16, 64), 0, "tma"),
    ((32, 256), torch.bfloat16, (16, 8), 0, "tma"),
    # the SIMT route: the four earlier cases from a pointer off 16 bytes,
    # (37, 101) and (5, 7) also where they lie, and a tile that fills the
    # last bytes of a block's shared memory
    ((2048, 1024), torch.float32, (32, 256), 1, "simt"),
    ((32, 256), torch.bfloat16, (16, 8), 1, "simt"),
    ((37, 101), torch.float32, (8, 33), 0, "simt"),
    ((37, 101), torch.float32, (8, 33), 1, "simt"),
    ((5, 7), torch.int64, (5, 7), 0, "simt"),
    ((5, 7), torch.int64, (5, 7), 1, "simt"),
    ((454, 520), torch.float32, (227, 256), 0, "simt"),
])
def test_block_copy_routes_are_bitwise(dev, shape, dtype, tile, offset, route):
    """Each route copies every element's bits: equal to the plain version
    and to x, with the route the wrapper chose before the launch."""
    from repro_torch.kernels.block_copy import ops as copy_ops

    x = _copy_input(dev, shape, dtype, offset)
    assert copy_ops.copy_route(shape, dtype, tile, x.data_ptr())["route"] == route
    before = copy_ops.block_copy.launches
    out = copy_ops.block_copy(x, tile)
    torch.cuda.synchronize()
    assert copy_ops.block_copy.launches == before + 1
    assert copy_ops.block_copy.last_route == route
    assert torch.equal(out, copy_ops.block_copy_plain(x, tile)) and torch.equal(out, x)
    assert torch.equal(out.view(torch.uint8), x.view(torch.uint8))


def test_block_copy_raises_above_the_shared_memory_of_a_block(dev):
    from repro_torch.kernels.block_copy import ops as copy_ops

    x = torch.zeros((2048, 1024), device=dev)
    before = copy_ops.block_copy.launches
    with pytest.raises(ValueError, match="shared memory"):
        copy_ops.block_copy(x, (2048, 1024))
    assert copy_ops.block_copy.launches == before


def test_gram_plan_is_the_kernels_shared_memory(dev):
    """ops.gram_plan's bytes are Ring<XT>::kBytes of ridge_gram.cu."""
    from repro_torch.kernels import _build

    fn = _build.load("ridge_gram").ridge_gram_smem_bytes
    for dtype, flag in ((torch.float32, 0), (torch.bfloat16, 1)):
        assert gram_ops.gram_plan(dtype, 901)["smem_bytes"] == fn(flag)


def test_contract_gate_holds_every_entry_on_the_card(dev):
    """Every registered entry point holds its contracts on the card, with
    the card's own checks (launches == calls, the run under sync debug
    mode "error" where no sync site is allowed); the seeded violation is
    caught."""
    from repro_torch.analysis.cli import run

    report = run(device="cuda", seed_violation=True)
    bad = {e["name"]: e for e in report["entry_points"]
           if not e["ok"] and e["name"] != "seeded_violation"}
    assert not bad, bad
    (seeded,) = [e for e in report["entry_points"] if e["name"] == "seeded_violation"]
    assert not seeded["ok"]


@pytest.mark.parametrize("b,t,n,c,dtype,w_batch", [(64, 256, 900, 1, torch.bfloat16, None),
                                                   (4096, 32, 64, 1, torch.float32, None),
                                                   (3, 7, 33, 6, torch.float32, None),
                                                   (5, 1, 1, 9, torch.bfloat16, None),
                                                   (4, 9, 801, 2, torch.bfloat16, 1)])
def test_readout_apply_kernel_matches_plain(dev, b, t, n, c, dtype, w_batch):
    """Within 1e-6 of the plain version (the widened matmul) relative to the
    sum's magnitude: both take each product in f32 and sum in f32, in
    another order.  One launch a call; a w of batch 1 is broadcast."""
    from repro_torch.kernels.readout_apply import ops as apply_ops
    from repro_torch.pipeline import with_bias

    rng = np.random.default_rng(b + t + n + c)
    x = torch.as_tensor(rng.uniform(0, 1, (b, t, n)), dtype=torch.float32, device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal((w_batch or b, n + 1, c)), dtype=torch.float32,
                        device=dev)
    before = (apply_ops.readout_apply.launches, apply_ops.readout_apply.calls)
    out = apply_ops.readout_apply(x, w)
    assert (apply_ops.readout_apply.launches - before[0],
            apply_ops.readout_apply.calls - before[1]) == (1, 1)
    ref = apply_ops.readout_apply_plain(x, w)
    assert out.dtype == torch.float32 and out.shape == (b, t, c)
    scale = with_bias(x).float().abs() @ w.abs()
    assert float(((out - ref).abs() / scale).max()) <= 1e-6


@pytest.mark.parametrize("c", [1, 3, 5])
@pytest.mark.parametrize("t", [1, 3, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 900, 901])
def test_readout_apply_kernel_edge_grid(dev, n, dtype, t, c):
    """N at the edges of a row's 16-byte chunks and of a group's lanes, T
    short and long, C = 1 and over a 4-column sweep (a w of batch 1 at C =
    3): within 1e-6 of the plain version relative to the sum's magnitude,
    and the same bits from call to call."""
    from repro_torch.kernels.readout_apply import ops as apply_ops
    from repro_torch.pipeline import with_bias

    b = 3
    rng = np.random.default_rng(n * 1000 + t * 10 + c)
    x = torch.as_tensor(rng.uniform(-1, 1, (b, t, n)), dtype=torch.float32, device=dev).to(dtype)
    w = torch.as_tensor(rng.standard_normal((1 if c == 3 else b, n + 1, c)),
                        dtype=torch.float32, device=dev)
    out = apply_ops.readout_apply(x, w)
    ref = apply_ops.readout_apply_plain(x, w)
    scale = with_bias(x).float().abs() @ w.abs()
    assert float(((out - ref).abs() / scale).max()) <= 1e-6
    assert torch.equal(out, apply_ops.readout_apply(x, w))


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1), (torch.bfloat16, 3),
                                          (torch.float32, 1)])
def test_readout_apply_kernel_rows_off_16_bytes(dev, dtype, offset):
    """Features whose data starts off a 16-byte boundary: every row has its
    own head and tail; the result is the plain version's, within 1e-6."""
    from repro_torch.kernels.readout_apply import ops as apply_ops
    from repro_torch.pipeline import with_bias

    b, t, n = 4, 33, 901
    buf = torch.rand(b * t * n + offset, device=dev).to(dtype)
    x = buf[offset:].view(b, t, n)
    w = torch.randn((b, n + 1, 2), device=dev)
    out = apply_ops.readout_apply(x, w)
    scale = with_bias(x).float().abs() @ w.abs()
    assert float(((out - apply_ops.readout_apply_plain(x, w)).abs() / scale).max()) <= 1e-6
    assert torch.equal(out, apply_ops.readout_apply(x, w))


def test_readout_apply_plan_is_the_kernels_shared_memory(dev):
    """ops.apply_plan's bytes are what readout_apply.cu stages a block."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.readout_apply import ops as apply_ops

    fn = _build.load("readout_apply").readout_apply_smem_bytes
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((64, 256, 900, 1), (4096, 32, 64, 1), (3, 7, 901, 5), (2, 2, 3000, 2)):
            plan = apply_ops.apply_plan(*shape, dtype)
            assert plan["smem_bytes"] == fn(int(dtype == torch.bfloat16), plan["seg"],
                                            plan["rows_per_block"], plan["col_block"])


def test_readout_apply_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.readout_apply import ops as apply_ops

    x = torch.zeros((2, 3, 4), device=dev)
    w = torch.zeros((2, 5, 1), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        apply_ops.readout_apply(x.half(), w)
    with pytest.raises(ValueError, match="float32 weights"):
        apply_ops.readout_apply(x, w.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reservoir_mixer_on_k1_is_bitwise_its_plain_route(dev, dtype):
    """The LM's mixer through K1 == through the scan's plain version, on the
    card, from zero and resumed from its carry; one K1 launch a call."""
    from repro_torch.configs import get_config
    from repro_torch.core import layer as mixer

    cfg = get_config("reservoir_lm")
    r, n, d = mixer._n_channels(cfg), cfg.reservoir_nodes, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(0)
    p = {"w_in": torch.randn((d, r), generator=g, device=dev) / d ** 0.5,
         "readout": torch.randn((r * n, d), generator=g, device=dev) / (r * n) ** 0.5,
         "readout_bias": torch.randn((d,), generator=g, device=dev) * 0.1}
    x = torch.randn((2, 24, d), generator=g, device=dev).to(dtype)
    before = scan_ops.dfr_scan.launches
    y1, c1 = mixer.apply_reservoir(cfg, p, x[:, :16])
    y2, c2 = mixer.apply_reservoir(cfg, p, x[:, 16:], cache=c1)
    assert scan_ops.dfr_scan.launches == before + 2

    def scan_plain(model, j, mask, s0, *, return_final=False, out_dtype=None, **_):
        states, fin = scan_ops.dfr_scan_plain(model, j, mask, s0, out_dtype=out_dtype)
        return (states, fin) if return_final else states

    real = mixer.dfr_scan
    mixer.dfr_scan = scan_plain
    try:
        p1, pc1 = mixer.apply_reservoir(cfg, p, x[:, :16])
        p2, pc2 = mixer.apply_reservoir(cfg, p, x[:, 16:], cache=pc1)
    finally:
        mixer.dfr_scan = real
    assert torch.equal(y1, p1) and torch.equal(y2, p2)
    assert torch.equal(c2[0], pc2[0]) and torch.equal(c2[1], pc2[1])


def test_lm_decode_matches_forward_on_the_card(dev):
    """reservoir_lm and granite-8b (smoke widths, f32) decode on the card
    as they forward, at the reference's bound."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    for arch in ("reservoir_lm", "granite-8b"):
        cfg = smoke_config(arch)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
        if arch == "reservoir_lm":
            ro = params["units"][0]["mixer/readout"]
            ro.copy_(torch.randn(ro.shape, generator=torch.Generator(device=dev).manual_seed(2),
                                 device=dev) * 0.1)
        toks = torch.randint(0, cfg.vocab_size, (2, 10), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(3))
        full, _ = forward(cfg, params, toks)
        _, cache = prefill(cfg, params, toks[:, :9], max_len=10)
        step, _ = decode_step(cfg, params, cache, toks[:, 9:])
        torch.testing.assert_close(step[:, 0], full[:, -1], atol=2e-4, rtol=2e-3)
