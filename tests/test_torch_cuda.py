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
reservoir mixer on K1 bitwise its plain route; MackeyGlass's helper-warp
route of K1 bitwise the chain kernel's MackeyGlass route (f32 and bf16
states, the carry, resume) at the Fig. 5/6 splits and on per-lane masks; an LM's decode within the
reference's 2e-4 / 2e-3 of its forward.  The adjoint scan K1ᵀ bitwise its
plain version; a reservoir_lm's gradients through K1 and K1ᵀ bitwise the
plain route's; K1ᵀ allocates only dj and ds0; K1's f32 states cast to
bf16 bitwise its bf16 states, so serving without grad and a forward with
grad give the same logits.  The MoE, Mamba, mLSTM, sLSTM and
cross-attention blocks and the archs built of them (smoke widths, f32)
within 1e-5 of the same code on the CPU (cuBLAS sums in another order).
Sharded serving of reservoir_lm on two gloo ranks of the card, on (1, 2)
and (2, 1): each rank's logits within twice one process's own row-split
spread (floored at 1e-5, the CPU tests' logit tolerance) of the unsharded
serve's, K1 launched once a layer a step on each rank.  GPipe on two gloo
ranks of the card: a device tensor sent by ``sharding.send_recv`` arrives
bitwise, on the card, with only host tensors handed to gloo's
point-to-point calls; the reference test's toy pipeline (S = 2, M = 6, D =
16) bitwise the card's fold of the same microbatches on every rank, and
within the reference's 1e-5 of the sequential fold on the host.
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


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("b,k,n,per_lane", [(64, 1000, 900, False), (64, 6000, 400, False),
                                            (64, 256, 100, True)],
                         ids=["fig56_n900", "fig56_n400", "per_lane"])
def test_mackey_glass_helper_route_is_the_chain_route_bitwise(dev, b, k, n, per_lane):
    """MackeyGlass launches K1's helper-warp kernel, once a call; at the Fig.
    5/6 splits and on per-lane masks its states (f32, and bf16 the f32
    states rounded) and carry are the chain kernel's MackeyGlass route's bit
    for bit, and resuming from its carry at cuts 37 and 38 is one call's."""
    model = MackeyGlass()
    rng = np.random.default_rng(k + n)
    j = torch.as_tensor(rng.uniform(-0.5, 0.5, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.choice((-1.0, 1.0), (b, n) if per_lane else (n,)),
                           dtype=torch.float32, device=dev)
    assert scan_ops.scan_route(model) == "helpers"
    before = scan_ops.dfr_scan.launches
    out, fin = scan_ops.dfr_scan(model, j, mask, s0, return_final=True)
    assert scan_ops.dfr_scan.launches == before + 1
    chain = scan_ops.scan_layout(b, n, per_lane)
    want, want_fin = scan_ops.dfr_scan_at(model, j, mask, s0, chain)
    assert torch.equal(_bits(out), _bits(want)) and torch.equal(_bits(fin), _bits(want_fin))
    del want
    out16, fin16 = scan_ops.dfr_scan(model, j, mask, s0, out_dtype=torch.bfloat16,
                                     return_final=True)
    assert torch.equal(_bits(out16), _bits(out.to(torch.bfloat16)))
    assert torch.equal(_bits(fin16), _bits(fin))
    want16, _ = scan_ops.dfr_scan_at(model, j, mask, s0, chain, out_dtype=torch.bfloat16)
    assert torch.equal(_bits(out16), _bits(want16))
    del out16, want16
    for cut in (37, 38):
        st1, f1 = scan_ops.dfr_scan(model, j[:, :cut], mask, s0, return_final=True)
        st2, f2 = scan_ops.dfr_scan(model, j[:, cut:], mask, f1, return_final=True)
        assert torch.equal(_bits(torch.cat([st1, st2], dim=1)), _bits(out)), cut
        assert torch.equal(_bits(f2), _bits(fin)), cut


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


def _block_inputs(cfg, kind, seed):
    """Params of one ``kind`` block of a smoke config (every leaf non-zero)
    and an input [2, 9, d], on the CPU."""
    from repro_torch.models import layers, mamba, moe, xlstm

    defs = {"moe": moe.moe_defs, "mamba": mamba.mamba_defs, "mlstm": xlstm.mlstm_defs,
            "slstm": xlstm.slstm_defs, "cross_attn": layers.cross_attn_defs}[kind](cfg)
    g = torch.Generator().manual_seed(seed)
    p = {name: torch.randn(shape, generator=g) / (shape[0] ** 0.5 if len(shape) >= 2 else 10.0)
         for name, (shape, _axes, _init) in defs.items()}
    x = torch.randn((2, 9, cfg.d_model), generator=g)
    return p, x


def _on(dev, tree):
    if isinstance(tree, dict):
        return {k: _on(dev, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_on(dev, v) for v in tree)
    return tree.to(dev)


@pytest.mark.parametrize("kind", ["moe", "mamba", "mlstm", "slstm", "cross_attn"])
def test_lm_block_on_the_card_matches_the_cpu(dev, kind):
    """Each block kind ported after the dense ones, smoke widths, f32: the
    card's output (and, for the recurrent mixers, a prefill's state and one
    decode step from it) within 1e-5 of the same module on the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import layers, mamba, moe, xlstm

    arch = {"moe": "qwen3-moe-30b-a3b", "mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b",
            "slstm": "xlstm-1.3b", "cross_attn": "llama-3.2-vision-11b"}[kind]
    cfg = smoke_config(arch)
    p, x = _block_inputs(cfg, kind, 7)

    def run(d):
        pd, xd = _on(d, p), x.to(d)
        if kind == "moe":
            return moe.apply_moe(cfg, pd, xd)
        if kind == "cross_attn":
            ctx = torch.randn((2, cfg.n_context_tokens, cfg.d_model),
                              generator=torch.Generator().manual_seed(8)).to(d)
            return (layers.apply_cross_attn(cfg, pd, xd,
                                            context_kv=layers.context_kv(cfg, pd, ctx)),)
        mod = mamba if kind == "mamba" else xlstm
        init = getattr(mod, f"init_{kind}_cache")
        apply = getattr(mod, f"apply_{kind}")
        y, cache = apply(cfg, pd, xd[:, :8], cache=init(cfg, 2, device=d))
        y1, cache = apply(cfg, pd, xd[:, 8:], cache=cache)
        return (y, y1, *cache)

    for got, want in zip(run(dev), run(torch.device("cpu")), strict=True):
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b", "seamless-m4t-medium"])
def test_lm_archs_on_the_card_match_the_cpu_and_decode_as_they_forward(dev, arch):
    """The archs ported after the dense ones (smoke widths, f32, the
    encoder too): the card's forward within 1e-5 of the CPU's on the same
    params, and its decode within the reference's 2e-4 / 2e-3 of its
    forward."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for blk, unit in zip(cfg.unit, params["units"], strict=True):
        if blk.mixer == "cross_attn":
            unit["mixer/gate"].fill_(0.5)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 10), generator=g)
    ctx = (torch.randn((2, cfg.n_context_tokens, cfg.d_model), generator=g)
           if cfg.n_context_tokens else None)
    want, _ = forward(cfg, params, toks, context=ctx)
    pd, td, cd = _on(dev, params), toks.to(dev), None if ctx is None else ctx.to(dev)
    full, _ = forward(cfg, pd, td, context=cd)
    torch.testing.assert_close(full.cpu(), want, atol=1e-5, rtol=1e-5)
    _, cache = prefill(cfg, pd, td[:, :9], max_len=10, context=cd)
    step, _ = decode_step(cfg, pd, cache, td[:, 9:])
    torch.testing.assert_close(step[:, 0], full[:, -1], atol=2e-4, rtol=2e-3)


def _adjoint_inputs(dev, b, k, n, beta, seed):
    """K1's own f32 states (its plain version's above K1's node limit, which
    is below K1ᵀ's) and normal gradients of the states and the final state,
    for K1ᵀ at [B, K, N]."""
    rng = np.random.default_rng(seed)
    model = SiliconMR(beta_tpa=beta)
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    mask = make_mask(n, seed=1, device=dev)
    if n <= scan_ops.max_nodes(False):
        states = scan_ops.dfr_scan(model, j, mask, s0)
    else:
        states = scan_ops.dfr_scan_plain(model, j, mask, s0)[0]
    g = torch.as_tensor(rng.standard_normal((b, k, n)), dtype=torch.float32, device=dev)
    g_fin = torch.as_tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)
    return model, j, mask, s0, states, g, g_fin


def _adjoint_bitwise(args):
    before = scan_ops.dfr_scan_grad.launches
    dj, ds0 = scan_ops.dfr_scan_grad(*args)
    assert scan_ops.dfr_scan_grad.launches == before + 1
    pj, ps = scan_ops.dfr_scan_grad_plain(*args)
    assert torch.equal(dj.view(torch.int32), pj.view(torch.int32))
    assert torch.equal(ds0.view(torch.int32), ps.view(torch.int32))


@pytest.mark.parametrize("beta", [0.0, 0.5])
@pytest.mark.parametrize("b,k,n", [(1, 1, 1), (33, 2, 31), (64, 37, 33), (24, 16, 256),
                                   (9, 3, 900), (24, 512, 256), (133, 3, 33), (265, 2, 31)])
def test_adjoint_scan_kernel_is_bitwise_its_plain_version(dev, b, k, n, beta):
    """K1ᵀ against its plain version from K1's own f32 states, with a
    non-zero gradient of the final state: dj and ds0 bitwise (the same
    separately rounded ops in the same order), one launch a call; at the
    LM's [24, 512, 256] (its 128-node handoffs), at ragged rows (N = 1, 31,
    33: 4-byte copies) and at batches that leave a block partly filled (133
    lanes at two a block, 265 at four)."""
    _adjoint_bitwise(_adjoint_inputs(dev, b, k, n, beta, b * k + n))


def test_adjoint_scan_kernel_at_its_node_limit_and_off_16_bytes(dev):
    """K1ᵀ bitwise its plain version at the largest N its block holds, and
    on inputs whose rows start off 16 bytes though N is a multiple of 4
    (views one float into their storage: the kernel stages them by 4-byte
    copies instead of bulk copies)."""
    n = scan_ops.max_grad_nodes()
    _adjoint_bitwise(_adjoint_inputs(dev, 2, 2, n, 0.0, 11))
    model, j, mask, s0, states, g, g_fin = _adjoint_inputs(dev, 5, 7, 64, 0.5, 12)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    _adjoint_bitwise((model, j, mask, shifted(s0), shifted(states), shifted(g), g_fin))


def test_adjoint_scan_allocates_only_its_outputs(dev):
    """A call on f32 contiguous inputs allocates dj [B, K] and ds0 [B, N]
    and nothing else: no [K, N, B] copy of the states or their gradient
    (1.6 MB each here) and no transposed outputs.  The bound adds 4 KB for
    the caching allocator's rounding of the two blocks (512 bytes each)."""
    b, k, n = 24, 64, 256
    args = _adjoint_inputs(dev, b, k, n, 0.0, 13)
    scan_ops.dfr_scan_grad(*args)               # built and bound
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dj, ds0 = scan_ops.dfr_scan_grad(*args)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= 4 * (b * k + b * n) + 4096, extra
    assert args[4].numel() * 4 > 50 * (extra + 1)


def test_adjoint_scan_raises_for_what_it_does_not_cover(dev):
    z2, z3 = torch.zeros((2, 3), device=dev), torch.zeros((2, 2, 3), device=dev)
    with pytest.raises(NotImplementedError, match="SiliconMR only"):
        scan_ops.dfr_scan_grad(MackeyGlass(), z2[:, :2], z2[0], z2, z3, z3, z2)
    with pytest.raises(NotImplementedError, match="per-lane"):
        scan_ops.dfr_scan_grad(SiliconMR(), z2[:, :2], z2, z2, z3, z3, z2)
    n = scan_ops.max_grad_nodes() + 1
    z = torch.zeros((1, n), device=dev)
    with pytest.raises(ValueError, match="exceeds its limit"):
        scan_ops.dfr_scan_grad(SiliconMR(), z[:, :1], z[0], z, z[:, None], z[:, None], z)


def _lm_grad_setup(dev, layers=2):
    from repro_torch.configs import get_config
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.model import _block_defs

    cfg = dataclasses.replace(get_config("reservoir_lm"), n_layers=layers, d_model=96,
                              n_heads=4, n_kv_heads=4, head_dim=24, d_ff=192, vocab_size=300,
                              reservoir_nodes=32, microbatches=1)
    rng = np.random.default_rng(0)

    def draw(defs, lead=()):
        return {k: torch.as_tensor(rng.standard_normal((*lead, *shape), dtype=np.float32)
                                   * np.float32(1 / np.sqrt(shape[0]) if len(shape) > 1
                                                else 0.1), device=dev)
                for k, (shape, _, _) in sorted(defs.items())}

    params = {"embed": draw(lm_layers.embed_defs(cfg)),
              "units": tuple(draw(_block_defs(cfg, blk), (cfg.n_units,)) for blk in cfg.unit),
              "final_norm": draw(lm_layers.norm_defs(cfg))}
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 25)), device=dev)
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_lm_gradients_through_k1_and_its_adjoint_equal_the_plain_route(dev):
    """Every leaf's gradient of a 2-layer reservoir_lm (bf16, remat full,
    a non-zero readout) through K1 and K1ᵀ equals the one through both
    scans' plain versions on the card, bitwise; K1 runs twice a layer (the
    remat) and K1ᵀ once."""
    from repro_torch.core import layer as mixer
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import loss_fn

    cfg, params, batch = _lm_grad_setup(dev)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]

    def grads():
        loss, _ = loss_fn(cfg, params, batch)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    k1, k1t = scan_ops.dfr_scan.launches, scan_ops.dfr_scan_grad.launches
    got = grads()
    assert scan_ops.dfr_scan.launches - k1 == 2 * cfg.n_layers
    assert scan_ops.dfr_scan_grad.launches - k1t == cfg.n_layers

    def scan_plain(model, j, mask, s0, *, return_final=False, out_dtype=None, **_):
        states, fin = scan_ops.dfr_scan_plain(model, j, mask, s0, out_dtype=out_dtype)
        return (states, fin) if return_final else states

    real = mixer.dfr_scan, mixer.dfr_scan_grad
    mixer.dfr_scan, mixer.dfr_scan_grad = scan_plain, scan_ops.dfr_scan_grad_plain
    try:
        want = grads()
    finally:
        mixer.dfr_scan, mixer.dfr_scan_grad = real
    for a, b in zip(got, want, strict=True):
        assert (a is None and b is None) or torch.equal(a, b)
    assert sum(a is None for a in got) == len(cfg.unit)    # the detached w_in


def test_no_grad_serving_is_unchanged_by_the_training_route(dev):
    """Without grad the mixer launches K1 once a layer emitting bf16 as
    before; with grad on, K1 emits f32 states inside the autograd Function
    and their bf16 cast is bitwise K1's own bf16 states, so the logits are
    the same bits either way."""
    from repro_torch.models import forward

    cfg, params, batch = _lm_grad_setup(dev)
    before = scan_ops.dfr_scan.launches
    with torch.no_grad():
        served, _ = forward(cfg, params, batch["tokens"])
    assert scan_ops.dfr_scan.launches - before == cfg.n_layers
    for p in (p for unit in params["units"] for p in unit.values()):
        p.requires_grad_(True)
    trained, _ = forward(cfg, params, batch["tokens"])
    assert trained.requires_grad and torch.equal(trained.detach(), served)


def test_k1_f32_states_cast_to_bf16_are_its_bf16_states(dev):
    j, s0 = _scan_inputs(dev, b=24, k=40, n=256)
    mask = make_mask(256, seed=1, device=dev)
    f32 = scan_ops.dfr_scan(SiliconMR(), j, mask, s0, out_dtype=torch.float32)
    bf16 = scan_ops.dfr_scan(SiliconMR(), j, mask, s0, out_dtype=torch.bfloat16)
    assert torch.equal(f32.to(torch.bfloat16), bf16)


# ---------------------------------------------------------------------------
# K1 and K1ᵀ as operators; the sharded train step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_scan_operators_are_bitwise_their_plain_versions(dev, out_dtype):
    """``torch.ops.repro_torch.dfr_scan`` / ``dfr_scan_grad`` (the kernels
    bound as operators, with fake shapes for the dry run) on the card give
    the plain versions' bits, and their fakes the real outputs' shapes and
    dtypes."""
    model = SiliconMR(beta_tpa=0.5)
    j, s0 = _scan_inputs(dev, b=33, k=37, n=33)
    mask = make_mask(s0.shape[1], seed=1, device=dev)
    model_id, params, out_bf16 = scan_ops._op_args(model, out_dtype)
    states, fin = torch.ops.repro_torch.dfr_scan(j, mask, s0, model_id, params, out_bf16)
    want_states, want_fin = scan_ops.dfr_scan_plain(model, j, mask, s0, out_dtype=out_dtype)
    assert torch.equal(states, want_states) and torch.equal(fin, want_fin)
    st32, _ = torch.ops.repro_torch.dfr_scan(j, mask, s0, model_id, params, False)
    g_states = torch.randn_like(st32)
    g_fin = torch.randn_like(s0)
    dj, ds0 = torch.ops.repro_torch.dfr_scan_grad(j, mask, s0, st32, g_states, g_fin,
                                                  *scan_ops.grad_constants(model))
    want_dj, want_ds0 = scan_ops.dfr_scan_grad_plain(model, j, mask, s0, st32, g_states, g_fin)
    assert torch.equal(dj, want_dj) and torch.equal(ds0, want_ds0)
    torch.library.opcheck(torch.ops.repro_torch.dfr_scan.default,
                          (j, mask, s0, model_id, params, out_bf16),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(torch.ops.repro_torch.dfr_scan_grad.default,
                          (j, mask, s0, st32, g_states, g_fin,
                           *scan_ops.grad_constants(model)),
                          test_utils=("test_schema", "test_faketensor"))


def _card_sharded_rank(rank):
    """Three steps of reservoir_lm's smoke config on a (1, 2) mesh over two
    gloo ranks on the one card (the MLP and the vocab tensor-parallel over
    them), each rank also running the unsharded step in its own process:
    (the largest metric gap, each leaf's largest moment gaps over its
    largest |moment|, the largest param gap, Σlr, K1/K1ᵀ (launches,
    calls))."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.runtime import steps

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(smoke_config("reservoir_lm"), microbatches=2)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    mesh = make_mesh((1, 2), ("data", "model"), device_type="cuda")
    plain = steps.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    full = steps.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = sharding.tree_shard(full, steps.state_pspecs(cfg, mesh), mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    metric_gap, lr_sum = 0.0, 0.0
    for _ in range(3):
        toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen, device=dev,
                             dtype=torch.int32)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        scan_ops.dfr_scan.launches = scan_ops.dfr_scan.calls = 0
        with sharding.use_mesh(mesh):
            state, m = steps.train_step(cfg, opt, state, batch)
        counts = (scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls)
        plain, pm = steps.train_step(cfg, opt, plain, batch)
        metric_gap = max(metric_gap, *(abs(float(m[k]) - float(pm[k])) for k in m))
        lr_sum += float(pm["lr"])
    got = sharding.tree_gather(state, steps.state_pspecs(cfg, mesh), mesh)
    moments = [max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(tree_leaves(got["opt"][k]), tree_leaves(plain["opt"][k])))
               for k in ("m", "v")]
    params = max(float((a - b).abs().max())
                 for a, b in zip(tree_leaves(got["params"]), tree_leaves(plain["params"])))
    return metric_gap, moments, params, lr_sum, counts


def test_sharded_step_on_1x2_is_bitwise_the_unsharded_step_on_the_card(dev, tmp_path):
    """(The name is from before the step ran tensor-parallel: it adds its
    partial sums in another order, so it is held at the CPU tests'
    tolerances, tests/test_torch_parallel_train.py.)"""
    from repro_torch.launch.mesh import run_ranks

    for metric_gap, (m_gap, v_gap), params, lr_sum, (launches, calls) in run_ranks(
            _card_sharded_rank, 2, store_dir=str(tmp_path), timeout=300, threads=None):
        assert metric_gap <= 2e-5
        assert m_gap <= 1e-5 and v_gap <= 2e-5
        assert params <= 2 * lr_sum
        assert launches == calls > 0


def _card_serving_rank(rank, shape):
    """reservoir_lm's smoke config (f32) served on a ("data", "model") mesh
    of ``shape`` over two gloo ranks on the one card, a prefill of 16
    tokens then 4 decode steps, each rank also serving unsharded in its own
    process: (the largest gap of the rank's logits to the unsharded serve's
    rows, one process's row-split spread, K1's (launches, calls) of each
    sharded step)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward, init_params
    from repro_torch.parallel import sharding
    from repro_torch.runtime import steps

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = smoke_config("reservoir_lm")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    mesh = make_mesh(shape, ("data", "model"), device_type="cuda")
    local = sharding.tree_shard(params, sharding.param_pspecs(cfg, mesh), mesh)
    rows = sharding.serve_rows(toks, mesh)
    plain, got, counts = [], [], []
    with torch.no_grad():
        logit, cache = steps.serve_prefill(cfg, params, toks[:, :16], max_len=20)
        plain.append(logit)
        for i in range(16, 20):
            logit, cache = steps.serve_decode(cfg, params, cache, toks[:, i:i + 1])
            plain.append(logit)
        full, _ = forward(cfg, params, toks)
        one, _ = forward(cfg, params, toks[:1])
        spread = float((full[:1] - one).abs().max())
        with sharding.use_mesh(mesh):
            for i in range(15, 20):
                scan_ops.dfr_scan.launches = scan_ops.dfr_scan.calls = 0
                if i == 15:
                    logit, cache = steps.serve_prefill(cfg, local, rows[:, :16], max_len=20,
                                                       batch=4)
                else:
                    logit, cache = steps.serve_decode(cfg, local, cache, rows[:, i:i + 1])
                counts.append((scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls))
                got.append(logit)
    spec = sharding.P(sharding.serve_batch_entry(mesh, 4))
    gap = max(float((g - sharding.shard(w, spec, mesh)).abs().max())
              for g, w in zip(got, plain, strict=True))
    return gap, spread, counts


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_serving_on_two_ranks_of_the_card_is_one_process_within_its_spread(
        dev, tmp_path, shape):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import run_ranks

    layers = smoke_config("reservoir_lm").n_layers
    for gap, spread, counts in run_ranks(_card_serving_rank, 2, store_dir=str(tmp_path),
                                         args=(shape,), timeout=300, threads=None):
        assert gap <= max(2 * spread, 1e-5), (gap, spread)
        assert all(tuple(c) == (layers, layers) for c in counts), counts


def _toy_stage(p, x):
    return torch.tanh(x @ p["w"])


def _card_pipeline_rank(rank, w, x, sent):
    """Two gloo ranks on the one card, ``dist.isend``/``irecv`` refusing
    CUDA tensors throughout: ``sharding.send_recv`` of ``sent`` from rank 0
    to rank 1 on the card, then the toy pipeline (``_toy_stage`` a stage,
    this rank's ``w``) on ``make_stage_mesh``'s default mesh.  Returns the
    tensor received, the pipeline's outputs, the fold of each microbatch
    through both stages on the card, whether each lay on the card, and the
    device types gloo's point-to-point calls were handed."""
    import torch.distributed as dist

    from repro_torch.parallel import pipeline, sharding

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    handed = []
    isend, irecv = dist.isend, dist.irecv

    def refusing(fn):
        def call(tensor, *args, **kw):
            handed.append(tensor.device.type)
            if tensor.is_cuda:
                raise AssertionError("a CUDA tensor reached gloo's point-to-point")
            return fn(tensor, *args, **kw)
        return call

    dist.isend, dist.irecv = refusing(isend), refusing(irecv)
    try:
        mesh = pipeline.make_stage_mesh(2)
        got = torch.full(sent.shape, float("nan"), device=dev)
        sharding.send_recv(torch.as_tensor(sent, device=dev) if rank == 0 else None,
                           got if rank == 1 else None, "stage", mesh, to=1, frm=0)
        ws, xs = torch.as_tensor(w, device=dev), torch.as_tensor(x, device=dev)
        out = pipeline.pipeline_apply(_toy_stage, {"w": ws[rank]}, xs, mesh=mesh)
    finally:
        dist.isend, dist.irecv = isend, irecv
    fold = torch.stack([_toy_stage({"w": ws[1]}, _toy_stage({"w": ws[0]}, xs[m]))
                        for m in range(xs.shape[0])])
    return {"got": got, "out": out, "fold": fold, "handed": handed,
            "on_card": [t.is_cuda for t in (got, out)]}


def test_gpipe_on_two_gloo_ranks_of_the_card_stages_its_sends_through_the_host(dev, tmp_path):
    from repro_torch.launch.mesh import run_ranks

    s, m, d = 2, 6, 16
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((m, 3, d), dtype=np.float32)
    sent = rng.standard_normal((5, 7), dtype=np.float32)
    host = x.astype(np.float64)
    for i in range(s):
        host = np.tanh(host @ w[i])
    r0, r1 = run_ranks(_card_pipeline_rank, 2, store_dir=str(tmp_path), args=(w, x, sent),
                       timeout=300, threads=None)
    np.testing.assert_array_equal(r1["got"].view(np.int32), sent.view(np.int32))
    for r in (r0, r1):
        assert all(r["on_card"])
        assert r["handed"] and set(r["handed"]) == {"cpu"}, r["handed"]
        np.testing.assert_array_equal(r["out"].view(np.int32), r["fold"].view(np.int32))
        np.testing.assert_allclose(r["out"], host, atol=1e-5, rtol=0)
