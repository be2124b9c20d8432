#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build — the card's name and power limit (nvidia-smi), TF32
   off, the five CUDA sources built with nvcc (in parallel) from
   ``src/repro_torch/kernels/csrc``;
2. kernels vs their plain PyTorch versions on the card — the scan kernel
   for the five device models (f32 and bf16 states, per-lane masks,
   bitwise chunk resume; the CMT cavity at K = 8), then on the edge grid of
   its block layout (N ∈
   {1, 31, 32, 33, 100, 900, the largest N} × B ∈ {1, 33, 64, 65}, K = 1,
   2, 37 in turn (1, 2 above N = 100), both mask modes, every model (the
   CMT cavity up to N = 100, then N = 900 and the largest N at K = 1):
   SiliconMR exact, bf16 states the f32 states rounded, resume at an uneven
   split bitwise; MackeyGlass on its helper-warp route, also bitwise the
   chain kernel's MackeyGlass route, f32 and bf16 states and carry;
   MZISine above the chain kernel's node limit, which SiliconMR raises at;
   MackeyGlass at its own route's node limit, one above raising);
   the adjoint scan K1ᵀ on its edge grid (N ∈ {1, 31, 32, 33, 256, 900} ×
   B ∈ {1, 33, 64} × K ∈ {1, 2, 37} × beta 0 and 0.5, a non-zero gradient
   of the final state), at the LM's [24, 512, 256] and at its node limit,
   bitwise its plain version; the
   Gram kernel on the edges of its triangle
   grid (F at the 64-wide tile's edges and 901, C = 1 and 128, a ragged
   T, f32 and bf16 X, both thread layouts), G symmetric bitwise, a
   non-symmetric G0 through accumulate-into, and accumulate-into over an
   uneven split == one-shot bitwise.  None of it times a kernel, and all
   of it is host-bound (the plain versions' eager loops): the scan
   kernel's edge grid runs here, the rest of phase 2 and then phase 21 in
   one spawned process beside it, phase 17 in another; their lines print
   when all three have ended, before phase 3;
3. the main path at full width — ``Experiment.run`` on the paper's NARMA10
   Silicon-MR operating point (N = 900, washout 60, the λ grid, sampled
   digitiser noise 0.003) over 64 seeds through the scan kernel (2
   launches) and the Gram kernel (1 launch), then channel equalisation at
   the paper's N = 30; NRMSE/SER held to the bands of tests/test_pipeline.py;
   a stage breakdown of one more run, from the pipeline's own stage marks
   (``repro_torch.pipeline.record_stages``);
4. small end-to-end parity — kernel path vs the ``ref`` path (≤1e-3) and
   the Gram vs the SVD readout (≤5e-3) at N = 32, noise off;
5. the streaming fused path at the same NARMA10 point (chunk 256, the
   noise as its expected Tikhonov diagonal): K1 once per chunk, K3 once per
   fit chunk, launches (8, 0, 4), the readout-apply kernel once per eval
   chunk (4); bf16 chunks within 0.06 NRMSE of f32, and the bf16
   evaluation's peak memory through the readout-apply kernel beside the
   widened matmul it replaced;
   noise off, the streamed Gram bitwise equal to the materialized K2 Gram
   and the NRMSE within 1e-5; a stage breakdown of one streamed run;
6. a long stream (K = 20000 a split): the streamed run's peak device memory
   under a quarter of one split's [B, K, N] f32 state tensor, beside the
   materialized run's peak;
7. WDM ensembles (R = 64 channels, N = 100, K = 10000 a split): K1 in its
   per-lane mode once per chunk, streamed vs materialized within 1e-5
   NRMSE per channel; the shared readout (R = 8, F = 801) against the same
   fit folded with plain matmuls;
8. the ``kernels`` line, after every other phase: each kernel at the
   shapes of the path it rides,
   its launches on that path, error vs the plain version (K1 also on a
   chunk resumed from a carry and on a split from zero, exact, each on its
   first 32 periods), the
   kernel's and the library call's device time warm (``ms``,
   ``library_ms``) and with L2 flushed before each call (``cold_ms``, the
   bound share's denominator), the host's time a call through the wrapper
   (``call_ms``), the plain version's time and the roofline bound (K1 also its chain
   bound at the card's maximum SM clock, from a chain-only loop timed on
   the card in this run, and its lanes a block) (K3 at the fold chunk of
   each of its three paths, timed from a symmetric running Gram), K1 and
   K3 also at the serving tick's shapes ([4096, 32, 64], [4096, 32, 65])
   with their launches a tick, K1's CMT form at [64, 1000, 900] and K1 at
   the host accelerator's [1, 1000, 900] (each checked on its first
   periods, with its chain bound), K1's MackeyGlass form at the Fig. 5/6
   splits [64, 1000, 900] and [64, 6000, 400] and MZISine at
   [64, 1000, 400] (checked on their first periods; MackeyGlass with its
   chain bound, its route and lanes a block, and bitwise the chain
   kernel's MackeyGlass route on the whole split, whose time it prints
   beside its own; MZISine, which has no node chain, with its byte bound), K1
   per-lane and K3 at the composed path's chunk; the time of one bare
   ``torch.linalg.eigh`` of the main path's Gram and of the serving
   refresh tick's Gram stacks (B = 4096 and 512, F = 65), and of the SVD
   readout of the Fig. 5/6 cells at [64, 940, 901] and [64, 5940, 401].

The serving phases run before the kernels line, in the repo's serving
configuration (benchmarks/dfr_serving.py: N = 64, 32-period ticks, washout
32, 256-period channel-equalization streams, a re-solve every 4 ticks) on
K1 and K3:

9. session parity — B = 64 sessions over 8 chunks == ``fit_ridge_streaming``
   (G, c, ‖y‖², w, λ index, carry) bitwise at λ = 1.0 and 0.99, a 4 + 4
   chunk resume through the host bitwise, one K1 and one K3 launch a tick;
10. one tick at B = 65, N ∈ {1, 33, 64}, through the kernels and through
   their plain versions on the card, from a slab with NaN/+Inf carry rows
   and NaN drive samples: K1 bitwise (int patterns), the same rows
   quarantined;
11. ``DFRServer`` at B = 4096 (λ = 0.99, 8192 streams) and B = 512 (λ = 1.0,
   1024 streams): throughput, tick latency by kind, online and steady SER
   (held to a band around the JAX package's), peak memory, the host share
   of a step, the device's busy share of fold-only ticks;
12. kill and restore at B = 512 with faults armed: bitwise the
   uninterrupted run, also after falling back past a corrupt checkpoint;
13. the chaos soak at B = 64: isolation, containment, re-convergence;
14. the host ``DFRCAccelerator`` at the NARMA10 point (N = 900) on K1
   against ``Experiment`` (within 0.05 NRMSE), with the Fig. 7 timing model
   and the Table 1 power totals.

Then the device subsystem (``repro_torch.devices``):

15. ``cmt_main`` — the CMT cavity (calibrated_twin(SiliconMR(),
   power_mw=1.0)) at the NARMA10 point, noise off, B = 64, through K1's CMT
   form ×2 and K2; the first 4 seeds held to the JAX package's through a
   float64 ridge on the card's states (2e-3 NRMSE), the pipeline's f32
   NRMSE within 2e-2; a stage breakdown;
16. ``cmt_calibration`` — the zero-power twin's tick map within 1e-4 of
   SiliconMR's, the two through K1 on the same seeds within 2e-2 mean
   |ΔNRMSE|, the twin streamed (K1 CMT ×8, K3 ×4) with its Gram bitwise
   the materialized K2 Gram;
17. ``device_sweep`` — the 60-lane (detuning × loss × power) map of
   benchmarks/device_sweep.py on the ``fast`` path with per-lane device
   parameters: finite, the JAX package's stable map, the stable cells'
   states held through a float64 ridge (1e-3 NRMSE) and the map's NRMSE
   within 2e-2 there; wall time and peak memory.  It runs in a process of
   its own beside phase 2 (see there; its wall is taken beside it);
18. ``fast_path`` — ``method="fast"`` for SiliconMR, MackeyGlass and
   SiliconMRLiteral against K1 on the same inputs, timed.

Then the paper's comparison and the composed graphs
(``repro_torch.configs.dfrc_tasks``, ``repro_torch.core.graph``):

19. ``paper_figures`` — Fig. 5 (NARMA10, Santa Fe) and Fig. 6 (channel
   equalisation at 12–32 dB) × Silicon MR / MZI / MG, 24 cells of B = 64
   task seeds through ``ExperimentConfig.from_dfrc`` on K1 with the SVD
   readout, the K2 Gram readout beside it; seeds 0..3 held to the JAX
   package (noise off and on, and a float64 ridge on the states); the
   accelerator comparisons of the benchmarks beside the paper's;
20. ``composed`` — the six topologies of benchmarks/composed_reservoirs.py
   at width 48 on the memory-capacity probe, B = 64, K1 a stage a chunk and
   K3 a fit chunk; seeds 0..2 held to the JAX package; the payoff margin;
   depth 1 bitwise the single-loop fit; K1 bitwise ``fast``; an uneven
   resume bitwise one pass; a K = 20000 stream's peak memory; the
   per-channel WDM topology.

Then the program contracts (``repro_torch.analysis``):

21. ``contracts`` — the 20 registered entry points, each run once on the
   card through K1-K3 under its rules (no state tensor, kernel calls per
   chunk, no float64, no silent bf16 upcast, no host sync but the named
   sites, the slab and the Gram folded in place, each call's shared memory
   and row alignment), with each kernel launched once a call, a run under
   ``set_sync_debug_mode("error")`` where an entry allows no sync site,
   and the peak device memory; the seeded violation caught; the
   block-copy fixture under ``SmemBudget`` (in budget it launches, the
   whole-array tile is flagged and refused); a K = 20000 streamed fit at
   N = 900 under a quarter of one [B, K, N] f32 state tensor.  It runs
   beside phase 2's edge grid, after the rest of phase 2 (see there).  The
   kernels line also holds ``block_copy`` bitwise to its plain version
   at the fixture's in-budget tile (the TMA route), beside ``x.clone()``,
   and names the route that ran.

Then the LM serving path (``repro_torch.models``, ``runtime.steps``):

22. ``lm_serving`` — reservoir_lm at full width (12 layers, d 768, N 256,
   R 3): f32 logits on numpy weights held to the JAX package's, K1 once a
   layer; 8 requests × 512 prompt tokens × 64 new tokens served in bf16
   and f32 (prefill ms, decode ms a token, tokens/s, K1's share of a step,
   decode held to forward); the mixer on K1 bitwise its plain route;
   granite-8b at full width (f32 params drawn on the card) prefilling
   4 × 128 and decoding 16, decode held to forward; the chunked attention
   against the dense one at Skv 4096.  Then every other arch: each smoke
   config's f32 logits on numpy weights held to the JAX package's, and
   one line a cell (LM_ARCH_CELLS) at full width, depth cut only where f32
   params would not fit the card: qwen3-moe-30b-a3b, qwen3-moe-235b-a22b
   and jamba-v0.1-52b (MoE at the dropless capacity factor; decode held to
   a forward routed as the served run, expert-set flips and the share
   dropped at the config's own factor reported), xlstm-1.3b, the VLM
   llama-3.2-vision-11b (1600 stub patches) and the encoder-decoder
   seamless-m4t-medium (1024 stub frames).  The kernels line then adds K1 at
   the LM's prefill and decode shapes, and the readout-apply kernel at the
   streamed evaluation's bf16 chunk [64, 256, 900] and the session tick's
   [4096, 32, 64] (within 1e-6 of its plain version, relative to the sum's
   magnitude, bitwise from call to call, beside ``torch.baddbmm``).

Then the LM training path (``repro_torch.launch.train``, ``runtime.trainer``,
``runtime.steps.train_step``, ``optim``, ``data``):

23. ``lm_training`` — reservoir_lm at full width with its config's bf16
   activations over f32 params, 4 microbatches and remat "full", trained 10
   steps of 32 × 512 tokens through ``launch.train.main`` (K1 96 and K1ᵀ 48
   launches a step, launches == calls; the loss finite and falling), then
   resumed from its checkpoint for 2 more; step ms, tokens/s, peak memory,
   grad norms; one step profiled (the device's busy share, K1's and K1ᵀ's
   share of it); every leaf's gradient of a 2-layer cut through K1 and K1ᵀ
   against the plain route's; the f32 smoke train step against the JAX
   package's losses and grad norms.  The kernels line then adds K1 at the
   training forward's f32 states and K1ᵀ at the step's first backward,
   both [24, 512, 256], and K1 at the materialized NARMA10 split.

Then the distribution code (``repro_torch.parallel``, ``launch.mesh``):

24. ``parallel`` — two gloo ranks on the one card (NCCL refuses two ranks on
   one device), spawned by ``launch.mesh.run_ranks``, run the sharded train
   step (each rank its state blocks, Megatron tensor parallelism over
   "model", each unit's leaves gathered as it runs and again in the
   recompute, the gradients back by reduce-scatter) on reservoir_lm at
   full width (12 layers, d 768, N 256, vocab 32000, 4 microbatches, remat
   "full"; f32 activations, so the gap to one process is f32 summation
   order alone) for PAR_STEPS steps of PAR_BATCH from one state, on the
   (2, 1) mesh (each microbatch's rows split over the two data ranks) and
   on the (1, 2) mesh (the MLP and the vocab split over the two model
   ranks), on granite-8b at full width cut to PAR_GRANITE_LAYERS
   layers for PAR_GRANITE_STEPS steps on (1, 2) (heads, kv heads, MLP and
   vocab split), and on xlstm-1.3b at full width cut to one unit for one
   step of PAR_XLSTM_BATCH on (1, 2) (the mLSTM's channels, the sLSTM's
   heads, columns and gated projection split): every loss and every param
   leaf (xlstm's first moments: see PAR_XLSTM_BATCH) within twice the
   unsharded step's own spread under another split of its sums (more
   microbatches of fewer rows; for the tensor-parallel runs also under a
   ±2e-7 nudge of every weight, the larger), floored at LM_TRAIN_TOL and
   PAR_PARAM_TOL of the leaf's largest; K1 and K1ᵀ launches == calls == one process's on
   each rank.  Each rank's step ms, peak device bytes, collectives by kind
   and mesh axis and their wire bytes (``launch.time_parallel``), beside
   the figures of the route the step replaced (PAR_PR23_ROUTE).  Then one
   sharded step through NCCL at world 1, bitwise the unsharded step, and
   NARMA10 (N = 900, B = 64) through ``Experiment`` over the two ranks'
   (2, 1) mesh, NRMSE per instance within 1e-4 of one process.  Its
   ``parallel_dfrc`` line: the DFRC pipeline's other paths over the same
   mesh (``pdfrc_cases``): phase 7's streamed 64-channel WDM run (N =
   100) and its shared readout over 8 channels (each chunk's features
   all-gathered, the whole F = 801 Gram folded on each rank), the d2_l2
   graph through ``Experiment`` and d2_l1 per WDM channel on phase 20's
   MC probe, and the device map of SWEEP_GRID at N = 16 over 300 samples
   (``dev_params`` cut with the lanes).  Each rank's results bitwise one
   process's, but where only cuSOLVER's eigh at another batch size moves
   them (its solve's inputs bitwise its block of one process's, and that
   block solved at the rank's batch size gives the rank's bits): there
   NRMSE within 1e-3; K1 and K3 launches == calls == one process's; the
   collectives exact (one all-gather of the results, or one of features a
   chunk).  The shared readout also through NCCL at world 1, bitwise.
   First in the ranks' spawn, GPipe (``parallel.pipeline.pipeline_apply``,
   each send and receive staged through the host under gloo): the same
   reservoir_lm without grad cut into PIPE_STAGES stages of six units, one
   a rank, PAR_BATCH's first batch as PIPE_MICRO microbatches of 2 × 512
   tokens, embedded on every rank and normed into logits after the
   broadcast; every rank's outputs and logits bitwise one process's fold
   of the same microbatches, greedy ids equal, K1 launches == calls == 6
   units × 5 ticks a call, the permutes and the broadcast exact; a rank's
   ms a call against the fold's, the bubble, peak bytes.
25. ``parallel_serving`` — sharded serving (``runtime.steps.serve_prefill``
   / ``serve_decode`` under a mesh: each rank its param blocks, its rows,
   its cache blocks, tensor-parallel over "model") on two gloo ranks of the
   one card: reservoir_lm at full width and depth in f32 on (1, 2) and on
   (2, 1), and on (2, 1) at batch 1 (the long-context layout), granite-8b
   at full width cut to PSERVE_GRANITE_LAYERS layers in f32 on (1, 2),
   xlstm-1.3b at full width cut to one unit (7 mLSTM + 1 sLSTM) in f32 on
   (1, 2), the mLSTM's channels and C/n cache rows and the sLSTM's heads
   and c/n/h cache tensor-parallel;
   each a prefill of PSERVE_BATCH then PSERVE_DECODES decode steps fed the
   unsharded run's greedy ids.  Each rank's logits within twice one
   process's own row-split spread (``row_split_spread``; xlstm's also
   under the ±PAR_NUDGE weight nudge, the larger; floored at
   PSERVE_TOL_FLOOR) of the unsharded port's; an xlstm decode step
   all-gathers over "model" exactly the whole leaves' and the activations'
   bytes (``pserve_model_gathers``: no weight block, no C/n/c/h cache
   block); every rank's greedy ids
   identical (``launch.serve.gathered_ids``); K1 launches == calls ==
   12 a step on each rank.  Each rank's prefill ms, decode ms p50, peak
   device bytes and the wire bytes of a decode step by collective kind.
   Then the same through NCCL at world 1 on the (1, 1) mesh, bitwise the
   unsharded serve.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero without that line; so it does when
no CUDA device is available or the port's package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# task seeds of a full-width path (the operating points come from
# repro_torch.configs.dfrc_tasks(): ``main_point``)
B_MAIN = 64
# f32 ops of one SiliconMR node step: u, drive (2), alpha, charge,
# discharge (2), compare, select
SCAN_OPS_PER_STEP = 9
# dependent f32 ops of SiliconMR's least node-chain step: mul, add, select
# (the compare and the charge add run beside them); the chain bound counts
# each at the latency of one dependent f32 add, measured on the card by
# chain_cycles()
CHAIN_OPS = 3
# f32 ops of one MackeyGlass node step (powf and the division one each): u,
# gamma_in·u, x, |x|, |x|^p, 1 + ·, eta·x, the division, 1 - c, the drive's
# mul — these 10 chain-free ops issued by the helper warps of K1's
# helper-warp route, off the chain — and the chain's mul and add, the chain
# warp's only work (its chain bound counts those two, ``mg_step``); of one
# MZISine step: u, beta·u, alpha·s, two adds, sinf, the square
MG_OPS_PER_STEP = 12
MZI_OPS_PER_STEP = 7
CHAIN_PROBE_STEPS = 1 << 20
# the scan kernel's check of a whole split on the kernels line, where its
# plain version would take minutes: the first periods only
SPLIT_CHECK_K = 32
STREAM_CHUNK = 256
N_WDM = 100
# the scan kernel's edge grid (phase_scan_checks): N at the float4 group's
# and the warp's edges and the path widths, B at the 8-lane block's edges
SCAN_EDGE_N = (1, 31, 32, 33, 100, 900)
SCAN_EDGE_B = (1, 33, 64, 65)
SCAN_EDGE_K = (1, 2, 37)
# the shared readout (F = 801), folded by K3 and by plain matmuls.  The gate
# on K3 there is each Gram's error against the bound of an f32 sum
# ("gram_error_vs_bound" ≤ 1).  The NRMSE gap between the two fits is no
# kernel check: it shows how far the ill-conditioned f32 solve (cond ≈ 8e8,
# one input drives all 8 channels) spreads two f32 sums taken in another
# order (≈ 0.012; the float64 fit reads 0.540 and both f32 fits 0.569–0.581,
# PERF.md).  SHARED_TOL only catches a readout far off either.
SHARED_TOL = 0.03
# two λ whose GCV scores differ by less than this (relative) tie: ‖y‖² summed
# in another order moves a score by ~1e-7 relative, a few times that after
# the cancellation in ‖y − ŷ‖²
GCV_TIE_RTOL = 1e-5
# The repo's serving configuration (benchmarks/dfr_serving.py:48-56): N = 64,
# 32-period ticks, washout 32, 256-period channel-equalization streams at
# 24 dB (255 periods after the task's train split), a re-solve every 4 ticks
# over the λ grid below; the CLI's seeds (serve_dfr.main).
SERVE_N = 64
SERVE_CHUNK = 32
SERVE_WASHOUT = 32
SERVE_STREAM = 256
SERVE_REFRESH = 4
SERVE_LAMS = (1e-8, 1e-6, 1e-4)
SERVE_SNR_DB = 24.0
SERVE_B = 4096
SERVE_REQUESTS = 2 * SERVE_B
SERVE_B_SMALL = 512
# Steady SER (last quarter of each stream) of the JAX package's DFRServer on
# the CPU, B = 64 over the first 64 of these streams, by forgetting factor;
# tests/test_torch_serving.py::test_chip_smoke_ser_band_comes_from_the_reference
# recomputes them.  A drain's steady SER must lie within SERVE_SER_BAND of
# them: the 64-stream mean has a sampling spread of ≈ 0.0075 (3520 symbols).
SERVE_REF_STEADY_SER = {0.99: 0.23551136363636366, 1.0: 0.23551136363636363}
SERVE_SER_BAND = 0.03
# the re-convergence gates of tests/test_robustness.py (the chaos soak's)
SOAK_TAIL_SER = 0.5
SOAK_TAIL_BAND = 0.15
# The CMT cavity at the main path's NARMA10 point (phase 15): the reference's
# CMT pipeline model (src/repro/analysis/registry.py:176 `_cmt_model`,
# calibrated_twin(SiliconMR(), power_mw=1.0)), noise off, K1 and K2.  Its
# scan-kernel check at the main width runs K = CMT_CHECK_K periods: its plain
# version issues ≈ 170 eager ops a node.
CMT_POWER_MW = 1.0
CMT_SAMPLES = 2000
CMT_CHECK_K = 8
# The first seeds in the JAX package on the CPU (`fast` path, noise off):
# the pipeline's NRMSE (the Gram readout; GCV picks λ = 1e-4 for each) and
# the NRMSE of a float64 ridge at that λ on its states;
# tests/test_torch_devices.py::test_chip_smoke_cmt_nrmse_comes_from_the_reference
# recomputes both.  The card's float64-ridge NRMSE must lie within
# CMT_NRMSE_TOL of the latter (phase_cmt_main says why not the former).
CMT_REF_NRMSE = (0.8996966481208801, 0.8505415320396423, 0.8305402994155884,
                 0.8732490539550781)
CMT_REF_NRMSE_F64 = (0.87196471149203, 0.8282991127913726, 0.8117860445161381,
                     0.8523894193792741)
CMT_REF_LAM = 1e-4
CMT_NRMSE_TOL = 2e-3
# benchmarks/device_sweep.py:47-48: the calibration gates
PARITY_NRMSE = 2e-2
PARITY_TICK = 1e-4
# The robustness map at the benchmark's full size (benchmarks/device_sweep.py:
# 53-57 and grids(smoke=False), :70): 60 lanes on the calibrated twin, NARMA10
# of 1200 samples at seed 0, streamed; NARMA_STABLE (:49) bounds a stable cell.
SWEEP_GRID = {"detune": (-1.5, -0.75, 0.0, 0.75, 1.5), "loss_scale": (1.0, 1.25, 1.5),
              "power": (0.0, 0.5, 1.0, 2.0)}
SWEEP_N = 64
SWEEP_WASHOUT = 50
SWEEP_CHUNK = 128
SWEEP_LAMS = (1e-8, 1e-6, 1e-4)
SWEEP_SAMPLES = 1200
SWEEP_STABLE = 0.8
SWEEP_TOL = 1e-3
# The JAX package's map on the CPU, lanes raveled (detune slowest, power
# fastest), and for each of its stable cells (lane, NRMSE of a float64 ridge
# at λ = SWEEP_LAMS[-1] on its states at the cell's point);
# tests/test_torch_devices.py::
# test_chip_smoke_sweep_map_comes_from_the_reference recomputes both.
SWEEP_REF_NRMSE = (
    0.8450366854667664, 0.869547426700592, 0.8760874271392822, 0.8708988428115845,
    0.8773038983345032, 0.8663710951805115, 0.9385777711868286, 0.8683626055717468,
    0.8555883169174194, 0.8652852773666382, 0.901858389377594, 0.8955351710319519,
    0.8349586725234985, 0.8562496304512024, 0.8867444396018982, 0.9099999666213989,
    0.8383848667144775, 0.8521167635917664, 0.8960800170898438, 0.9210359454154968,
    0.8637803792953491, 0.849626898765564, 0.9042402505874634, 0.9138334393501282,
    0.6497445702552795, 0.842348575592041, 0.8892285227775574, 0.8603212833404541,
    0.7436235547065735, 0.9007450938224792, 0.9063539505004883, 0.883876621723175,
    0.912720263004303, 0.8655397295951843, 0.8814934492111206, 1.0062737464904785,
    0.8349586725234985, 0.859123706817627, 0.900079071521759, 0.8826367855072021,
    0.8383848667144775, 0.857671856880188, 0.8842637538909912, 0.8730575442314148,
    0.8637803792953491, 0.8533728122711182, 0.8884021043777466, 0.8730389475822449,
    0.8450366854667664, 0.8714228868484497, 0.8661399483680725, 0.8716993927955627,
    0.8773038983345032, 0.8928217887878418, 0.9326395392417908, 0.8898537158966064,
    0.8555883169174194, 0.8676750063896179, 0.9023471474647522, 0.9235250949859619)
SWEEP_REF_STABLE_F64 = ((24, 0.6394804100450985), (28, 0.7353381701431898))
# `fast` on the card (phase 19): SiliconMR at the main width, K = 32; the
# log-depth models at the channel-equalisation width of dfrc_tasks()
# (src/repro/configs/__init__.py:182, N = 400), K = 256
FAST_SHAPES = {"SiliconMR": (64, 32, 900), "MackeyGlass": (64, 256, 400),
               "SiliconMRLiteral": (64, 256, 400)}
# The paper's Fig. 5 and Fig. 6 cells (benchmarks/fig5_nrmse.py,
# benchmarks/fig6_ser.py) at dfrc_tasks()'s operating points, B_MAIN task
# seeds a cell: NARMA10 (2000 samples, 1000/1000) and Santa Fe (6000,
# 4000/2000) for Fig. 5, channel equalisation (9000 symbols, 6000/3000) at
# each SNR of FIG_SNRS for Fig. 6, each with the three accelerators.
FIG_SNRS = (12, 16, 20, 24, 28, 32)
FIG_ACCELERATORS = ("Silicon MR", "All Optical (MZI)", "Electronic (MG)")
FIG_PAPER_CLAIMS = {"narma10": 0.35, "santa_fe": 0.987, "channel_eq": 0.588}
# Seeds 0..3 of every cell are held to the JAX package on the CPU (its
# `fast` path and the SVD readout, as benchmarks/common.fit_and_eval runs
# it): noise off within FIG_NRMSE_TOL / FIG_SER_TOL (15 of 3000 symbols)
# unless the two λ picks tie in GCV (within GCV_TIE_RTOL, the scores taken
# in float64 on the card's features: MZISine's features have rank 3, so its
# f32 picks among λ ≤ 1e-4 fit round-off, whose f32 scores differ by ~3e-4;
# tests/test_torch_configs.py::test_mzi_features_have_rank_three);
# noise on (a torch.Generator's draws, not jax.random's) within the bands of
# tests/test_torch_experiment.py:95,104.  tests/test_torch_fig5.py,
# test_torch_fig6.py and test_torch_fig6_high.py recompute FIG_REF_OFF
# (values, λ), FIG_REF_ON and FIG_REF_F64 with one BLAS thread: the
# reference's noise-off numbers move by up to 5.3e-3 with the thread count
# of the BLAS under its LAPACK SVD (the round-off fits of λ = 1e-10).
FIG_NRMSE_TOL = 5e-3
FIG_SER_TOL = 0.005
FIG_NOISE_NRMSE_BAND = 0.02
FIG_NOISE_SER_BAND = 0.025
FIG_REF_OFF = {
    "narma10/Silicon MR":
        ((39.639434814453125, 8.354874610900879,
          0.7678205370903015, 13.43693733215332),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "narma10/All Optical (MZI)":
        ((0.8560509085655212, 0.8794974088668823,
          0.8487948179244995, 0.866374671459198),
         (1.000000013351432e-10, 0.009999999776482582,
          0.009999999776482582, 0.009999999776482582)),
    "narma10/Electronic (MG)":
        ((0.516032874584198, 0.4411945343017578,
          0.47483980655670166, 0.46164247393608093),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "santa_fe/Silicon MR":
        ((0.5715129375457764, 0.5712162852287292,
          0.572359561920166, 0.5452709197998047),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "santa_fe/All Optical (MZI)":
        ((0.9928528070449829, 0.9924067258834839,
          0.99309241771698, 0.9927371144294739),
         (9.999999747378752e-05, 9.999999747378752e-05,
          9.999999747378752e-05, 9.999999747378752e-05)),
    "santa_fe/Electronic (MG)":
        ((0.610285758972168, 0.5994734168052673,
          0.6063408255577087, 0.5824384689331055),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@12dB/Silicon MR":
        ((0.1693333387374878, 0.1783333271741867,
          0.17233332991600037, 0.17766666412353516),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@12dB/All Optical (MZI)":
        ((0.6430000066757202, 0.6610000133514404,
          0.6359999775886536, 0.6536666750907898),
         (1.000000013351432e-10, 9.999999747378752e-05,
          9.999999747378752e-05, 9.999999747378752e-05)),
    "channel_eq@12dB/Electronic (MG)":
        ((0.12033332884311676, 0.13099999725818634,
          0.12600000202655792, 0.1263333261013031),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@16dB/Silicon MR":
        ((0.10133333504199982, 0.10400000214576721,
          0.09966666251420975, 0.10599999874830246),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@16dB/All Optical (MZI)":
        ((0.6420000195503235, 0.6586666703224182,
          0.6319999694824219, 0.6513333320617676),
         (1.000000013351432e-10, 9.999999747378752e-05,
          1.000000013351432e-10, 9.999999747378752e-05)),
    "channel_eq@16dB/Electronic (MG)":
        ((0.045666664838790894, 0.04899999871850014,
          0.04699999839067459, 0.05000000074505806),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@20dB/Silicon MR":
        ((0.06499999761581421, 0.07333333045244217,
          0.07100000232458115, 0.0729999989271164),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@20dB/All Optical (MZI)":
        ((0.6359999775886536, 0.6509999632835388,
          0.628000020980835, 0.6470000147819519),
         (1.000000013351432e-10, 9.999999747378752e-05,
          9.999999747378752e-05, 9.999999747378752e-05)),
    "channel_eq@20dB/Electronic (MG)":
        ((0.01966666616499424, 0.017666665837168694,
          0.019333332777023315, 0.012666666880249977),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@24dB/Silicon MR":
        ((0.05433333292603493, 0.06399999558925629,
          0.05766666680574417, 0.05900000035762787),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@24dB/All Optical (MZI)":
        ((0.6349999904632568, 0.6486666798591614,
          0.6293333172798157, 0.6430000066757202),
         (1.000000013351432e-10, 9.999999974752427e-07,
          9.99999993922529e-09, 9.999999747378752e-05)),
    "channel_eq@24dB/Electronic (MG)":
        ((0.009333333000540733, 0.00566666666418314,
          0.007999999448657036, 0.006666666828095913),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@28dB/Silicon MR":
        ((0.05000000074505806, 0.05900000035762787,
          0.0533333346247673, 0.05533333122730255),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@28dB/All Optical (MZI)":
        ((0.6330000162124634, 0.6483333110809326,
          0.6299999952316284, 0.640999972820282),
         (1.000000013351432e-10, 9.999999747378752e-05,
          9.99999993922529e-09, 9.999999747378752e-05)),
    "channel_eq@28dB/Electronic (MG)":
        ((0.0033333334140479565, 0.003666666569188237,
          0.004333333112299442, 0.005333333276212215),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@32dB/Silicon MR":
        ((0.050999999046325684, 0.055666666477918625,
          0.05066666752099991, 0.05533333122730255),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
    "channel_eq@32dB/All Optical (MZI)":
        ((0.6326666474342346, 0.6483333110809326,
          0.6303333044052124, 0.6399999856948853),
         (1.000000013351432e-10, 9.999999747378752e-05,
          1.000000013351432e-10, 9.999999747378752e-05)),
    "channel_eq@32dB/Electronic (MG)":
        ((0.001999999862164259, 0.003000000026077032,
          0.0026666666381061077, 0.0023333332501351833),
         (1.000000013351432e-10, 1.000000013351432e-10,
          1.000000013351432e-10, 1.000000013351432e-10)),
}
FIG_REF_ON = {
    "narma10/Silicon MR":
        (0.586178719997406, 0.5653291344642639, 0.585185706615448, 0.572990894317627),
    "narma10/All Optical (MZI)":
        (0.8526329398155212, 0.8794431686401367, 0.848791778087616, 0.8663763999938965),
    "narma10/Electronic (MG)":
        (0.576658308506012, 0.5188372731208801, 0.5433540344238281, 0.5253983736038208),
    "santa_fe/Silicon MR":
        (0.5743244290351868, 0.5763852596282959, 0.5854659080505371, 0.5559356212615967),
    "santa_fe/All Optical (MZI)":
        (0.9928527474403381, 0.9924071431159973, 0.9930999875068665, 0.992737352848053),
    "santa_fe/Electronic (MG)":
        (0.6125894784927368, 0.6039242148399353, 0.6086484789848328, 0.585300862789154),
    "channel_eq@12dB/Silicon MR":
        (0.20899999141693115, 0.2213333249092102, 0.20633332431316376, 0.2083333283662796),
    "channel_eq@12dB/All Optical (MZI)":
        (0.6433333158493042, 0.6629999876022339, 0.6359999775886536, 0.6536666750907898),
    "channel_eq@12dB/Electronic (MG)":
        (0.13966666162014008, 0.14666666090488434, 0.14666666090488434, 0.14933332800865173),
    "channel_eq@16dB/Silicon MR":
        (0.14933332800865173, 0.1589999943971634, 0.15466666221618652, 0.15333333611488342),
    "channel_eq@16dB/All Optical (MZI)":
        (0.640666663646698, 0.659333348274231, 0.6316666603088379, 0.6513333320617676),
    "channel_eq@16dB/Electronic (MG)":
        (0.060333333909511566, 0.06833333522081375, 0.06866666674613953, 0.07000000029802322),
    "channel_eq@20dB/Silicon MR":
        (0.12066666781902313, 0.12866666913032532, 0.12600000202655792, 0.12933333218097687),
    "channel_eq@20dB/All Optical (MZI)":
        (0.6386666893959045, 0.6509999632835388, 0.628000020980835, 0.6470000147819519),
    "channel_eq@20dB/Electronic (MG)":
        (0.03266666457056999, 0.03866666555404663, 0.038333334028720856, 0.03566666692495346),
    "channel_eq@24dB/Silicon MR":
        (0.10799999535083771, 0.11766666173934937, 0.11233333498239517, 0.11433333158493042),
    "channel_eq@24dB/All Optical (MZI)":
        (0.6349999904632568, 0.6483333110809326, 0.6293333172798157, 0.6430000066757202),
    "channel_eq@24dB/Electronic (MG)":
        (0.023000000044703484, 0.02666666731238365, 0.025333333760499954, 0.024666666984558105),
    "channel_eq@28dB/Silicon MR":
        (0.10099999606609344, 0.11100000143051147, 0.1066666692495346, 0.10966666787862778),
    "channel_eq@28dB/All Optical (MZI)":
        (0.6356666684150696, 0.6476666331291199, 0.6296666860580444, 0.640999972820282),
    "channel_eq@28dB/Electronic (MG)":
        (0.017999999225139618, 0.019999999552965164, 0.01966666616499424, 0.02266666665673256),
    "channel_eq@32dB/Silicon MR":
        (0.10066666454076767, 0.10833333432674408, 0.10333333164453506, 0.10700000077486038),
    "channel_eq@32dB/All Optical (MZI)":
        (0.6330000162124634, 0.6489999890327454, 0.6296666860580444, 0.6399999856948853),
    "channel_eq@32dB/Electronic (MG)":
        (0.01666666567325592, 0.017999999225139618, 0.017666665837168694, 0.01966666616499424),
}
# Every cell's seeds are also held where the states alone decide: a float64
# ridge at FIG_F64_LAM on the card's noise-off K1 states scores within
# FIG_F64_TOL (NRMSE, also for the SER cells) of the same fit on the
# reference's states (FIG_REF_F64).  NARMA10 on Silicon MR, noise off, is
# held by that alone: T_fit = 940 rows for F = 901 features at λ = 1e-10 is
# an interpolation whose SVD fit the reference cannot repeat under an ulp of
# input (its NRMSE moves by O(1);
# tests/test_torch_fig5.py::test_narma10_mr_noise_off_is_round_off).
FIG_F64_LAM = 1e-4
FIG_F64_TOL = 1e-5
FIG_PIPELINE_EXEMPT = ("narma10/Silicon MR",)
FIG_REF_F64 = {
    "narma10/Silicon MR":
        (0.5862950329035234, 0.5652984215946532, 0.585345013030658, 0.5727491436762253),
    "narma10/All Optical (MZI)":
        (0.852643019376424, 0.879450491398032, 0.8487119830957067, 0.8662548479376044),
    "narma10/Electronic (MG)":
        (0.5758845325950639, 0.5176414827378681, 0.5432584949686234, 0.5243719106436034),
    "santa_fe/Silicon MR":
        (0.6010911075222823, 0.5998295894565687, 0.6093111569140772, 0.5873025181594297),
    "santa_fe/All Optical (MZI)":
        (0.9928528579669943, 0.9924066085801202, 0.9930923349828704, 0.9927371880737144),
    "santa_fe/Electronic (MG)":
        (0.6151850423377726, 0.6081613661474738, 0.6144885303819165, 0.5920683861629692),
    "channel_eq@12dB/Silicon MR":
        (0.4454465013889521, 0.4450649497322924, 0.4441171372071611, 0.4449627436301634),
    "channel_eq@12dB/All Optical (MZI)":
        (0.8366804777142763, 0.8416008337118798, 0.8439340803905229, 0.8401661296470578),
    "channel_eq@12dB/Electronic (MG)":
        (0.3221544556443296, 0.32287539527629416, 0.3197429832940293, 0.32129045651190774),
    "channel_eq@16dB/Silicon MR":
        (0.4051885991284367, 0.4056097338937723, 0.4030348809310189, 0.40528292901570134),
    "channel_eq@16dB/All Optical (MZI)":
        (0.8304074361655873, 0.8345631076775702, 0.8354203791217644, 0.8345712080065203),
    "channel_eq@16dB/Electronic (MG)":
        (0.26578780610614366, 0.2670908157346861, 0.2629270530158686, 0.26624347834322),
    "channel_eq@20dB/Silicon MR":
        (0.38501750607551966, 0.38596620153242595, 0.3820434636641275, 0.38623196998306003),
    "channel_eq@20dB/All Optical (MZI)":
        (0.827655488781751, 0.8307174679236817, 0.8305373571617678, 0.830601460703205),
    "channel_eq@20dB/Electronic (MG)":
        (0.23760542362405168, 0.23963200737054977, 0.23463035393103032, 0.23976414444408517),
    "channel_eq@24dB/Silicon MR":
        (0.3751596359414256, 0.3769348933539136, 0.3717827806722108, 0.3775404537582168),
    "channel_eq@24dB/All Optical (MZI)":
        (0.8263736562861022, 0.8291080669705945, 0.827069853797128, 0.8285447896954935),
    "channel_eq@24dB/Electronic (MG)":
        (0.22478321513833546, 0.227381677627698, 0.22189815921516598, 0.2282394833547034),
    "channel_eq@28dB/Silicon MR":
        (0.37025998131943005, 0.372716586733081, 0.3667186251730952, 0.3737947253865649),
    "channel_eq@28dB/All Optical (MZI)":
        (0.8255401984041435, 0.8283891072644617, 0.8250557972542588, 0.8267590728448689),
    "channel_eq@28dB/Electronic (MG)":
        (0.21923586847995322, 0.22217652577091054, 0.2164099718559608, 0.22360999439943993),
    "channel_eq@32dB/Silicon MR":
        (0.36794805615718057, 0.3706219310145369, 0.36407716168229354, 0.37185358019630077),
    "channel_eq@32dB/All Optical (MZI)":
        (0.8250159122929401, 0.8280237134417039, 0.8238282347713423, 0.8257536573864043),
    "channel_eq@32dB/Electronic (MG)":
        (0.21686299070661214, 0.21999684822877477, 0.21406741379756303, 0.22181047975636253),
}
# The composed-graph probe of benchmarks/composed_reservoirs.py:70-77 and its
# six topologies (:91-118, ``composed_topologies``): linear memory capacity
# over 24 delays, 1200 samples (600/600), washout 40, chunk 64, three λ,
# noise off, B_MAIN task seeds; K1 states and the K3 fold.
MC_SAMPLES = 1200
MC_MAX_DELAY = 24
MC_WASHOUT = 40
MC_CHUNK = 64
MC_LAMS = (1e-8, 1e-6, 1e-4)
MC_MARGIN = 0.3
# Seeds 0..2 of each cell against the JAX package on the CPU
# (tests/test_torch_composed_mc.py recomputes both tables).  The f32 MC at
# these λ rides on an f32 eigh of a Gram whose condition nears 1/eps, so
# where that eigh runs sets how close it comes.  Held, outside
# COMPOSED_F32_EXEMPT (d1_l1_baseline, whose f32 MC the reference itself
# cannot repeat: it moves by 0.57 under an ulp of input):
# * the exact Gram of the card's K1 features (float64 sums rounded once to
#   f32) solved by ``solve_gcv`` on the host, whose LAPACK eigh is the one
#   the reference runs: within COMPOSED_HOST_MC_TOL, as the port on the CPU
#   (≤ 5.2e-3) and the reference's own MC under a 2e-7 move of its inputs
#   (≤ 2.7e-3);
# * the pipeline on the card (the K3 fold, cuSOLVER's f32 eigh) and the same
#   run with the plain fold: within COMPOSED_MC_TOL.  On one exact Gram the
#   card's eigh and the host's move the MC apart by up to 0.0143, and on the
#   card the fold's summation order moves it by up to 0.024; the reading
#   that set the limit put the K3 run at 0.0162 and the plain fold at
#   0.0157 from the reference (PERF.md, PR 17);
# and in every cell the MC of a float64 ridge at COMPOSED_F64_LAM (each
# cell's GCV pick) on the card's K1 states within COMPOSED_F64_TOL of the
# same fit on the reference's states.
COMPOSED_SEEDS = 3
COMPOSED_MC_TOL = 0.02
COMPOSED_HOST_MC_TOL = 6e-3
COMPOSED_F32_EXEMPT = ("d1_l1_baseline",)
COMPOSED_F64_LAM = 1e-6
COMPOSED_F64_TOL = 1e-4
COMPOSED_REF_MC = {
    "d1_l1_baseline":
        (3.635083533083837, 4.526368563915568, 4.329428173989732),
    "d1_l2":
        (3.8121161017051577, 4.153613547335853, 4.528726032038384),
    "d2_l1":
        (4.806412051498802, 5.2146167825525005, 5.463614399177795),
    "d2_l2":
        (4.163791473133678, 4.365442259565695, 4.510950345821337),
    "d3_l1":
        (4.274255153051099, 4.631784800025507, 4.874998182441205),
    "d3_l2":
        (3.6124703008861205, 3.786838617076377, 3.990161285949467),
}
COMPOSED_REF_MC_F64 = {
    "d1_l1_baseline":
        (5.0281420576960185, 5.575136251920764, 5.913924719220042),
    "d1_l2":
        (4.990999918579651, 5.547205523831366, 5.886671672615378),
    "d2_l1":
        (6.391016470952952, 6.97514069889784, 7.126333385935196),
    "d2_l2":
        (5.616380857487364, 6.11049344190716, 6.146314265974246),
    "d3_l1":
        (5.969829323828506, 6.525644452276026, 6.70547627901422),
    "d3_l2":
        (5.374430272186421, 5.7653791128411305, 5.850847476164407),
}
# the composed memory contract at the long-stream operating point
# (benchmarks/composed_reservoirs.py:78-82): K = 20000 a split, chunk 160
COMPOSED_LONG_K = 20000
COMPOSED_LONG_CHUNK = 160

# the lm_serving phase (repro_torch.models on the LM serving path): the
# paper's reservoir_lm (src/repro/configs/reservoir_lm.py) at full width,
# weights drawn with numpy at LM_SEED (lm_numpy_params), held in f32 to
# the JAX package's logits on tokens drawn at LM_TOKENS_SEED through a
# summary (lm_logit_summary: a fixed projection of each position's logits
# over the vocabulary, and their root mean square), recomputed by
# tests/test_torch_lm_model.py; LM_SUMMARY_TOL: the port on the CPU is
# within 5e-7 of these, and within 4e-7 of itself under a 2e-7 relative
# move of every weight (no branch of the node chain flips)
LM_SEED = 0
LM_TOKENS_SEED = 1
LM_PROJ_SEED = 7
LM_CHECK_SHAPE = (2, 16)
LM_CONTEXT_SEED = 3
LM_SUMMARY_TOL = 2e-5
LM_REF_SUMMARY = {
    "proj": (
        (0.14971231885311517, 0.005818624895427085, 0.06481481979783375, 0.07691882431815095,
         0.11259927219540769, 0.12875887800435223, 0.1297070336958942, 0.1492899632591138,
         0.13949228948252354, 0.16265261916124404, 0.1478820779728531, 0.15267809885775274,
         0.16041674460164718, 0.16241109587683503, 0.16319582131676202, 0.16887747383396728),
        (-0.05391481868116422, -0.04205815493092653, 0.02264166800362207, 0.05758497446148339,
         0.06385822561500826, 0.07802859620743625, 0.09456940057455467, 0.11630795523920293,
         0.10882207329779561, 0.12897718253899512, 0.1283198185946325, 0.14339406374679103,
         0.1425360610259263, 0.15109816944092852, 0.15613356392042504, 0.16183766113821724),
    ),
    "rms": (
        (0.15563378252443297, 0.1538026949595953, 0.15376037402179976, 0.15360484532303348,
         0.15381033018337958, 0.15403505911702234, 0.15418646836661057, 0.15433268001818753,
         0.15422269988699885, 0.15434579267808565, 0.1542985309643352, 0.15435436735009248,
         0.1544668652024933, 0.15442924217011106, 0.15448580525745095, 0.1544712628490569),
        (0.15512466451898296, 0.15426637696109458, 0.15404234761989052, 0.15415873983153897,
         0.15418163228973894, 0.15430022602497076, 0.15439280502793448, 0.15430986140110953,
         0.15439633027411154, 0.15443355648107512, 0.1545454507468324, 0.15442562868415785,
         0.15449268824902604, 0.1544510472658021, 0.15457266326789684, 0.15453863746885155),
    ),
}
# (b): serving 8 requests of 512 prompt tokens, 64 new tokens each, bf16
LM_SERVE_B = 8
LM_SERVE_PROMPT = 512
LM_SERVE_NEW = 64
# (c): the mixer on K1 against its plain route, at a cut length
LM_MIXER_CHECK = (4, 48)
# (d): granite-8b (src/repro/configs/granite_8b.py) at full width, prefill
# 4 x 128, 16 decode steps; the chunked attention against the dense one at
# Skv 4096 with chunk 1024
GRANITE_B = 4
GRANITE_PROMPT = 128
GRANITE_NEW = 16
SDPA_SKV = 4096
SDPA_CHUNK = 1024
# decode steps profiled (device busy share, kernels by device time)
LM_PROFILE_STEPS = 3
# decode against forward in f32: the reference's own bound
# (tests/test_models.py:73)
DECODE_ATOL, DECODE_RTOL = 2e-4, 2e-3
# bf16 serving's decode against its forward: the two round their bf16
# hidden states apart.  The H100 gave gaps of 2^-7 (reservoir_lm, logits
# |z| <= 0.71) and 2^-6 (granite-8b, 36 layers, |z| <= 1.25); the bound is
# twice the larger.
DECODE_BF16_ATOL = 2 ** -5
# (e) every other arch of repro_torch.configs.ARCHS at full width: (arch,
# layers run of its n_layers, B, prompt, new tokens, dtypes served).  Depth
# is cut only where an f32 copy of the params (ModelConfig.param_count())
# would not fit the 80 GB card: qwen3-moe-30b-a3b 12 of 48 layers (31.2
# GB), qwen3-moe-235b-a22b 3 of 94 (32.3 GB), jamba-v0.1-52b one unit of 8
# of 32 (52.0 GB); xlstm-1.3b (7.4 GB), llama-3.2-vision-11b (37.0 GB) and
# seamless-m4t-medium (2.9 GB) run whole.  Params are drawn on the card by
# init_params; each cross-attention gate is then set to atanh(LM_CROSS_GATE)
# (init_params leaves it 0, where tanh(0) silences the block).
LM_ARCH_CELLS = (
    ("qwen3-moe-30b-a3b", 12, 4, 128, 16, ("float32", "bfloat16")),
    ("qwen3-moe-235b-a22b", 3, 2, 64, 8, ("bfloat16",)),
    ("jamba-v0.1-52b", 8, 2, 128, 8, ("bfloat16",)),
    ("xlstm-1.3b", 48, 4, 256, 16, ("float32", "bfloat16")),
    ("llama-3.2-vision-11b", 40, 2, 128, 8, ("bfloat16",)),
    ("seamless-m4t-medium", 24, 4, 64, 16, ("float32", "bfloat16")),
)
# one bf16 decode profile a family (moe, hybrid, ssm, vlm, audio)
LM_PROFILED = ("qwen3-moe-30b-a3b", "jamba-v0.1-52b", "xlstm-1.3b", "llama-3.2-vision-11b",
               "seamless-m4t-medium")
LM_CROSS_GATE = 0.5
# xlstm-1.3b's sLSTM at its config's init is a chaotic recurrence: r_rec's
# fan-in axis in the defs is its 4 heads, so it is drawn at 1/sqrt(4) where
# its true fan-in is head_dim = 512 (gain ≈ 0.5·sqrt(512) ≈ 11).  A 1e-7
# relative nudge of its pre-activations moves the logits by 7e-3 sixteen
# tokens later and by O(1) after 24, so a forward and its own first row
# run alone (row_split_spread: another GEMM shape) differ by O(1) on the
# card, and no decode can be held to a forward.  The cell reports that
# spread at the config's init, then draws r_rec at 1/sqrt(head_dim)
# (multiplies it by sqrt(heads / head_dim)), where the nudge does not grow.
# bf16 decode against forward for xlstm-1.3b: its mLSTM decodes by the
# (C, n, m) recurrence and forwards by the parallel form, which round bf16
# at other points (the parallel form rounds the weighted scores before the
# value product).  The H100 gave a gap of 0.2266 (logits |z| <= 1.02,
# 48 layers; the same forward at another GEMM shape moves by 0.084), and
# the JAX package's own gap between its two forms is 0.13-0.18 at smoke
# size (seeds 0-2); the bound is twice the larger, as DECODE_BF16_ATOL's
DECODE_BF16_ATOL_BY_ARCH = {"xlstm-1.3b": 2 ** -1}
# each arch's smoke config in f32 on lm_numpy_params at LM_SEED, tokens at
# LM_TOKENS_SEED and (VLM, enc-dec) a context at LM_CONTEXT_SEED: the JAX
# package's logit summary, recomputed by tests/test_torch_lm_model.py; the
# two qwen3-moe smoke configs coincide, so they share one
LM_SMOKE_SUMMARY = {
    "qwen3-moe-30b-a3b": {
        "proj": (
            (-0.117148442, -0.000550252851, 0.0282382807, 0.0822666727, 0.388924259,
             -0.224674039, -0.793872883, 0.0389697696, 0.433959568, 0.51915771,
             -0.0128469299, -0.241476823, -0.0490208726, -0.0266466976, -0.605400632,
             -0.480233696),
            (0.663964129, 0.881329478, 0.157902443, -0.443163184, 0.230340732,
             0.0670331402, 0.720680501, -0.0223279055, -0.154489435, -0.226651979,
             0.729356429, -0.376920398, 0.147780746, 0.279847477, -0.120271274,
             0.0773349683),
        ),
        "rms": (
            (0.494251677, 0.49950406, 0.482950711, 0.485068797, 0.532639311,
             0.479289305, 0.475329801, 0.494872744, 0.484991103, 0.497553574,
             0.510232084, 0.501918347, 0.490576344, 0.49275821, 0.544633276,
             0.525357656),
            (0.505423201, 0.466844707, 0.505242123, 0.521693953, 0.480514626,
             0.485506986, 0.482540436, 0.471623243, 0.525346483, 0.512688901,
             0.513294542, 0.517958148, 0.492890518, 0.466830775, 0.517909892,
             0.476518674),
        ),
    },
    "jamba-v0.1-52b": {
        "proj": (
            (-0.270333348, -0.29326046, -0.260595862, 0.408094891, -0.320195858,
             -0.5210965, -0.33732999, 0.915297757, -1.09547193, 0.0207930017,
             -0.0292321665, -0.527922468, -0.239111593, -0.0838048697, -0.555166661,
             0.618133514),
            (0.0607032697, 0.4252684, 0.131031977, 0.103579418, 0.4606878,
             0.261939431, 0.168539621, -0.129031589, 0.372105399, -0.689474575,
             -0.376959018, -0.0130660658, 0.0184469725, 0.260461338, -0.195535421,
             -0.357581467),
        ),
        "rms": (
            (0.497165933, 0.481797066, 0.499348369, 0.524639487, 0.460170314,
             0.501425634, 0.520731047, 0.502874117, 0.506944429, 0.477417749,
             0.512500921, 0.489613977, 0.500763946, 0.458352493, 0.509881604,
             0.500218619),
            (0.529998133, 0.517133158, 0.482172331, 0.512507052, 0.465506266,
             0.510162203, 0.496812317, 0.477397588, 0.464801383, 0.501291891,
             0.527006995, 0.47685416, 0.508574404, 0.511521894, 0.512157978,
             0.461616095),
        ),
    },
    "xlstm-1.3b": {
        "proj": (
            (0.520133246, -0.159919756, -0.0164382816, -0.167386769, -0.0606189325,
             -0.142439435, 0.560814418, -0.77864192, 0.23136343, -0.375762952,
             -0.115050996, -0.0308710522, 0.269413965, 0.1135179, -0.147814304,
             0.808293735),
            (-0.18554696, -0.0467001976, -0.0587856234, -0.335830904, 0.0656688189,
             0.560562554, -0.158627571, -0.213035068, 0.362887171, -0.387573453,
             0.61379677, 0.0647559393, 0.210316373, 0.385531148, -0.0995377259,
             -0.126130099),
        ),
        "rms": (
            (0.519977888, 0.518207731, 0.490491564, 0.513555957, 0.522105589,
             0.489336678, 0.485198872, 0.508608254, 0.490308614, 0.489485976,
             0.459640455, 0.503176664, 0.44764143, 0.466445157, 0.499949394,
             0.49125353),
            (0.493337948, 0.459056921, 0.519940567, 0.510667984, 0.474763679,
             0.471864564, 0.491539657, 0.511196981, 0.532223814, 0.498958438,
             0.458729462, 0.50293561, 0.527130047, 0.548142197, 0.466142747,
             0.486397188),
        ),
    },
    "llama-3.2-vision-11b": {
        "proj": (
            (0.104245509, 0.109116374, 0.1163327, 0.27596747, 0.0908272562,
             0.219978108, 0.539989669, 0.302391063, 0.476073064, 0.3805585,
             0.283982986, 0.644988914, 0.310766147, 0.395163899, 0.586778654,
             0.586430159),
            (0.269128722, 0.527812446, 0.377261359, 0.410043378, 0.460217541,
             0.462817887, 0.645292166, 0.260744201, 0.262716071, 0.265516604,
             0.447443089, 0.422494931, 0.377425497, 0.381870311, 0.410458152,
             0.530992875),
        ),
        "rms": (
            (0.517518687, 0.523345912, 0.513711434, 0.532649542, 0.511856757,
             0.514716411, 0.503628658, 0.507729445, 0.503215161, 0.517588891,
             0.527398205, 0.536554903, 0.51334122, 0.515945726, 0.524594664,
             0.516289785),
            (0.554483976, 0.530514082, 0.534190872, 0.545847137, 0.517870641,
             0.502987388, 0.516890769, 0.516663057, 0.51446484, 0.530857878,
             0.537791289, 0.533006633, 0.533141525, 0.546954936, 0.535277619,
             0.536019751),
        ),
    },
    "seamless-m4t-medium": {
        "proj": (
            (0.0115904277, 0.139111527, 0.0300571365, 0.498920425, 0.246342295,
             0.0334363184, 0.133102364, 0.140916656, 0.238955979, 0.617861487,
             0.363218527, 0.284702114, 0.0208914672, -0.180276205, 0.081864259,
             0.264273973),
            (-0.727942143, 0.0646790978, -0.0570322037, -0.504911055, 0.0973542395,
             -0.701142093, -0.0583423192, -0.32577383, -0.886799123, -0.628134037,
             -0.431795734, -0.565305114, -0.902866409, -0.863193781, -0.559870191,
             -0.0765864385),
        ),
        "rms": (
            (0.52160898, 0.512793604, 0.510671555, 0.505580452, 0.499230798,
             0.525771749, 0.514192985, 0.489757749, 0.548362039, 0.49622184,
             0.528685311, 0.548757099, 0.531716548, 0.551100411, 0.519622491,
             0.530753112),
            (0.509840084, 0.5164075, 0.517789159, 0.571158952, 0.496006287,
             0.503080765, 0.484338099, 0.516775924, 0.486814517, 0.515950393,
             0.552227921, 0.507492086, 0.514506666, 0.487498805, 0.502175467,
             0.510981927),
        ),
    },
}
LM_SMOKE_SUMMARY["qwen3-moe-235b-a22b"] = LM_SMOKE_SUMMARY["qwen3-moe-30b-a3b"]

# the lm_training phase (repro_torch.launch.train on the card): the paper's
# reservoir_lm at full width with its config's bf16 activations over f32
# params, 4 microbatches and remat "full", LM_TRAIN_STEPS steps of
# LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens (8 sequences a microbatch: K1 and K1ᵀ
# at [24, 512, 256], the prefill's shape), then LM_TRAIN_RESUMED more
# resumed from its checkpoint under build/ (gitignored)
LM_TRAIN_STEPS = 10
LM_TRAIN_RESUMED = 2
LM_TRAIN_BATCH = 32
LM_TRAIN_SEQ = 512
LM_TRAIN_CKPT = ROOT / "build" / "lm_train_ckpt"
# (b) every leaf's gradient through K1 and K1ᵀ against the plain route's:
# full width cut to 2 layers, B x S tokens, numpy weights (a non-zero
# readout: the config's zero readout gives K1ᵀ an exactly zero gradient at
# init, where a broken adjoint would pass)
LM_TRAIN_GRAD_LAYERS = 2
LM_TRAIN_GRAD_SHAPE = (2, 32)
LM_TRAIN_GRAD_TOL = 1e-5            # of each leaf's largest |gradient|
# (c) the f32 smoke train step on numpy weights from the JAX package's
# state (lm_train_state), LM_TRAIN_SMOKE_STEPS steps of AdamW(LM_TRAIN_OPT)
# on lm_train_batches: the JAX package's loss and grad norm a step,
# recomputed by tests/test_torch_lm_train.py; the port on the CPU is within
# 1e-6 of them
LM_TRAIN_OPT = {"lr": 3e-3, "warmup_steps": 2, "total_steps": 10}
LM_TRAIN_SMOKE_SHAPE = (2, 16)
LM_TRAIN_SMOKE_STEPS = 3
LM_TRAIN_TOL = 2e-5
LM_TRAIN_SMOKE = {"loss": (5.65335321, 5.68292475, 5.58096981),
                  "grad_norm": (1.77798784, 1.72750413, 1.75281179)}
# the adjoint scan's edge grid (phase_scan_grad_checks): N at the float4's
# and the warp's edges (1, 31-33: rows off 16 bytes, staged by 4-byte
# copies), the path's width and a long row, B of one lane and of the
# kernel's earlier 8-lane blocks' edges, every K, beta 0 (the mixer's form)
# and 0.5 (TPA saturation)
GRAD_EDGE_N = (1, 31, 32, 33, 256, 900)
GRAD_EDGE_B = (1, 33, 64)
GRAD_EDGE_K = (1, 2, 37)
GRAD_EDGE_BETA = (0.0, 0.5)
# ... then whole at the LM train step's shape (phase_lm_training's K1ᵀ: 8
# rows of a microbatch x 3 reservoir channels = 24 lanes, 512 tokens,
# N = 256) and at the largest N a block holds
GRAD_LM_BKN = (24, 512, 256)
GRAD_LIMIT_BK = (2, 2)
# f32 ops of one adjoint node step (dfr_scan_grad.cu: the chain's mul and
# add; transition4's u, compare and select, g + q, α·λ, γ·gp, m·gp; the
# summer's add)
GRAD_OPS_PER_STEP = 10


# the parallel phase (phase_parallel): reservoir_lm at full width in f32,
# PAR_STEPS steps of PAR_BATCH (rows, tokens) = 4 microbatches of 2 rows,
# one row a data rank on the (2, 1) mesh, and on the (1, 2) mesh every row
# on both ranks with the MLP and the vocab tensor-parallel over them;
# granite-8b at full width cut to PAR_GRANITE_LAYERS layers in f32,
# PAR_GRANITE_STEPS steps of PAR_BATCH (8 microbatches of one row) on
# (1, 2), its attention heads, kv heads, MLP and vocab tensor-parallel.
# Sharding changes only the order of f32 sums (each microbatch's token sums
# split over the data ranks; each row-parallel product's and the loss's
# sums split over the model ranks), so each run is held to
# PAR_SPREAD_FACTOR × the unsharded step's own spread, leaf by leaf,
# floored at PAR_PARAM_TOL of the leaf's largest |param|; losses likewise,
# floored at LM_TRAIN_TOL.  The (2, 1) run, which splits token sums, takes
# the spread under another split of them (the same steps at 8 microbatches
# of one row); the tensor-parallel runs, which reorder every product's
# sums and so every gradient upstream of them, the larger of that split's
# and the spread under a ±PAR_NUDGE relative nudge of every weight (the
# nudge of tests/test_torch_lm_train_archs.py; granite-8b's split: 4
# microbatches of two rows).  AdamW turns a gradient element at round-off
# level, or one whose microbatch sums nearly cancel, into a move of up to
# ±lr, so such elements set the spreads.
PAR_STEPS = 3
PAR_BATCH = (8, 512)
PAR_GRANITE_LAYERS = 4
PAR_GRANITE_STEPS = 2
PAR_PARAM_TOL = 1e-5
PAR_SPREAD_FACTOR = 2.0
PAR_NUDGE = 2e-7                # tests/test_torch_lm_train_archs.py's nudge
PAR_NUDGE_SEED = 99
PAR_NRMSE_TOL = 1e-4
PAR_DIR = ROOT / "build" / "parallel"
PAR_TIMEOUT_S = 300
# xlstm-1.3b at full width cut to one unit (PSERVE_XLSTM_LAYERS), f32, one
# step of PAR_XLSTM_BATCH (4 microbatches of two rows, remat "full") on
# (1, 2): the mLSTM's channels and the sLSTM's heads, columns and gated
# projection tensor-parallel.  Held as granite-8b's run is, but on its
# first moments (the step's clipped gradients times 1 - beta1, as
# tests/test_torch_parallel_train_archs.py holds them) rather than its
# params: after one step AdamW moves each element by about ±lr whatever
# its gradient's size, so a zero-initialised leaf (w_i, conv_b, the norms)
# is the sign of its gradient, and a few elements at round-off level set
# its largest gap (2.3 × the params' spread tolerance on the card, where
# the moments hold each leaf's gradient)
PAR_XLSTM_BATCH = (8, 64)
PAR_XLSTM_STEPS = 1
# GPipe on the card: reservoir_lm (``par_config``, no grad) cut into
# PIPE_STAGES stages of contiguous units over the two gloo ranks, PAR_BATCH's
# first batch cut into PIPE_MICRO microbatches (2 × 512 tokens each): every
# rank's outputs and logits bitwise one process's fold of the same
# microbatches (the same shapes, so cuBLAS and K1 take the same paths),
# PIPE_CALLS calls timed after one more
PIPE_STAGES = 2
PIPE_MICRO = 4
PIPE_CALLS = 3
# The figures of the route this phase's step replaced (the whole param tree
# gathered on every rank, every rank along "model" computing the same step,
# the full gradients all-reduced), for reservoir_lm as above, a rank each:
# from ``python -m repro_torch.launch.time_parallel --parent`` on the
# parent commit's checkout (NVIDIA H100 80GB HBM3, 700.00 W).
PAR_PR23_ROUTE = {
    "mesh_1x2": {"step_ms_p50_by_run_and_rank": [1447.035, 1403.912, 1565.121, 1590.972],
                 "peak_bytes": 2878920192, "k1_launches_calls": [96, 96],
                 "k1t_launches_calls": [48, 48],
                 "collectives_by_axis": {"all-gather": {"model": {"count": 10,
                                                                  "wire_bytes": 233289216.0},
                                                        "data": {"count": 9, "wire_bytes": 0.0}},
                                         "all-reduce": {"data": {"count": 12,
                                                                 "wire_bytes": 0.0}}}},
    "mesh_2x1": {"step_ms_p50_by_run_and_rank": [1743.483, 1743.433, 2321.899, 2321.266],
                 "peak_bytes": 2980322816, "k1_launches_calls": [96, 96],
                 "k1t_launches_calls": [48, 48],
                 "collectives_by_axis": {"all-gather": {"model": {"count": 10, "wire_bytes": 0.0},
                                                        "data": {"count": 9,
                                                                 "wire_bytes": 184137216.0}},
                                         "all-reduce": {"data": {"count": 12,
                                                                 "wire_bytes": 466578452.0}}}}}

# The DFRC pipeline over the parallel phase's (2, 1) mesh: phase_wdm's
# streamed 64-channel run and its shared readout over PDFRC_SHARED_R
# channels, the PDFRC_COMPOSED graph through Experiment and d2_l1 per WDM
# channel on phase_composed's MC probe, and the device map of SWEEP_GRID
# cut to PDFRC_SWEEP_N nodes over PDFRC_SWEEP_SAMPLES samples.  Each rank's
# results are bitwise the one process's, but where its Gram stacks are
# bitwise its block of the one process's and only the solve (cuSOLVER's
# eigh at another batch size) differs: there within PDFRC_EIGH_NRMSE_TOL.
PDFRC_SHARED_R = 8
PDFRC_COMPOSED = "d2_l2"
PDFRC_SWEEP_N = 16
PDFRC_SWEEP_SAMPLES = 300
PDFRC_RESULTS = ("nrmse", "ser", "lam", "readout_w", "y_pred")
# The one-process parity tests' NRMSE tolerance (tests/test_torch_wdm.py,
# test_torch_composed.py, test_torch_devices.py), for a rank whose solve
# alone differs from one process's.
PDFRC_EIGH_NRMSE_TOL = 1e-3


# the parallel serving phase (phase_parallel_serving): f32 throughout, so a
# rank's gap to one process is f32 summation order alone (tensor-parallel
# partial sums, another GEMM shape); it is held to twice one process's own
# row-split spread, floored at the CPU tests' logit tolerance, since a
# row-split spread of f32 GEMMs may well be 0 on the card.
PSERVE_BATCH = (8, 512)
PSERVE_DECODES = 16
PSERVE_GRANITE_LAYERS = 4
# xlstm-1.3b at full width cut to one unit (7 mLSTM + 1 sLSTM blocks), its
# sLSTM's r_rec drawn at 1/sqrt(head_dim) as lm_arch_cell draws it; its
# tolerance also takes one process's spread under the ±PAR_NUDGE weight
# nudge (tensor parallelism reorders every row-parallel product's sums)
PSERVE_XLSTM_LAYERS = 8
PSERVE_NUDGED = ("xlstm-1.3b",)
PSERVE_SEED = 0
PSERVE_TOL_FLOOR = 1e-5
PSERVE_DIR = ROOT / "build" / "parallel_serving"
PSERVE_TIMEOUT_S = 300


_T_START = time.perf_counter()
# In a side process (``side_main``): the records ``emit`` keeps for the
# parent, which prints them when it joins the side process.
_SIDE_RECORDS: list | None = None
# The longest a side process may take (the device map ≈ 170 s, the kernel
# checks and the contracts ≈ 170 s, each beside the others).
SIDE_TIMEOUT_S = 600


def emit(obj) -> None:
    if _SIDE_RECORDS is not None:
        _SIDE_RECORDS.append(obj)
        return
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T_START}
    print(json.dumps(obj), flush=True)


def side_main(name: str, args: tuple, results) -> None:
    """A side process: phase ``name`` (a function of this script) on the
    card with ``args`` after the device, its records kept for the parent;
    puts (ok, the phase's result or the traceback, records) on
    ``results``."""
    import traceback

    import torch

    global _SIDE_RECORDS
    _SIDE_RECORDS = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = globals()[name](torch.device("cuda", 0), *args)
    except BaseException:
        results.put((False, traceback.format_exc(), _SIDE_RECORDS))
    else:
        results.put((True, out, _SIDE_RECORDS))


def start_side(name: str, *args):
    """Start phase ``name`` in a spawned process of its own (``side_main``),
    beside the phases this one runs; ``join_sides`` ends it."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=side_main, args=(name, args, results), daemon=True)
    proc.start()
    return name, proc, results, time.perf_counter()


def join_sides(sides) -> list:
    """Wait for each side process (at most SIDE_TIMEOUT_S from its start),
    print its records, end it; return their phases' results, or fail if a
    phase failed or timed out (after every side process has ended)."""
    import queue

    outs, errors = [], []
    for name, proc, results, t0 in sides:
        try:
            while True:
                try:
                    ok, out, records = results.get(timeout=5)
                    break
                except queue.Empty:
                    if not proc.is_alive():
                        ok, out, records = False, f"exited ({proc.exitcode}) with no result", []
                        break
                    if time.perf_counter() - t0 > SIDE_TIMEOUT_S:
                        ok, out, records = False, f"timed out after {SIDE_TIMEOUT_S} s", []
                        break
        finally:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
            results.close()
        for obj in records:
            emit({**obj, "side_joined_after_s": time.perf_counter() - t0} if "phase" in obj
                 else obj)
        outs.append(out)
        if not ok:
            errors.append(f"{name} in its side process:\n{out}")
    check(not errors, "\n".join(errors))
    return outs


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def stack(datasets):
    import numpy as np

    return tuple(np.stack([getattr(d, f) for d in datasets])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, host seconds) of ``fn`` ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sm_clocks_mhz() -> dict:
    """The SM clock now and its maximum, in MHz (nvidia-smi)."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    now, top = (float(v) for v in line.split(","))
    return {"now": now, "max": top}


def chain_cycles(dev) -> dict:
    """Cycles a step of dependent chains on register values, one thread,
    CHAIN_PROBE_STEPS steps between two clock64() reads (the scan kernel's
    ``dfr_scan_chain_probe``), the least of three runs: ``kernel_step`` is
    SiliconMR's chain step as the scan kernel computes it, ``f32_op`` one
    dependent f32 add, ``cmt_step`` the CMT cavity's chain step (the
    ``cmt_model()`` constants, n_substeps substeps), ``mg_step``
    MackeyGlass's chain step (its mul and add), ``grad_step`` the adjoint
    scan's (K1ᵀ: its mul and add); ``least_step`` is CHAIN_OPS of
    ``f32_op``."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.core import MackeyGlass
    from repro_torch.kernels import _build
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    fn = _build.load("dfr_scan").dfr_scan_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(3)
    # 8 inputs u, 8 chain-free values, s0, then the 16 constants
    u = rng.uniform(0, 1, 8)
    heads = {0: np.concatenate([u, rng.uniform(0.05, 0.4, 8), [0.1]])}
    heads[1] = heads[0]
    # the CMT form: u = j·m with a {0, 1} mask, its drive u + γ·s(t−τ)
    u_cmt = u * (np.arange(8) % 2)
    heads[2] = np.concatenate([u_cmt, u_cmt + 0.9 * rng.uniform(0, 0.5, 8), [0.1]])
    heads[3] = heads[4] = heads[0]
    consts = {0: [0.632], 1: [0.632], 2: list(cmt_model().kernel_spec()[1]),
              3: list(MackeyGlass().kernel_spec()[1]), 4: [0.632]}
    last = torch.empty(1, dtype=torch.float32, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for form, name in ((0, "kernel_step"), (1, "f32_op"), (2, "cmt_step"), (3, "mg_step"),
                       (4, "grad_step")):
        p = consts[form] + [0.0] * (scan_ops.MAX_PARAMS - len(consts[form]))
        x = torch.as_tensor(np.concatenate([heads[form], p]), dtype=torch.float32, device=dev)
        runs = []
        for _ in range(3):
            _build.check(fn(form, x.data_ptr(), last.data_ptr(), cyc.data_ptr(),
                            CHAIN_PROBE_STEPS, stream), "dfr_scan_chain_probe")
            torch.cuda.synchronize(dev)
            check(bool(torch.isfinite(last).all()), f"chain probe {name}: state not finite")
            runs.append(int(cyc.item()) / CHAIN_PROBE_STEPS)
        res[name] = min(runs)
    res["least_step"] = CHAIN_OPS * res["f32_op"]
    return res


def cmt_ops_per_step(m: int) -> int:
    """f32 ops of one CMT node step at ``m`` substeps, as free_part<CMT> and
    chain<CMT> compute it (expf, expm1f and a division one op each): the
    masked input and the drive (4); the branch's compare, two selects and
    the clamp of E (4); the closure of N and T (4); each substep 29 — δ (4),
    the Lorentzian (3), r (4), x (1), φ₁ (9: compare, two selects, two
    negations, expm1f, division, the guard's mul and sub), e^-x (2), the
    pump and E (6) — and after all but the last, pw·E, N and T (10)."""
    return 12 + 29 * m + 10 * (m - 1)


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bit patterns (f32 or bf16; a NaN or an inf
    state compares as its bits)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(view), b.view(view))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def reset_counts() -> None:
    """Set every kernel wrapper's launch and call counts to 0."""
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.readout_apply import ops as apply_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops

    for wrapper in (scan_ops.dfr_scan, scan_ops.dfr_scan_grad, gram_ops.gram_accumulate_batched,
                    gram_ops.gram_accumulate_batched_into, copy_ops.block_copy,
                    apply_ops.readout_apply):
        wrapper.launches = wrapper.calls = 0


def launch_counts() -> tuple[int, int, int]:
    """(K1 dfr_scan, K2 ridge_gram, K3 ridge_gram_into) launches so far."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops

    return (scan_ops.dfr_scan.launches, gram_ops.gram_accumulate_batched.launches,
            gram_ops.gram_accumulate_batched_into.launches)


def readout_launches() -> int:
    """Launches of the readout-apply kernel so far."""
    from repro_torch.kernels.readout_apply import ops as apply_ops

    return apply_ops.readout_apply.launches


@contextlib.contextmanager
def solved_grams():
    """Record a copy of every (G, c, ‖y‖², sample count) the pipeline hands
    its GCV solve."""
    from repro_torch.pipeline import ridge

    seen = []
    solve = ridge.solve_gcv

    def spy(g, c, y2, n_samples, lambdas):
        seen.append((g.clone(), c.clone(), y2.clone(), n_samples))
        return solve(g, c, y2, n_samples, lambdas)

    ridge.solve_gcv = spy
    try:
        yield seen
    finally:
        ridge.solve_gcv = solve


def lm_numpy_params(cfg, seed: int) -> dict:
    """Weights of the LM ``cfg`` in the JAX package's params layout
    ({"embed", "units": (a dict a unit position, stacked over units),
    "final_norm"}, and an encoder-decoder's {"encoder": {"units",
    "final_norm"}} drawn after them) as numpy f32 arrays drawn at ``seed``:
    a matrix leaf normal times 1/sqrt(its fan-in), a vector leaf normal
    times 0.1.  No leaf is zero, the reservoir readout, the norm scales and
    the cross-attention gate included (they initialise at zero, where the
    gate's tanh silences its block), so a broken mixer or norm shows in
    the logits."""
    import math

    import numpy as np

    from repro_torch.models import layers
    from repro_torch.models.model import _ENCODER_BLOCK, _block_defs

    rng = np.random.default_rng(seed)

    def draw(defs, lead=()):
        out = {}
        for name, (shape, _axes, _init) in sorted(defs.items()):
            scale = 1.0 / math.sqrt(shape[0]) if len(shape) >= 2 else 0.1
            out[name] = rng.standard_normal((*lead, *shape), dtype=np.float32) * np.float32(scale)
        return out

    params = {"embed": draw(layers.embed_defs(cfg)),
              "units": tuple(draw(_block_defs(cfg, blk), (cfg.n_units,)) for blk in cfg.unit),
              "final_norm": draw(layers.norm_defs(cfg))}
    if cfg.n_encoder_layers:
        params["encoder"] = {
            "units": (draw(_block_defs(cfg, _ENCODER_BLOCK), (cfg.n_encoder_layers,)),),
            "final_norm": draw(layers.norm_defs(cfg))}
    return params


def lm_tokens(cfg, shape, seed: int):
    """Token ids of ``shape`` drawn with numpy at ``seed``."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def lm_context(cfg, b: int, seed: int):
    """The stub context of a cross-attention family, [B, n_context_tokens,
    d_model] f32 drawn with numpy at ``seed`` (its frontend is a stub in
    the reference too), else None."""
    import numpy as np

    if not cfg.n_context_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_context_tokens, cfg.d_model), dtype=np.float32)


def lm_logit_summary(logits) -> dict:
    """A host summary of logits [B, S, V] (numpy, f32): each position's
    logits projected on a fixed unit-scale vector drawn at LM_PROJ_SEED,
    and their root mean square, each [B, S] as nested lists."""
    import numpy as np

    x = np.asarray(logits, dtype=np.float64)
    r = np.random.default_rng(LM_PROJ_SEED).standard_normal(x.shape[-1]) / np.sqrt(x.shape[-1])
    return {"proj": (x @ r).tolist(), "rms": np.sqrt((x * x).mean(-1)).tolist()}


def summary_gap(a: dict, b: dict) -> float:
    """The largest gap between two logit summaries."""
    import numpy as np

    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in a)


def lm_train_state(params: dict) -> dict:
    """A train state in the JAX package's layout ({"params", "opt": {"m",
    "v"}, "step"}) around numpy ``params``: zero f32 moments, step 0."""
    import numpy as np

    def zeros(node):
        if isinstance(node, dict):
            return {k: zeros(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(zeros(v) for v in node)
        return np.zeros(node.shape, np.float32)

    return {"params": params, "opt": {"m": zeros(params), "v": zeros(params)},
            "step": np.zeros((), np.int32)}


def lm_train_batches(cfg, n_steps: int, shape, seed: int) -> list[dict]:
    """``n_steps`` batches {"tokens", "labels"} of ``shape`` [B, S], int32,
    drawn with numpy at ``seed``: each a row of S + 1 tokens, shifted."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        toks = rng.integers(0, cfg.vocab_size, (shape[0], shape[1] + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def lm_smoke_train(dev) -> dict:
    """reservoir_lm's smoke config (f32) trained LM_TRAIN_SMOKE_STEPS steps
    on the card from the numpy weights: each step's loss and grad norm."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import train_step

    cfg = smoke_config("reservoir_lm")
    state = convert.train_state_from_reference(lm_train_state(lm_numpy_params(cfg, LM_SEED)),
                                               device=dev)
    out = {"loss": [], "grad_norm": []}
    for batch in lm_train_batches(cfg, LM_TRAIN_SMOKE_STEPS, LM_TRAIN_SMOKE_SHAPE,
                                  LM_TOKENS_SEED):
        state, metrics = train_step(cfg, AdamWConfig(**LM_TRAIN_OPT), state,
                                    {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        for k in out:
            out[k].append(float(metrics[k]))
    return out


def phase_build(card: str) -> None:
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in r["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "card": card, "seconds": seconds,
          "per_source_seconds": {n: r["seconds"] for n, r in report.items()},
          "cached": {n: r["cached"] for n, r in report.items()}, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})


def cmt_model(**kw):
    """The reference's CMT pipeline model, calibrated_twin(SiliconMR(),
    power_mw=CMT_POWER_MW); ``kw`` overrides fields (``power_mw=0.0`` is the
    calibrated twin itself)."""
    from repro_torch.core import SiliconMR
    from repro_torch.devices import calibrated_twin

    return calibrated_twin(SiliconMR(), **{"power_mw": CMT_POWER_MW, **kw})


def scan_models():
    """(name, model, mask levels, tolerance vs the plain version, relative?)
    for every form the scan kernel inlines, MZISine last.  SiliconMR (with
    and without TPA) runs the plain version's separately rounded IEEE ops
    (the TPA division is __fdiv_rn in the kernel, an IEEE division in
    torch): exact.  Literal runs the same ops, but its states grow
    geometrically (the printed Eq. (6-7) is unstable), so its bound is
    relative to the largest state.  MackeyGlass and MZISine call powf/sinf
    in the kernel and torch's pow/sin in the plain version: libm ulp
    differences carried through the recurrence -> 1e-5.  The CMT cavity
    calls expf/expm1f in the kernel and torch's exp/expm1 in the plain
    version: 1e-5, the bound of the reference's own kernel == ref test
    (tests/test_devices.py:124); the kernels line reports whether it is
    exact."""
    from repro_torch.core import MackeyGlass, MZISine, SiliconMR, SiliconMRLiteral

    return (("SiliconMR", SiliconMR(), (0.0, 1.0), 0.0, False),
            ("SiliconMR_tpa", SiliconMR(beta_tpa=0.5), (0.0, 1.0), 0.0, False),
            ("SiliconMRLiteral", SiliconMRLiteral(), (0.0, 1.0), 1e-5, True),
            ("MackeyGlass", MackeyGlass(), (-1.0, 1.0), 1e-5, False),
            ("MRCavityCMT", cmt_model(), (0.0, 1.0), 1e-5, False),
            ("MZISine", MZISine(), (0.0, 1.0), 1e-5, False))


def scan_edge_cases(per_lane: bool, cmt: bool = False):
    """(B, K, N) of the scan kernel's edge grid for one mask mode: every N of
    SCAN_EDGE_N and the largest N the block layout takes, each with every B
    of SCAN_EDGE_B; K cycles through SCAN_EDGE_K (only 1 and 2 above N =
    100, where the plain version's node loop is longest).  For the CMT form
    (``cmt``), whose plain version issues ≈ 170 ops a node: the cases up to
    N = 100, then N = 900 and the largest N at K = 1 and B = 65."""
    from repro_torch.kernels.dfr_scan import ops

    cases = []
    for a, n in enumerate((*SCAN_EDGE_N, ops.max_nodes(per_lane))):
        ks = SCAN_EDGE_K if n <= 100 else SCAN_EDGE_K[:2]
        for c, b in enumerate(SCAN_EDGE_B):
            cases.append((b, ks[(a + c) % len(ks)], n))
    if cmt:
        cases = [c for c in cases if c[2] <= 100]
        cases += [(SCAN_EDGE_B[-1], 1, n) for n in (900, ops.max_nodes(per_lane))]
    return cases


def scan_edge_check(dev, model, levels, tol, relative, b, k, n, per_lane, seed) -> float:
    """The scan kernel on one edge case: states and carry vs the plain
    version within ``tol`` (× the largest state if ``relative``); bf16
    states equal the f32 states rounded, with the same f32 carry, bitwise;
    the scan resumed from its carry at an uneven split equals one call
    bitwise; one launch a call.  MackeyGlass, which runs the helper-warp
    route, is also held bitwise to the chain kernel's MackeyGlass route
    (``dfr_scan_at`` under ``scan_layout``): f32 and bf16 states and the
    carry, as int patterns.  Returns the error vs the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels.dfr_scan import ops

    rng = np.random.default_rng(seed)
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.choice(levels, (b, n) if per_lane else (n,)),
                           dtype=torch.float32, device=dev)
    what = f"{model!r} B={b} K={k} N={n} {'per-lane' if per_lane else 'broadcast'}"
    before = ops.dfr_scan.launches
    out, fin = ops.dfr_scan(model, j, mask, s0, return_final=True)
    check(ops.dfr_scan.launches == before + 1, f"{what}: not one launch")
    ref, ref_fin = ops.dfr_scan_plain(model, j, mask, s0)
    err = max(max_err(out, ref), max_err(fin, ref_fin))
    scale = max(1.0, float(ref.abs().max())) if relative else 1.0
    check(err <= tol * scale, f"{what}: scan vs plain {err} > {tol} x {scale}")
    out16, fin16 = ops.dfr_scan(model, j, mask, s0, out_dtype=torch.bfloat16, return_final=True)
    check(torch.equal(out16, out.to(torch.bfloat16)) and torch.equal(fin16, fin),
          f"{what}: bf16 states are not the f32 states rounded")
    if ops.scan_route(model) == "helpers" and n <= ops.max_nodes(per_lane):
        chain_layout = ops.scan_layout(b, n, per_lane)
        for got, dtype in (((out, fin), torch.float32), ((out16, fin16), torch.bfloat16)):
            want = ops.dfr_scan_at(model, j, mask, s0, chain_layout, out_dtype=dtype)
            check(all(same_bits(x, y) for x, y in zip(got, want)),
                  f"{what}: the helper-warp route is not the chain route bitwise ({dtype})")
    if k > 1:
        cut = k // 3 + 1
        st1, f1 = ops.dfr_scan(model, j[:, :cut], mask, s0, return_final=True)
        st2, f2 = ops.dfr_scan(model, j[:, cut:], mask, f1, return_final=True)
        check(torch.equal(torch.cat([st1, st2], dim=1), out) and torch.equal(f2, fin),
              f"{what}: chunk resume at {cut} is not bitwise")
    return err / scale


def phase_scan_checks(dev) -> None:
    """The scan kernel vs its plain version for every form it inlines at
    the main width (B = 64, N = 900, K = 32; the CMT form K = CMT_CHECK_K)
    with per-lane masks and bf16 states (the edge grid is
    ``phase_scan_edge_grid``)."""
    import numpy as np
    import torch

    from repro_torch.core import SiliconMR, make_mask
    from repro_torch.kernels.dfr_scan import ops

    rng = np.random.default_rng(0)
    b, k, n = B_MAIN, 32, main_point().n_nodes
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
    results = {}
    for name, model, levels, tol, relative in scan_models():
        km = CMT_CHECK_K if name == "MRCavityCMT" else k
        jm, cut = j[:, :km], min(13, km // 2)
        mask = make_mask(n, levels=levels, seed=1, device=dev)
        out, fin = ops.dfr_scan(model, jm, mask, s0, return_final=True)
        ref, ref_fin = ops.dfr_scan_plain(model, jm, mask, s0)
        err = max(max_err(out, ref), max_err(fin, ref_fin))
        scale = max(1.0, float(ref.abs().max())) if relative else 1.0
        check(bool(torch.isfinite(out).all()), f"{model!r} states finite")
        check(err <= tol * scale, f"{model!r} scan vs plain {err} > {tol} x {scale}")
        # bitwise chunk resume: fin of one call as s0 of the next
        st1, f1 = ops.dfr_scan(model, jm[:, :cut], mask, s0, return_final=True)
        st2, f2 = ops.dfr_scan(model, jm[:, cut:], mask, f1, return_final=True)
        check(torch.equal(torch.cat([st1, st2], dim=1), out) and torch.equal(f2, fin),
              f"{model!r} chunk resume is not bitwise")
        results[name] = {"K": km, "max_abs_err": err, "state_scale": scale}
    mr, mask = SiliconMR(), make_mask(n, seed=1, device=dev)
    out16 = ops.dfr_scan(mr, j, mask, s0, out_dtype=torch.bfloat16)
    ref = ops.dfr_scan_plain(mr, j, mask, s0)[0]
    err16 = max_err(out16, ref)
    check(out16.dtype == torch.bfloat16 and err16 <= 4e-2, f"bf16 states err {err16}")
    masks = torch.stack([make_mask(n, seed=s, device=dev) for s in range(1, b + 1)])
    lane = ops.dfr_scan(mr, j, masks, s0)
    err_lane = max_err(lane, ops.dfr_scan_plain(mr, j, masks, s0)[0])
    check(err_lane == 0.0, f"per-lane mask err {err_lane}")
    emit({"phase": "kernel_checks", "kernel": "dfr_scan", "shape_bkn": [b, k, n],
          "by_model": results, "bf16_states_err": err16,
          "per_lane_mask_err": err_lane, "chunk_resume_bitwise": True})


def phase_scan_edge_grid(dev) -> None:
    """The scan kernel vs its plain version on the edge grid of its block
    layout (``scan_edge_cases``: N at the float4 group's and the warp's
    edges, the largest N, B at the 8-lane block's edges, K = 1, 2, 37 in
    turn; fewer for the CMT form), in both mask modes, MackeyGlass's
    helper-warp route also bitwise the chain kernel's MackeyGlass route;
    MZISine one node above the chain kernel's node limit, where SiliconMR
    raises; MackeyGlass at its own route's node limit (K = 1), and one node
    above it, where it raises."""
    import torch

    from repro_torch.kernels.dfr_scan import ops

    t0 = time.perf_counter()
    grid, cases = {}, 0
    for per_lane in (False, True):
        for name, model, levels, tol, relative in scan_models():
            edges = scan_edge_cases(per_lane, cmt=name == "MRCavityCMT")
            errs = [scan_edge_check(dev, model, levels, tol, relative, eb, ek, en, per_lane,
                                    seed=cases + i) for i, (eb, ek, en) in enumerate(edges)]
            cases += len(edges)
            grid[f"{name} {'per-lane' if per_lane else 'broadcast'}"] = max(errs)
    # MZISine's kernel keeps no rows in shared memory: no node limit
    above = {}
    for per_lane in (False, True):
        n_above = ops.max_nodes(per_lane) + 1
        name, model, levels, tol, relative = scan_models()[-1]
        above[f"{name} {'per-lane' if per_lane else 'broadcast'}"] = scan_edge_check(
            dev, model, levels, tol, relative, 33, 2, n_above, per_lane, seed=cases)
        cases += 1
        z = torch.zeros((33, n_above), device=dev)
        try:
            ops.dfr_scan(scan_models()[0][1], z[:, :2], z if per_lane else z[0], z)
        except ValueError:
            pass
        else:
            check(False, f"SiliconMR at N = {n_above} did not raise")
    # MackeyGlass's helper-warp route keeps fewer rows a lane than the chain
    # kernel: its own node limit
    mg_top = {}
    name, model, levels, tol, relative = next(m for m in scan_models() if m[0] == "MackeyGlass")
    for per_lane in (False, True):
        n_top = ops.max_helper_nodes(per_lane)
        mg_top[f"{'per-lane' if per_lane else 'broadcast'}"] = {"N": n_top, "err": scan_edge_check(
            dev, model, levels, tol, relative, 33, 1, n_top, per_lane, seed=cases)}
        cases += 1
        z = torch.zeros((2, n_top + 1), device=dev)
        try:
            ops.dfr_scan(model, z[:, :1], z if per_lane else z[0], z)
        except ValueError:
            pass
        else:
            check(False, f"MackeyGlass at N = {n_top + 1} did not raise")
    emit({"phase": "kernel_checks", "kernel": "dfr_scan", "edge_grid": {
              "N": [*SCAN_EDGE_N, "max"], "max_nodes": {"broadcast": ops.max_nodes(False),
                                                        "per_lane": ops.max_nodes(True)},
              "B": SCAN_EDGE_B, "K": SCAN_EDGE_K, "cases": cases,
              "max_err_vs_plain_by_form": grid, "mzi_above_node_limit": above,
              "mg_helper_route_node_limit": mg_top, "mg_helper_route_is_chain_route_bitwise": True,
              "bf16_is_f32_rounded_bitwise": True,
              "resume_bitwise": True, "seconds": time.perf_counter() - t0}})


def phase_scan_grad_checks(dev) -> None:
    """The adjoint scan K1ᵀ against its plain version on the edge grid of
    its block layout (every N of GRAD_EDGE_N × B of GRAD_EDGE_B × K of
    GRAD_EDGE_K × beta of GRAD_EDGE_BETA), then at the LM's whole train-step
    shape GRAD_LM_BKN (beta 0, the mixer's form: its plain version takes
    ≈ 10 s there; tests/test_torch_cuda.py also holds beta 0.5 there) and
    at the largest N its block holds
    (GRAD_LIMIT_BK), from K1's own f32 states with a non-zero gradient of
    the final state: dj and ds0 bitwise, one launch a call; each case's
    block layout reported; the forms it does not cover raise on the card."""
    import numpy as np
    import torch

    from repro_torch.core import MackeyGlass, SiliconMR
    from repro_torch.kernels.dfr_scan import ops

    t0 = time.perf_counter()
    cases, worst, layouts = 0, 0.0, {}

    def case(b, k, n, beta, seed):
        rng = np.random.default_rng(seed)
        model = SiliconMR(beta_tpa=beta)
        j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
        s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32, device=dev)
        mask = torch.as_tensor(rng.choice((0.0, 1.0), n), dtype=torch.float32, device=dev)
        # K1's own states; its plain version's above K1's node limit (below K1ᵀ's)
        states = (ops.dfr_scan(model, j, mask, s0) if n <= ops.max_nodes(False)
                  else ops.dfr_scan_plain(model, j, mask, s0)[0])
        g = torch.as_tensor(rng.standard_normal((b, k, n)), dtype=torch.float32, device=dev)
        g_fin = torch.as_tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)
        what = f"K1ᵀ B={b} K={k} N={n} beta={beta}"
        before = ops.dfr_scan_grad.launches
        dj, ds0 = ops.dfr_scan_grad(model, j, mask, s0, states, g, g_fin)
        check(ops.dfr_scan_grad.launches == before + 1, f"{what}: not one launch")
        pj, ps = ops.dfr_scan_grad_plain(model, j, mask, s0, states, g, g_fin)
        check(same_bits(dj, pj) and same_bits(ds0, ps),
              f"{what}: vs plain {max_err(dj, pj)}, {max_err(ds0, ps)}")
        layouts[f"{b}x{n}"] = ops.grad_layout(b, n)._asdict()
        return max(max_err(dj, pj), max_err(ds0, ps))

    for n in GRAD_EDGE_N:
        for b in GRAD_EDGE_B:
            for k in GRAD_EDGE_K:
                for beta in GRAD_EDGE_BETA:
                    worst = max(worst, case(b, k, n, beta, cases))
                    cases += 1
    t_grid = time.perf_counter() - t0
    lm_b, lm_k, lm_n = GRAD_LM_BKN
    worst = max(worst, case(lm_b, lm_k, lm_n, 0.0, 1000))
    limit_b, limit_k = GRAD_LIMIT_BK
    worst = max(worst, case(limit_b, limit_k, ops.max_grad_nodes(), 0.0, 2000))
    j2, s2, st = (torch.zeros(shape, device=dev) for shape in ((2, 2), (2, 3), (2, 2, 3)))
    raised = {}
    for name, model, mask in (("MackeyGlass", MackeyGlass(), s2[0]),
                              ("per-lane mask", SiliconMR(), s2)):
        try:
            ops.dfr_scan_grad(model, j2, mask, s2, st, st, s2)
        except NotImplementedError as err:
            raised[name] = str(err)
        else:
            check(False, f"K1ᵀ took {name}")
    emit({"phase": "kernel_checks", "kernel": "dfr_scan_grad", "edge_grid": {
              "N": GRAD_EDGE_N, "B": GRAD_EDGE_B, "K": GRAD_EDGE_K, "beta": GRAD_EDGE_BETA,
              "cases": cases, "bitwise_vs_plain": True, "max_abs_err": worst,
              "max_nodes": ops.max_grad_nodes(), "raised": raised, "grid_seconds": t_grid,
              "lm_shape_bkn": list(GRAD_LM_BKN), "lm_shape_beta": 0.0,
              "node_limit_bkn": [limit_b, limit_k, ops.max_grad_nodes()],
              "layouts": layouts, "seconds": time.perf_counter() - t0}})


def phase_gram_checks(dev) -> None:
    """The Gram kernel vs its plain version on the edges of its triangle
    grid: F ∈ {1, 63, 64, 65, 901} (the 64-wide tile's edges), C ∈ {1, 128},
    a ragged T, f32 and bf16 X, each at B = 2 and at a B whose triangle
    grid gives every SM 4 blocks (the two thread layouts of the kernel).
    K2's G equals its transpose bitwise; K3 from a non-symmetric G0 gives
    G0 + XᵀX (rtol 1e-5, atol 1e-4: f32 sums in another order); K3 over
    the uneven split (0, 100), (100, 101), (101, T) equals one shot
    bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels.ridge_gram import ops

    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t = 517
    errs, cases = {}, 0
    for f in (1, 63, 64, 65, 901):
        tiles = -(-f // 64)
        for b in (2, 4 * sms // (tiles * (tiles + 1) // 2) + 1):
            for c in (1, 128):
                x = torch.as_tensor(rng.standard_normal((b, t, f)), dtype=torch.float32,
                                    device=dev)
                y = torch.as_tensor(rng.standard_normal((b, t, c)), dtype=torch.float32,
                                    device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    xd = x.to(dtype)
                    what = f"F={f} B={b} C={c} {dtype}"
                    g, m = ops.gram_accumulate_batched(xd, y)
                    gp, mp = ops.gram_plain_batched(xd, y)
                    for name, a, r in (("G", g, gp), ("c", m, mp)):
                        check(torch.allclose(a, r, rtol=1e-5, atol=1e-4),
                              f"gram {name} {what} vs plain: {max_err(a, r)}")
                    check(torch.equal(g, g.mT), f"K2 G not symmetric bitwise ({what})")
                    g0 = torch.rand((b, f, f), dtype=torch.float32, device=dev)
                    c0 = torch.rand((b, f, c), dtype=torch.float32, device=dev)
                    gi, ci = ops.gram_accumulate_batched_into(g0.clone(), c0.clone(), xd, y)
                    gq, cq = ops.gram_plain_batched(xd, y, g0=g0.clone(), c0=c0.clone())
                    check(torch.allclose(gi, gq, rtol=1e-5, atol=1e-4)
                          and torch.allclose(ci, cq, rtol=1e-5, atol=1e-4),
                          f"K3 from a non-symmetric G0 ({what}): {max_err(gi, gq)}")
                    gs, cs = torch.zeros_like(g), torch.zeros_like(m)
                    for lo, hi in ((0, 100), (100, 101), (101, t)):
                        ops.gram_accumulate_batched_into(gs, cs, xd[:, lo:hi], y[:, lo:hi])
                    check(torch.equal(gs, g) and torch.equal(cs, m),
                          f"accumulate-into over an uneven split != one shot ({what})")
                    errs[what] = max(max_err(g, gp), max_err(m, mp), max_err(gi, gq))
                    cases += 1
                del x, y
    emit({"phase": "kernel_checks", "kernel": "ridge_gram", "T": t, "cases": cases,
          "max_abs_err_vs_plain": max(errs.values()), "k2_symmetric_bitwise": True,
          "into_nonsymmetric_g0_ok": True, "into_equals_one_shot_bitwise": True})


def main_inputs(tasks, n_seeds: int):
    narma = stack([tasks.narma10(2000, seed=s) for s in range(n_seeds)])
    chan = stack([tasks.channel_equalization(9000, seed=s) for s in range(n_seeds)])
    return narma, chan


def phase_main_path(dev, narma, chan, card: str) -> dict:
    """The paper's claims path at full width, through the kernels."""
    import numpy as np

    from repro_torch.pipeline import Experiment, ExperimentConfig

    cfg = dataclasses.replace(ExperimentConfig.from_dfrc(main_point()), state_method="kernel",
                              readout_use_kernel=True)
    exp = Experiment(cfg, device=dev)

    reset_counts()
    res, first_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()
    check(launches == (2, 1, 0), f"NARMA10 launches (scan, gram, into) = {launches}")
    check(bool(np.all(np.isfinite(res.nrmse))), "NARMA10 NRMSE finite")
    check(res.y_pred.shape == (B_MAIN, 1000), f"y_pred shape {res.y_pred.shape}")
    check(bool(np.all(res.nrmse < 0.72)), f"NARMA10 NRMSE per instance {res.nrmse}")
    check(float(res.nrmse.mean()) < 0.65, f"NARMA10 mean NRMSE {res.nrmse.mean()}")
    _, second_s = wall(lambda: exp.run(*narma))
    emit({"phase": "main_path", "task": "narma10", "card": card, "B": B_MAIN, "N": cfg.n_nodes,
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "nrmse_mean": float(res.nrmse.mean()), "nrmse_max": float(res.nrmse.max()),
          "nrmse_min": float(res.nrmse.min()),
          "lam_counts": {str(v): int(c) for v, c in zip(*np.unique(res.lam, return_counts=True))},
          "run_wall_s_first": first_s, "run_wall_s_second": second_s})

    # Channel equalisation at the paper's N = 30 (quantized 4-PAM output).
    # Asserted with the SVD readout; the Gram/eigh readout is reported too:
    # it misses the band in the JAX package as well, with the same SERs on
    # the same states (tests/test_torch_experiment.py::
    # test_chan_eq_paper_point_readouts_match_reference).
    chan_out = {}
    for use_kernel in (False, True):
        ccfg = dataclasses.replace(ExperimentConfig.from_dfrc(main_point("channel_eq")),
                                   state_method="kernel", readout_use_kernel=use_kernel)
        reset_counts()
        cres, cs = wall(lambda: Experiment(ccfg, device=dev).run(*chan))
        claunch = launch_counts()
        check(claunch == (2, int(use_kernel), 0), f"chan-eq launches {claunch}")
        check(set(np.unique(cres.y_pred)) <= {-3.0, -1.0, 1.0, 3.0}, "chan-eq symbols")
        if not use_kernel:
            check(bool(np.all(cres.ser < 0.16)), f"chan-eq SER per instance {cres.ser}")
            check(float(cres.ser.mean()) < 0.13, f"chan-eq mean SER {cres.ser.mean()}")
        chan_out["gram_eigh" if use_kernel else "svd"] = {
            "ser_mean": float(cres.ser.mean()), "ser_max": float(cres.ser.max()),
            "launches": {"dfr_scan": claunch[0], "ridge_gram": claunch[1]}, "wall_s": cs}
    emit({"phase": "main_path", "task": "channel_equalization", "card": card, "B": B_MAIN,
          "N": 30, "snr_db": 24.0, "asserted": "svd", "readouts": chan_out})
    return {"cfg": cfg, "exp": exp, "launches": launches}


def phase_stages(dev, narma, exp, card: str) -> None:
    """Stage breakdown of one more ``Experiment.run`` of the main path,
    recorded by the pipeline's own stage marks (host clock, a device
    synchronise at each mark)."""
    import numpy as np

    from repro_torch.pipeline import record_stages

    reset_counts()
    with record_stages() as stages:
        res, run_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()[:2]
    check(launches == (2, 1), f"timed run launches (scan, gram) = {launches}")
    check(bool(np.all(res.nrmse < 0.72)), f"timed run NRMSE {res.nrmse}")
    emit({"phase": "stages", "task": "narma10", "card": card, "B": B_MAIN,
          "N": exp.config.n_nodes,
          "wall_s": stages, "run_wall_s": run_s,
          "unmarked_s": run_s - sum(stages.values()),
          "nrmse_mean": float(res.nrmse.mean())})


def phase_parity(dev, tasks) -> None:
    """Kernel path vs the ref path and the SVD readout, N = 32, noise off.

    The states paths must agree to 1e-3 under either readout.  The Gram
    (eigh) readout vs the SVD readout is held to 5e-3, the reference's own
    bound (tests/test_pipeline.py::test_readout_kernel_path_agrees): on
    these eight seeds the JAX package's two readouts differ by more than
    1e-3 themselves (cond(X) squared in the Gram; shown on CPU by
    tests/test_torch_experiment.py::test_gram_vs_svd_readout_gap_is_the_references_own).
    """
    import numpy as np

    from repro_torch.core import SiliconMR
    from repro_torch.pipeline import Experiment, ExperimentConfig

    batch = stack([tasks.narma10(360, seed=s) for s in range(8)])
    runs = {}
    for method in ("kernel", "ref"):
        for readout in ("gram", "svd"):
            cfg = ExperimentConfig(model=SiliconMR(), n_nodes=32, washout=40, ridge_l2=(1e-4,),
                                   state_noise_rel=0.0, state_method=method,
                                   readout_use_kernel=readout == "gram")
            runs[(method, readout)] = Experiment(cfg, device=dev).run(*batch).nrmse

    def diff(a, b):
        return float(np.abs(runs[a] - runs[b]).max())

    diffs = {"kernel_vs_ref_states_gram": diff(("kernel", "gram"), ("ref", "gram")),
             "kernel_vs_ref_states_svd": diff(("kernel", "svd"), ("ref", "svd")),
             "gram_vs_svd_readout": diff(("kernel", "gram"), ("kernel", "svd"))}
    check(diffs["kernel_vs_ref_states_gram"] <= 1e-3, f"states parity (gram) {diffs}")
    check(diffs["kernel_vs_ref_states_svd"] <= 1e-3, f"states parity (svd) {diffs}")
    check(diffs["gram_vs_svd_readout"] <= 5e-3, f"readout parity {diffs}")
    emit({"phase": "parity", "N": 32, "B": 8, "nrmse_max_abs_diff": diffs})


def streamed_vs_materialized(what: str, grams, res_s, res_m) -> dict:
    """Noise off, the streamed (G, c) equal the materialized K2's bitwise.
    ‖y‖² is summed chunk by chunk on one path and in one pass on the other,
    so the two GCV picks can differ where two λ tie to f32 round-off: where
    the λ agree, w must be bitwise equal and the NRMSE within 1e-5; where
    they differ, each run must score the other's λ within GCV_TIE_RTOL of
    its own pick."""
    import numpy as np
    import torch

    from repro_torch.pipeline.ridge import gcv_path

    (g_s, c_s, y2_s, n_s), (g_m, c_m, y2_m, n_m) = grams
    check(torch.equal(g_s, g_m) and torch.equal(c_s, c_m),
          f"{what}: streamed Gram vs materialized K2 Gram: G {max_err(g_s, g_m)}, "
          f"c {max_err(c_s, c_m)}")
    same = res_s.lam == res_m.lam
    gap = np.abs(res_s.nrmse - res_m.nrmse)
    gap_same = float(gap[same].max()) if same.any() else 0.0
    check(gap_same <= 1e-5, f"{what}: streamed vs materialized NRMSE where λ agrees {gap_same}")
    w_bitwise = bool(np.array_equal(res_s.readout_w[same], res_m.readout_w[same]))
    check(w_bitwise, f"{what}: w differs where λ agrees")
    grid = main_point().ridge_l2
    lams = np.asarray(grid, dtype=np.float32)
    ties = []
    for i in np.flatnonzero(~same):
        pick = {"streamed": int(np.argmin(np.abs(lams - res_s.lam[i]))),
                "materialized": int(np.argmin(np.abs(lams - res_m.lam[i])))}
        rel = {}
        for name, (g, c, y2, n), other in (("streamed", grams[0], "materialized"),
                                           ("materialized", grams[1], "streamed")):
            score = gcv_path(g[i], c[i], y2[i], n, grid)[1]
            rel[name] = float((score[pick[other]] - score[pick[name]]) / score[pick[name]])
            check(rel[name] <= GCV_TIE_RTOL,
                  f"{what}: instance {i} λ flip is no GCV tie ({name} {rel[name]})")
        ties.append({"instance": int(i), "lam": {k: float(grid[v]) for k, v in pick.items()},
                     "gcv_rel_gap": rel, "nrmse_gap": float(gap[i])})
    return {"gram_bitwise": True, "lam_agrees": int(same.sum()), "instances": int(same.size),
            "nrmse_max_gap_where_lam_agrees": gap_same, "nrmse_max_gap": float(gap.max()),
            "w_bitwise_where_lam_agrees": w_bitwise, "y2_max_rel_gap":
            float(((y2_s - y2_m).abs() / y2_m.abs()).max()), "gcv_ties": ties}


def shared_features(cfg, masks, tr, te, dev):
    """The shared readout's features, materialized: the fit rows of the
    train split (after the washout) and the test split, [T, R·N + 1] each
    (channel-major, bias last)."""
    from repro_torch.pipeline import channel_states, with_bias
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    j_tr, j_te = _input_layer(cfg, _canon_batch(tr, "inputs_train", dev),
                              _canon_batch(te, "inputs_test", dev))
    st_tr, fin = channel_states(cfg.model, j_tr, masks, method="kernel", return_final=True,
                                device=dev)
    st_te = channel_states(cfg.model, j_te, masks, s0=fin, method="kernel", device=dev)

    def features(st):
        r, k, n = st.shape
        return with_bias(st.movedim(0, 1).reshape(k, r * n))

    return features(st_tr)[cfg.washout:], features(st_te)


def f64_ridge(x, y, x_te, y_te, lam: float) -> dict:
    """The ridge fit at one λ in float64 (the port's λ' = λ·tr(G)/F): its
    test NRMSE and the condition number of the regularised system."""
    import numpy as np
    import torch

    from repro_torch.core.metrics import nrmse

    x64 = x.double()
    g = x64.mT @ x64
    lamp = lam * float(torch.trace(g)) / g.shape[-1]
    ev = torch.linalg.eigvalsh(g)
    w = torch.linalg.solve(g + lamp * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device),
                           x64.mT @ y.double())
    pred = (x_te.double() @ w)[:, 0].cpu().numpy()
    return {"nrmse": float(nrmse(np.asarray(y_te, dtype=np.float64), pred)),
            "cond": float((ev[-1] + lamp) / (ev[0].clamp(min=0) + lamp))}


def gram_error_ratio(g, c, x, y) -> float:
    """The largest error of (G, c) against the float64 XᵀX and Xᵀy (X
    [..., T, F]), as a share of the classical bound on an f32 sum of T
    products,
    γ_T·|X|ᵀ|X| with γ_T = T·u/(1 − T·u), u = 2⁻²⁴.  Above 1, the sums
    are wrong, not merely rounded."""
    import torch

    t = x.shape[-2]
    u = 2.0 ** -24
    gamma = t * u / (1 - t * u)
    x64, y64 = x.double(), y.double()
    tiny = torch.finfo(torch.float64).tiny
    return max(float(((got.double() - exact).abs() / (gamma * mag + tiny)).max())
               for got, exact, mag in ((g, x64.mT @ x64, x64.abs().mT @ x64.abs()),
                                       (c, x64.mT @ y64, x64.abs().mT @ y64.abs())))


def stream_config(**kw):
    """The streaming fused path at the main path's NARMA10 point."""
    from repro_torch.pipeline import ExperimentConfig

    mp = main_point()
    base = dict(model=mp.model, n_nodes=mp.n_nodes, washout=mp.washout, ridge_l2=mp.ridge_l2,
                state_method="kernel", readout_use_kernel=True, stream_chunk_k=STREAM_CHUNK,
                state_noise_mode="diagonal", state_noise_rel=0.003)
    base.update(kw)
    return ExperimentConfig(**base)


def phase_streaming(dev, narma, card: str) -> dict:
    """NARMA10 at the paper's point on the streaming fused path: 1000/1000
    periods in chunks of 256 (the train split ends in a ragged chunk of
    232), through K1 once per chunk and K3 once per fit chunk."""
    import numpy as np

    from repro_torch.pipeline import Experiment, record_stages

    cfg = stream_config()
    exp = Experiment(cfg, device=dev)
    reset_counts()
    res, first_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()
    check(launches == (8, 0, 4), f"streamed launches (scan, gram, into) = {launches}")
    # the readout-apply kernel once an evaluation chunk (1000 periods in 4)
    applies = readout_launches()
    check(applies == 4, f"streamed readout-apply launches {applies}")
    check(bool(np.all(np.isfinite(res.nrmse))), "streamed NRMSE finite")
    check(res.y_pred.shape == (B_MAIN, 1000), f"streamed y_pred shape {res.y_pred.shape}")
    check(bool(np.all(res.nrmse < 0.72)), f"streamed NRMSE per instance {res.nrmse}")
    check(float(res.nrmse.mean()) < 0.65, f"streamed mean NRMSE {res.nrmse.mean()}")
    _, steady_s = wall(lambda: exp.run(*narma))

    # bf16 state chunks: within the drift bound of DESIGN.md §9; the
    # readout-apply kernel once an evaluation chunk, on bf16 features
    exp16 = Experiment(dataclasses.replace(cfg, stream_state_dtype="bfloat16"), device=dev)
    reset_counts()
    res16 = exp16.run(*narma)
    applies16 = readout_launches()
    check(applies16 == 4, f"bf16 streamed readout-apply launches {applies16}")
    drift = float(np.abs(res16.nrmse - res.nrmse).max())
    check(drift <= 0.06, f"bf16 vs f32 streamed NRMSE drift {drift}")
    eval_peaks = bf16_eval_peaks(dev, narma, dataclasses.replace(cfg, stream_state_dtype="bfloat16"),
                                 exp.mask)

    # noise off: the streamed Gram IS the materialized K2 Gram, bitwise
    off = dataclasses.replace(cfg, state_noise_rel=0.0)
    with solved_grams() as grams:
        res_s = Experiment(off, device=dev).run(*narma)
        res_m = Experiment(dataclasses.replace(off, stream_chunk_k=None), device=dev).run(*narma)
    noise_off = streamed_vs_materialized("NARMA10", grams, res_s, res_m)
    noise_off["nrmse_mean"] = float(res_s.nrmse.mean())

    reset_counts()
    with record_stages() as stages:
        rec, run_s = wall(lambda: exp.run(*narma))
    check(launch_counts() == (8, 0, 4), f"recorded streamed run launches {launch_counts()}")
    check(bool(np.array_equal(rec.nrmse, res.nrmse)), "recorded streamed run NRMSE differs")
    emit({"phase": "streaming", "task": "narma10", "card": card, "B": B_MAIN, "N": cfg.n_nodes,
          "chunk": STREAM_CHUNK, "noise": "diagonal 0.003",
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2], "readout_apply": applies,
                       "readout_apply_bf16_run": applies16},
          "nrmse_mean": float(res.nrmse.mean()), "nrmse_max": float(res.nrmse.max()),
          "run_wall_s_first": first_s, "run_wall_s_steady": steady_s,
          "bf16_nrmse_max_drift": drift, "bf16_nrmse_mean": float(res16.nrmse.mean()),
          "bf16_eval_peak": eval_peaks, "noise_off": noise_off,
          "stages_wall_s": stages, "stages_run_wall_s": run_s,
          "unmarked_s": run_s - sum(v for k, v in stages.items()
                                    if k not in ("stream_states", "stream_fold"))})
    return {"launches": launches, "readout_launches_bf16": applies16, "exp": exp}


def bf16_eval_peaks(dev, narma, cfg16, mask) -> dict:
    """The bf16 streamed evaluation (``_eval_streaming`` over the test split
    in chunks of 256, K1 emitting bf16 states) at the NARMA10 width, with a
    random readout, once through the readout-apply kernel and once through
    the widened matmul the evaluation ran before it (``with_bias(x).to(f32)
    @ w``, the kernel's plain version): the device memory each run peaks at
    above what it starts with, and the gap of their error sums."""
    import torch

    from repro_torch.kernels.readout_apply import readout_apply, readout_apply_plain
    from repro_torch.pipeline import experiment as experiment_mod
    from repro_torch.pipeline.experiment import _canon_batch, _eval_streaming, _gen_states, _input_layer

    te = _canon_batch(narma[2], "inputs_test", dev)
    _, j_te = _input_layer(cfg16, te, te)
    y_te = _canon_batch(narma[3], "targets_test", dev)[..., None]
    b, n = te.shape[0], cfg16.n_nodes
    gen = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn((b, n + 1, 1), generator=gen, device=dev) / n ** 0.5
    s0 = torch.zeros((b, n), dtype=torch.float32, device=dev)

    def eval_fn(j_c, s):
        return _gen_states(cfg16, mask, j_c, wdm=False, s0=s, return_final=True,
                           state_dtype="bfloat16")

    out, err2 = {}, {}
    for name, apply in (("widened_matmul", readout_apply_plain), ("readout_apply", readout_apply)):
        experiment_mod.readout_apply = apply
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _, acc = _eval_streaming(cfg16, eval_fn, j_te, y_te, w, s0)
            torch.cuda.synchronize()
            out[f"{name}_peak_bytes_above_start"] = torch.cuda.max_memory_allocated() - base
        finally:
            experiment_mod.readout_apply = readout_apply
        err2[name] = acc[0]
    rel = float(((err2["readout_apply"] - err2["widened_matmul"]).abs()
                 / err2["widened_matmul"]).max())
    check(rel <= 1e-5, f"bf16 evaluation through the kernel vs the widened matmul: {rel}")
    out.update(shape_btn=[b, STREAM_CHUNK, n], err2_max_rel_gap=rel,
               chunk_f32_copy_bytes=4 * b * STREAM_CHUNK * (n + 1))
    return out


def phase_long_stream(dev, tasks, card: str) -> None:
    """K = 20000 a split, noise off: the streamed run's peak device memory
    stays under a quarter of one split's [B, K, N] f32 state tensor."""
    import numpy as np
    import torch

    from repro_torch.pipeline import Experiment

    long = stack([tasks.narma10(40000, seed=s) for s in range(B_MAIN)])
    k_split = long[0].shape[1]
    n_nodes = stream_config().n_nodes
    state_bytes = B_MAIN * k_split * n_nodes * 4
    peaks, walls, nrmse = {}, {}, {}
    for name, chunk in (("streamed", STREAM_CHUNK), ("materialized", None)):
        exp = Experiment(stream_config(state_noise_rel=0.0, stream_chunk_k=chunk), device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res, walls[name] = wall(lambda: exp.run(*long))
        peaks[name] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                       "allocated_before": before}
        nrmse[name] = res.nrmse
        check(bool(np.all(np.isfinite(res.nrmse))), f"long {name} NRMSE finite")
    peak = peaks["streamed"]["peak_bytes"]
    check(peak < state_bytes / 4, f"streamed peak {peak} B >= a quarter of {state_bytes} B")
    emit({"phase": "long_stream", "card": card, "B": B_MAIN, "N": n_nodes, "K_split": k_split,
          "chunk": STREAM_CHUNK, "state_tensor_bytes_per_split": state_bytes,
          "memory": peaks, "wall_s": walls,
          "nrmse_mean": {k: float(v.mean()) for k, v in nrmse.items()},
          "nrmse_max_gap": float(np.abs(nrmse["streamed"] - nrmse["materialized"]).max())})


def phase_wdm(dev, tasks, card: str) -> dict:
    """WDM ensembles: R = 64 channels of N = 100 on K = 10000 a split, K1
    in its per-lane mode; then the shared readout at R = 8 (F = 801)."""
    import numpy as np
    import torch

    from repro_torch.pipeline import WDMExperiment

    chans = stack([tasks.narma10(20000, seed=r) for r in range(B_MAIN)])
    cfg = stream_config(n_nodes=N_WDM, state_noise_rel=0.0)
    n_chunks = -(-chans[0].shape[1] // STREAM_CHUNK)
    exp_s = WDMExperiment(cfg, B_MAIN, device=dev)
    with solved_grams() as grams:
        reset_counts()
        res_s, stream_s = wall(lambda: exp_s.run(*chans))
        launches = launch_counts()
        check(launches == (2 * n_chunks, 0, n_chunks), f"streamed WDM launches {launches}")
        reset_counts()
        res_m, mat_s = wall(lambda: WDMExperiment(dataclasses.replace(cfg, stream_chunk_k=None),
                                                  B_MAIN, device=dev).run(*chans))
        check(launch_counts() == (2, 1, 0), f"materialized WDM launches {launch_counts()}")
    check(bool(np.all(np.isfinite(res_s.nrmse))), "WDM NRMSE finite")
    vs_materialized = streamed_vs_materialized("WDM", grams, res_s, res_m)

    emit({"phase": "wdm", "card": card, "R": B_MAIN, "N": N_WDM,
          "K_split": chans[0].shape[1], "chunk": STREAM_CHUNK,
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "nrmse_mean": float(res_s.nrmse.mean()), "nrmse_max": float(res_s.nrmse.max()),
          "streamed_vs_materialized": vs_materialized,
          "wall_s": {"streamed": stream_s, "materialized": mat_s}})
    # shared readout: 8 channels (8 masks) observe one NARMA10 stream, one
    # readout over their 801 features; the same fit with the Gram folded by
    # plain matmuls instead of K3.  Both Grams are held to the error bound
    # of an f32 sum against the float64 Gram of the same features.
    r = 8
    tr = np.repeat(chans[0][:1], r, axis=0)
    te = np.repeat(chans[2][:1], r, axis=0)
    shared = {}
    with solved_grams() as grams:
        for name, use_kernel in (("kernel", True), ("plain", False)):
            reset_counts()
            exp = WDMExperiment(dataclasses.replace(cfg, readout_use_kernel=use_kernel), r,
                                shared_readout=True, device=dev)
            res = exp.run(tr, chans[1][0], te, chans[3][0])
            check(launch_counts() == (2 * n_chunks, 0, n_chunks if use_kernel else 0),
                  f"shared readout ({name}) launches {launch_counts()}")
            check(res.readout_w.shape == (1, r * N_WDM + 1) and bool(np.isfinite(res.nrmse).all()),
                  f"shared readout ({name}) {res.readout_w.shape} {res.nrmse}")
            shared[name] = {"nrmse": float(res.nrmse[0]), "lam": float(res.lam[0])}
    x, x_te = shared_features(cfg, exp.masks, tr, te, dev)
    y = torch.as_tensor(chans[1][0][cfg.washout:, None], dtype=torch.float32, device=dev)
    for (g, c, *_), name in zip(grams, ("kernel", "plain")):
        shared[name]["gram_error_vs_bound"] = gram_error_ratio(g[0], c[0], x, y)
    shared["nrmse_gap"] = abs(shared["kernel"]["nrmse"] - shared["plain"]["nrmse"])
    shared["float64_at_kernel_lam"] = f64_ridge(x, y, x_te, chans[3][0],
                                                shared["kernel"]["lam"])
    emit({"phase": "wdm_shared", "card": card, "R": r, "F": r * N_WDM + 1,
          "K_split": chans[0].shape[1], **shared, "tolerance": SHARED_TOL})
    for name in ("kernel", "plain"):
        check(shared[name]["gram_error_vs_bound"] <= 1.0,
              f"shared Gram ({name}) outside the f32 sum's error bound")
    check(shared["nrmse_gap"] <= SHARED_TOL,
          f"shared readout kernel vs plain fold NRMSE {shared['nrmse_gap']}")
    return {"launches": launches, "chans": chans, "cfg": cfg, "masks": exp_s.masks,
            "shared": {"x": x, "y": y, "launches": n_chunks}}


def serve_config(**kw):
    """A session config of the repo's serving configuration, on the kernels."""
    from repro_torch.core import SiliconMR
    from repro_torch.pipeline.session import SessionConfig

    base = dict(model=SiliconMR(), n_nodes=SERVE_N, washout=SERVE_WASHOUT,
                chunk_k=SERVE_CHUNK, refresh_every=SERVE_REFRESH, ridge_l2=SERVE_LAMS,
                state_method="kernel", use_kernel=True)
    base.update(kw)
    return SessionConfig(**base)


def scan_plain(model, j, mask, s0, *, block_s=None, return_final=False, out_dtype=None):
    """``dfr_scan`` through its plain version, on any device."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    states, fin = scan_ops.dfr_scan_plain(model, j, mask, s0, out_dtype=out_dtype)
    return (states, fin) if return_final else states


@contextlib.contextmanager
def plain_kernels():
    """Route K1, K3 and the readout-apply kernel through their plain
    PyTorch versions (on the card's tensors) for the body of the ``with``."""
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.readout_apply import readout_apply_plain
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.pipeline import experiment, session

    scan, into = scan_ops.dfr_scan, gram_ops.gram_accumulate_batched_into
    applies = experiment.readout_apply, session.readout_apply

    def into_plain(g0, c0, x, y, *, block_t=512, round_y=True):
        return gram_ops.gram_plain_batched(x, y, block_t=block_t, g0=g0, c0=c0,
                                           round_y=round_y)

    scan_ops.dfr_scan, gram_ops.gram_accumulate_batched_into = scan_plain, into_plain
    experiment.readout_apply = session.readout_apply = readout_apply_plain
    try:
        yield
    finally:
        scan_ops.dfr_scan, gram_ops.gram_accumulate_batched_into = scan, into
        experiment.readout_apply, session.readout_apply = applies


def same_bits(a, b) -> bool:
    """Bitwise equal as int32 patterns (NaN and inf included)."""
    import torch

    return bool(torch.equal(a.float().contiguous().view(torch.int32),
                            b.float().contiguous().view(torch.int32)))


def phase_session_parity(dev, card: str) -> None:
    """B = 64 sessions of the serving configuration take 8 chunks of one
    stream each, re-solving on the last: at λ = 1.0 and 0.99 their G, c,
    ‖y‖², w, λ index and carry equal ``fit_ridge_streaming`` over the
    concatenated streams with the same kernels, bitwise; 4 + 4 chunks
    through a state rebuilt on the host from the first half's leaves equal
    the 8, bitwise; every tick launches K1 once and K3 once."""
    import torch

    from repro_torch.core import make_mask
    from repro_torch.pipeline import fit_ridge_streaming
    from repro_torch.pipeline.session import SessionState, _session_step, session_init
    from repro_torch.robustness import make_streams

    b, ticks, ck = 64, 8, SERVE_CHUNK
    j_np, y_np = make_streams(b, ticks * ck, snr_db=SERVE_SNR_DB)
    j = torch.as_tensor(j_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    mask = make_mask(SERVE_N, seed=0, device=dev)
    out = {}
    for lam in (1.0, 0.99):
        cfg = serve_config(forgetting=lam)

        def run(state, lo, hi, counts):
            for t in range(lo, hi):
                reset_counts()
                _, state = _session_step(cfg, mask, state, j[:, t * ck:(t + 1) * ck],
                                         y[:, t * ck:(t + 1) * ck], refresh=t == ticks - 1)
                counts.append(launch_counts())
            return state

        counts = []
        state = run(session_init(cfg, b, device=dev), 0, ticks, counts)
        check(all(c == (1, 0, 1) for c in counts),
              f"session tick launches (scan, gram, into) {counts}")
        with solved_grams() as grams:
            w, idx, s_end = fit_ridge_streaming(
                cfg.model, mask, j, y, washout=SERVE_WASHOUT, chunk_k=ck, lambdas=SERVE_LAMS,
                state_method="kernel", use_kernel=True, forgetting=lam, device=dev)
        g, c, y2, _ = grams[0]
        for name, a, ref in (("g", state.g, g), ("c", state.c, c), ("y2", state.y2, y2),
                             ("w", state.w, w), ("lam_idx", state.lam_idx, idx.to(torch.int32)),
                             ("s", state.s, s_end)):
            check(torch.equal(a, ref), f"session vs streaming fit at λ = {lam}: {name} "
                                       f"differs by {max_err(a, ref)}")
        half = run(session_init(cfg, b, device=dev), 0, ticks // 2, [])
        rebuilt = SessionState(*(torch.from_numpy(leaf.cpu().numpy()).to(dev) for leaf in half))
        resumed = run(rebuilt, ticks // 2, ticks, [])
        for name, a, ref in zip(SessionState._fields, resumed, state):
            check(torch.equal(a, ref), f"4 + 4 chunk resume at λ = {lam}: {name} differs")
        out[str(lam)] = {"bitwise": ["g", "c", "y2", "w", "lam_idx", "s"],
                         "resume_4_plus_4_bitwise": True,
                         "launches_per_tick": {"dfr_scan": 1, "ridge_gram": 0,
                                               "ridge_gram_into": 1},
                         "lam_counts": torch.bincount(state.lam_idx.long(),
                                                      minlength=len(SERVE_LAMS)).tolist()}
    emit({"phase": "session_parity", "card": card, "B": b, "N": SERVE_N, "chunk": ck,
          "chunks": ticks, "by_forgetting": out})


def phase_session_plain(dev, card: str) -> None:
    """One serving tick at B = 65 (the 8-lane block's edge), N ∈ {1, 33, 64},
    through the kernels and through their plain versions on the card, from
    a live slab whose carry has NaN and +Inf rows and whose drive has NaN
    samples.  K1's states and carry equal the plain version's as int bit
    patterns (SiliconMR exact, as on the edge grid of phase 2), so the same rows
    go non-finite; through the tick the carry is bitwise, the same rows are
    quarantined (their predictions zeroed alike), the other rows'
    predictions agree within 1e-6 of the sum's magnitude (the readout-apply
    kernel sums in another order than the plain matmul), and G and c agree
    to the Gram tolerance (rtol 1e-5, atol 1e-4: K3 sums in another order
    than the plain matmuls)."""
    import numpy as np
    import torch

    from repro_torch.core import make_mask
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.pipeline import with_bias
    from repro_torch.pipeline.session import _copy, _session_step, session_init

    b, ck = 65, SERVE_CHUNK
    res = {}
    for n in (1, 33, 64):
        cfg = serve_config(n_nodes=n, forgetting=0.99)
        rng = np.random.default_rng(n)
        mask = make_mask(n, seed=0, device=dev)
        s = rng.uniform(0, 0.3, (b, n)).astype(np.float32)
        s[3] = np.nan
        s[7] = np.inf
        s[11, n // 2] = np.nan
        j = rng.uniform(0, 1, (b, ck)).astype(np.float32)
        j[5, 10] = np.nan
        j[9] = np.nan
        j[64, ck - 1] = np.nan
        y = rng.choice([-3.0, -1.0, 1.0, 3.0], (b, ck)).astype(np.float32)
        x0 = torch.as_tensor(rng.standard_normal((b, ck, n + 1)), dtype=torch.float32,
                             device=dev)
        g0, c0 = gram_ops.gram_plain_batched(x0, torch.ones((b, ck, 1), device=dev))
        base = session_init(cfg, b, device=dev)._replace(
            s=torch.as_tensor(s, device=dev), g=g0, c=c0,
            w=torch.as_tensor(rng.normal(0, 0.1, (b, n + 1, 1)), dtype=torch.float32,
                              device=dev),
            step=torch.full((b,), 2 * ck, dtype=torch.int32, device=dev))
        jt, yt = torch.as_tensor(j, device=dev), torch.as_tensor(y, device=dev)
        out_k, fin_k = scan_ops.dfr_scan(cfg.model, jt, mask, base.s, return_final=True)
        out_p, fin_p = scan_ops.dfr_scan_plain(cfg.model, jt, mask, base.s)
        check(same_bits(out_k, out_p) and same_bits(fin_k, fin_p),
              f"N = {n}: K1 with non-finite rows is not bitwise its plain version")
        bad_rows = ~torch.isfinite(fin_k).all(dim=1)
        reset_counts()
        yk, sk = _session_step(cfg, mask, _copy(base), jt, yt)
        check(launch_counts() == (1, 0, 1) and readout_launches() == 1,
              f"N = {n}: tick launches {launch_counts()}, readout-apply {readout_launches()}")
        with plain_kernels():
            yp, sp = _session_step(cfg, mask, _copy(base), jt, yt)
        check(launch_counts() == (1, 0, 1) and readout_launches() == 1,
              f"N = {n}: the plain tick launched a kernel")
        check(same_bits(sk.s, sp.s), f"N = {n}: tick carry")
        good = ~sk.quarantined
        rel = float(((yk - yp).abs() / (with_bias(out_k).abs() @ base.w.abs()))[good].max())
        check(same_bits(yk[~good], yp[~good]) and rel <= 1e-6,
              f"N = {n}: tick prediction vs plain {rel} of the sum's magnitude")
        check(torch.equal(sk.quarantined, sp.quarantined)
              and torch.equal(sk.quarantined, bad_rows),
              f"N = {n}: quarantined rows {sk.quarantined.nonzero().flatten().tolist()} vs "
              f"plain {sp.quarantined.nonzero().flatten().tolist()}")
        for name in ("g", "c"):
            a, r = getattr(sk, name), getattr(sp, name)
            check(torch.allclose(a, r, rtol=1e-5, atol=1e-4), f"N = {n}: tick {name} vs plain "
                                                               f"{max_err(a, r)}")
        res[str(n)] = {"quarantined_rows": sk.quarantined.nonzero().flatten().tolist(),
                       "prediction_max_rel_err_of_sum_magnitude": rel,
                       "g_max_abs_err": max_err(sk.g, sp.g), "c_max_abs_err": max_err(sk.c, sp.c)}
    emit({"phase": "session_kernel_vs_plain", "card": card, "B": b, "chunk": ck,
          "k1_int_bitwise": True, "carry_bitwise": True, "by_N": res})


def serve_drain(server, requests) -> dict:
    """Drain ``requests`` through ``server`` a tick at a time; returns the
    host seconds of each ``step`` beside the server's in-step seconds."""
    import torch

    for r in requests:
        server.submit(r)
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while server.queue or server.active:
        t1 = time.perf_counter()
        server.step()
        steps.append(time.perf_counter() - t1)
    server.close()
    return {"wall_s": time.perf_counter() - t0, "step_s": steps}


def serve_report(server, drained: dict, requests) -> dict:
    """Throughput, tick latency by kind, SER and the host share of a drain."""
    import numpy as np

    from repro_torch.launch.serve_dfr import online_ser

    wall = drained["wall_s"]
    ticks = np.asarray(server.tick_seconds)
    refresh = np.arange(len(ticks)) % SERVE_REFRESH == 0
    online, steady = online_ser(server, SERVE_WASHOUT)

    def q(x):
        return {"p50_ms": float(np.percentile(x, 50) * 1e3),
                "p99_ms": float(np.percentile(x, 99) * 1e3), "n": int(len(x))}

    periods = sum(len(r.j) for r in server.completed)
    steps = np.asarray(drained["step_s"])
    step_s = float(steps.sum())
    return {"ticks": server.tick, "completed": len(server.completed),
            "requests": len(requests), "wall_s": wall,
            "streams_per_s": len(server.completed) / wall, "periods_per_s": periods / wall,
            "tick_fold_only": q(ticks[~refresh]), "tick_fold_solve": q(ticks[refresh]),
            "online_ser": online, "steady_ser": steady,
            "host_share_of_step": 1.0 - float(ticks.sum()) / step_s,
            "host_share_of_fold_only_step": 1.0 - float(ticks[~refresh].sum() /
                                                        steps[~refresh].sum()),
            "step_s_sum": step_s, "in_step_s_sum": float(ticks.sum()),
            "step_ms": (steps * 1e3).tolist(), "in_step_ms": (ticks * 1e3).tolist(),
            "stats": server.stats()}


def phase_serving(dev, card: str) -> dict:
    """``DFRServer`` at full size: B = 4096 slots at λ = 0.99 drain 8192
    channel-equalization streams built as the CLI builds them, then B = 512
    at λ = 1.0 drains 1024; throughput, tick latency (fold-only and
    fold+solve ticks apart), online and steady SER (held to the band of the
    JAX package's steady SER), peak device memory, the host share of a
    step, and K1/K3 launches (one each a tick).  Then, at B = 4096 with a
    new wave of streams mid-flight, the device's busy time in the three
    fold-only ticks after a refresh (torch.profiler)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve_dfr import DFRServer, channel_eq_requests

    out = {}
    t_req = time.perf_counter()
    reqs = channel_eq_requests(SERVE_REQUESTS, SERVE_STREAM, SERVE_CHUNK, snr_db=SERVE_SNR_DB)
    build_s = time.perf_counter() - t_req
    keep = {}
    for b, lam, n_req in ((SERVE_B, 0.99, SERVE_REQUESTS), (SERVE_B_SMALL, 1.0, 2 * SERVE_B_SMALL)):
        server = DFRServer(serve_config(forgetting=lam), b, device=dev)
        server.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        drained = serve_drain(server, [dataclasses.replace(r, y_hat=[]) for r in reqs[:n_req]])
        launches = launch_counts()
        applies = readout_launches()
        rep = serve_report(server, drained, reqs[:n_req])
        rep["peak_bytes"] = torch.cuda.max_memory_allocated()
        rep["launches"] = {"dfr_scan": launches[0], "ridge_gram": launches[1],
                           "ridge_gram_into": launches[2], "readout_apply": applies}
        check(launches == (server.tick, 0, server.tick) and applies == server.tick,
              f"B = {b}: launches {launches}, readout-apply {applies} over {server.tick} ticks")
        check(rep["completed"] == n_req, f"B = {b}: {rep['completed']} of {n_req} completed")
        check(all(np.isfinite(np.concatenate(r.y_hat)).all() for r in server.completed),
              f"B = {b}: a prediction is not finite")
        ref = SERVE_REF_STEADY_SER[lam]
        rep["steady_ser_band"] = [ref - SERVE_SER_BAND, ref + SERVE_SER_BAND]
        check(abs(rep["steady_ser"] - ref) <= SERVE_SER_BAND,
              f"B = {b}: steady SER {rep['steady_ser']} outside {ref} ± {SERVE_SER_BAND}")
        out[f"B{b}_lam{lam}"] = rep
        keep[b] = server
    server = keep[SERVE_B]
    g = server.state.g.clone()
    # device busy time of the three fold-only ticks after a refresh,
    # mid-stream.  A fold+solve tick is not profiled: its eigh launches
    # ≈ 5·10⁵ small kernels, whose trace takes minutes to read back; the
    # library line times that eigh alone.
    for r in reqs[:SERVE_B]:
        server.submit(dataclasses.replace(r, y_hat=[], pos=0))
    for _ in range(SERVE_REFRESH + 1):
        server.step()
    check(server.tick % SERVE_REFRESH == 1, f"profile starts at tick {server.tick}")
    out["profile_fold_only_ticks"] = profile_ticks(server, SERVE_REFRESH - 1)
    emit({"phase": "serving", "card": card, "N": SERVE_N, "chunk": SERVE_CHUNK,
          "washout": SERVE_WASHOUT, "stream_periods": int(len(reqs[0].j)),
          "refresh_every": SERVE_REFRESH, "lams": SERVE_LAMS, "snr_db": SERVE_SNR_DB,
          "requests_build_s": build_s, "runs": out})
    j = np.stack([r.j[:3 * SERVE_CHUNK] for r in reqs[:SERVE_B]])
    y = np.stack([r.y[:3 * SERVE_CHUNK] for r in reqs[:SERVE_B]])
    return {"j": torch.as_tensor(j, device=dev), "y": torch.as_tensor(y, device=dev),
            "mask": server.mask, "model": server.cfg.model, "g": g,
            "launches": out[f"B{SERVE_B}_lam0.99"]["launches"],
            "ticks": out[f"B{SERVE_B}_lam0.99"]["ticks"]}


def profile_ticks(server, n_ticks: int) -> dict:
    """Device busy time of the next ``n_ticks`` server ticks against their
    host wall time (``profile_calls``)."""
    return profile_calls(server.step, n_ticks, "ticks")


def profile_calls(fn, n_calls: int, what: str = "calls", shares=None) -> dict:
    """Device busy time of ``n_calls`` calls of ``fn`` (torch.profiler: the
    union of the kernel and copy intervals on the card) against their host
    wall time, and the kernels by device time; with ``shares`` ({label:
    substring of a kernel's name}) also each label's device ms and share of
    the busy time; the error if the profiler fails here."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and "Buffer" not in e.name)
        busy_us, end = 0.0, float("-inf")
        by_name = {}
        for start, stop, name in spans:
            busy_us += max(0.0, stop - max(start, end))
            end = max(end, stop)
            by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out = {what: n_calls, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
               "device_busy_share": busy_us / 1e3 / wall_ms, "device_events": len(spans),
               "top_device_ms": top}
        for label, part in (shares or {}).items():
            ms = sum(v for k, v in by_name.items() if part in k)
            out[f"{label}_device_ms"] = ms
            out[f"{label}_share_of_busy"] = ms / (busy_us / 1e3)
        return out
    except Exception as err:  # noqa: BLE001 — the profiler is untried on that machine
        return {"error": f"{type(err).__name__}: {err}"}


def phase_kill_restore(dev, card: str) -> None:
    """A B = 512 server with faults armed on 4 rows (NaN samples at p = 0.05
    for the first 10 ticks) and checkpoint_every = 4 under build/ is
    dropped after tick 10; a new server restores and drains: predictions,
    completed streams and counters are bitwise those of an uninterrupted
    run.  Then the newest checkpoint's first leaf is corrupted: the restore
    falls back one checkpoint and still matches."""
    import shutil

    import numpy as np

    from repro_torch.launch.serve_dfr import DFRServer, channel_eq_requests
    from repro_torch.robustness import no_faults, on_rows

    b, kill = SERVE_B_SMALL, 10
    root = ROOT / "build" / "serve_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    reqs = channel_eq_requests(2 * b, SERVE_STREAM, SERVE_CHUNK, snr_db=SERVE_SNR_DB, seed=7)
    spec = on_rows(no_faults(b, device=dev), [0, 1, 2, 3], nan_prob=0.05, until_tick=kill)
    cfg = serve_config(forgetting=0.99)

    def fresh(name):
        s = DFRServer(cfg, b, fault_spec=spec, fault_seed=5, checkpoint_dir=str(root / name),
                      checkpoint_every=4, device=dev)
        s.warmup()
        return s

    def outputs(server):
        return [(r.rid, np.concatenate(r.y_hat)) for r in server.completed]

    ref = fresh("uninterrupted")
    for r in reqs:
        ref.submit(dataclasses.replace(r, y_hat=[]))
    ref.drain()
    expect = outputs(ref)
    legs = {}
    for leg in ("newest", "corrupt_newest"):
        crash = fresh(leg)
        for r in reqs:
            crash.submit(dataclasses.replace(r, y_hat=[]))
        for _ in range(kill):
            crash.step()
        crash.close()
        steps = crash.store.all_steps()
        if leg == "corrupt_newest":
            leaf = sorted((root / leg / f"step_{steps[-1]:010d}").glob("leaf_*.npy"))[0]
            leaf.write_bytes(leaf.read_bytes()[:-8] + b"deadbeef")
        resumed = fresh(leg)
        got_tick = resumed.restore()
        want_tick = steps[-1] if leg == "newest" else steps[-2]
        check(got_tick == want_tick, f"{leg}: restored tick {got_tick}, expected {want_tick}")
        resumed.drain()
        got = outputs(resumed)
        same = (len(got) == len(expect) and all(
            ra == rb and ya.tobytes() == yb.tobytes() for (ra, ya), (rb, yb) in zip(got, expect)))
        check(same, f"{leg}: resumed predictions are not bitwise the uninterrupted run's")
        check(resumed.counters == ref.counters,
              f"{leg}: counters {resumed.counters} vs {ref.counters}")
        legs[leg] = {"checkpoints": steps, "restored_tick": got_tick, "bitwise": True,
                     "counters": resumed.counters}
    emit({"phase": "kill_restore", "card": card, "B": b, "requests": len(reqs),
          "killed_after_tick": kill, "checkpoint_every": 4, "legs": legs,
          "uninterrupted_ticks": ref.tick})


def phase_soak(dev, card: str) -> None:
    """``run_soak`` at B = 64 on the card: NaN, +Inf and carry-corruption
    faults (probability 1) on rows 1-3 and NaN samples at p = 0.5 on row 4,
    for the first 4 of 24 ticks; a stuck node on row 5 and thermal detuning
    on row 6.  Healthy rows bitwise the clean run, every prediction finite,
    the poisoned rows quarantined and re-converged below the gates of
    tests/test_robustness.py, the drifting rows never quarantined."""
    from repro_torch.robustness import no_faults, on_rows, run_soak

    spec = no_faults(64, device=dev)
    for row, fault in ((1, dict(nan_prob=1.0)), (2, dict(inf_prob=1.0)),
                       (3, dict(corrupt_prob=1.0)), (4, dict(nan_prob=0.5))):
        spec = on_rows(spec, [row], until_tick=4, **fault)
    spec = on_rows(spec, [5], stuck_node=3, stuck_value=0.5)
    spec = on_rows(spec, [6], detune_amp=0.5, detune_period=64.0)
    t0 = time.perf_counter()
    rep = run_soak(serve_config(), spec, n_ticks=24, seed=1)
    seconds = time.perf_counter() - t0
    check(rep["faulty_rows"] == [1, 2, 3, 4, 5, 6], f"soak faulty rows {rep['faulty_rows']}")
    check(rep["healthy_bitwise_identical"], "soak: healthy rows differ from the clean run")
    check(rep["output_all_finite"], "soak: a non-finite prediction reached the host")
    for row in (1, 2, 3, 4):
        check(rep["quarantine_events"][row] >= 1, f"soak: row {row} never quarantined")
        ser = rep["tail_ser_rows"][row]
        check(ser < SOAK_TAIL_SER and ser <= rep["tail_ser_clean"] + SOAK_TAIL_BAND,
              f"soak: row {row} tail SER {ser} (clean {rep['tail_ser_clean']})")
    for row in (1, 2, 3):
        check(rep["quarantine_ticks"][row] == [0, 1, 2, 3],
              f"soak: row {row} quarantined at {rep['quarantine_ticks'][row]}")
    check(rep["quarantine_events"][5] == rep["quarantine_events"][6] == 0,
          "soak: a drift fault tripped the quarantine")
    emit({"phase": "soak", "card": card, "seconds": seconds,
          "gates": {"tail_ser": SOAK_TAIL_SER, "band": SOAK_TAIL_BAND}, **{
              k: rep[k] for k in ("batch", "n_ticks", "chunk", "faulty_rows",
                                  "healthy_bitwise_identical", "output_all_finite",
                                  "quarantine_ticks", "tail_ser_clean", "tail_ser_healthy",
                                  "tail_ser_faulty")},
          "quarantine_events": rep["quarantine_events"][:8],
          "tail_ser_rows": rep["tail_ser_rows"][:8]})


def phase_accelerator(dev, tasks, card: str) -> dict:
    """``DFRCAccelerator`` at the paper's NARMA10 point (N = 900, washout
    60, the five-λ grid; ``dfrc_tasks()["narma10"]["Silicon MR"]``) on the
    scan kernel, against ``Experiment.run_dataset`` of
    ``ExperimentConfig.from_dfrc`` of the same config (within 0.05 NRMSE,
    tests/test_pipeline.py's bound); beside it the Fig. 7 training-time
    model and the Table 1 power totals."""
    from repro_torch.core import DFRCAccelerator, power, timing
    from repro_torch.pipeline import Experiment, ExperimentConfig

    cfg = dataclasses.replace(main_point(), state_method="kernel")
    ds = tasks.narma10(2000, seed=0)
    reset_counts()
    acc, fit_s = wall(lambda: DFRCAccelerator(cfg, device=dev).fit(ds.inputs_train,
                                                                  ds.targets_train))
    err, predict_s = wall(lambda: acc.evaluate_nrmse(ds.inputs_test, ds.targets_test))
    launches = launch_counts()
    check(launches == (2, 0, 0), f"accelerator launches (scan, gram, into) {launches}")
    accelerator = {"launches": launches}
    res = Experiment(ExperimentConfig.from_dfrc(cfg), device=dev).run_dataset(ds)
    gap = abs(float(res.nrmse[0]) - err)
    check(gap < 0.05, f"accelerator NRMSE {err} vs Experiment {res.nrmse[0]}")
    n_train = len(ds.inputs_train)
    nodes = {acc: main_point("narma10", acc).n_nodes for acc in FIG_ACCELERATORS}
    fig7 = {tm.name: {"n_nodes": nodes[tm.name],
                      "collect_s": tm.collection_time_s(n_train, nodes[tm.name]),
                      "total_s": tm.training_time_s(n_train, nodes[tm.name])}
            for tm in (timing.TIMING_SILICON_MR, timing.TIMING_MZI, timing.TIMING_MG)}
    table1 = {spec.name: {"total_mw_wallplug": spec.total_mw(),
                          "total_mw_optical_only": spec.total_mw(apply_wall_plug=False),
                          "paper_mw": power.PAPER_TOTALS_MW[spec.name]}
              for spec in (power.SILICON_MR, power.ALL_OPTICAL_MZI)}
    emit({"phase": "accelerator", "card": card, "task": "narma10", "N": cfg.n_nodes,
          "nrmse": err, "experiment_nrmse": float(res.nrmse[0]), "gap": gap,
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1]},
          "fit_wall_s": fit_s, "predict_wall_s": predict_s,
          "fig7_model_n_train": n_train, "fig7_model": fig7, "table1_power": table1})
    return accelerator


def cmt_config(**kw):
    """The CMT cavity at the main path's NARMA10 point, noise off, on K1 and
    K2 (the reference's ``experiment_cmt_kernel`` entry point)."""
    from repro_torch.pipeline import ExperimentConfig

    mp = main_point()
    base = dict(model=cmt_model(), n_nodes=mp.n_nodes, washout=mp.washout, ridge_l2=mp.ridge_l2,
                state_noise_rel=0.0, state_method="kernel", readout_use_kernel=True)
    base.update(kw)
    return ExperimentConfig(**base)


def gcv_tie(grams, i: int, own: float, other: float) -> float:
    """Relative GCV gap between λ ``other`` and ``own`` on instance ``i`` of
    a solved (G, c, ‖y‖², n) record: ≤ GCV_TIE_RTOL is a tie."""
    import numpy as np

    from repro_torch.pipeline.ridge import gcv_path

    g, c, y2, n = grams
    grid = main_point().ridge_l2
    lams = np.asarray(grid, dtype=np.float32)
    pick = {name: int(np.argmin(np.abs(lams - v))) for name, v in (("own", own),
                                                                    ("other", other))}
    score = gcv_path(g[i], c[i], y2[i], n, grid)[1]
    return float((score[pick["other"]] - score[pick["own"]]) / score[pick["own"]])


def ridge64_nrmse(st_tr, y_tr, st_te, y_te, *, lam: float, washout: int) -> list[float]:
    """Test NRMSE of a float64 ridge at ``lam`` on each instance's states
    (train [B, T, N], its first ``washout`` periods cut; test [B, T', N]):
    the fit in which the states alone decide the score."""
    import torch

    from repro_torch.pipeline import with_bias

    out = []
    for i in range(st_tr.shape[0]):
        x = with_bias(torch.as_tensor(st_tr[i, washout:]))
        y = torch.as_tensor(y_tr[i, washout:, None], dtype=torch.float64, device=x.device)
        out.append(f64_ridge(x, y, with_bias(torch.as_tensor(st_te[i])), y_te[i], lam)["nrmse"])
    return out


def sweep_cell_model(twin, grid, flat: int):
    """The dataclass point of sweep lane ``flat``, κ pinned to ``twin``'s
    anchor as the sweep pins it (K1 takes a dataclass point, not lanes)."""
    import numpy as np

    p = grid.point(np.unravel_index(flat, grid.shape))
    return dataclasses.replace(twin, detune=p["detune"], loss_scale=p["loss_scale"],
                               power_mw=p["power"], kappa_charge=twin.kappa_c,
                               kappa_discharge=twin.kappa_d)


def phase_cmt_main(dev, narma, card: str) -> dict:
    """The CMT cavity's pipeline at full width: NARMA10 at the main path's
    point (N = 900, 2000 samples, washout 60, the λ grid, B = 64 seeds, noise
    off) on K1's CMT form ×2 and K2 ×1, then one more run inside
    ``record_stages``.

    Each of the first seeds is held to the JAX package where the fit is well
    posed: a float64 ridge at the reference's λ on the card's K1 states
    scores within CMT_NRMSE_TOL of the same fit on the reference's states
    (CMT_REF_NRMSE_F64).  The pipeline's own f32 Gram/eigh readout is not:
    its regularised system has cond ≈ 9e6 here, squared in the Gram, and
    the reference's NRMSE itself moves by 4e-3 when its inputs move by an
    ulp (tests/test_torch_devices.py::
    test_f32_readout_spread_is_the_references_own); it is held to
    PARITY_NRMSE of CMT_REF_NRMSE where it picks the reference's λ, and
    reported."""
    import numpy as np

    from repro_torch.core import generate_states
    from repro_torch.pipeline import Experiment, record_stages
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    exp = Experiment(cmt_config(), device=dev)
    reset_counts()
    with solved_grams() as grams:
        res, first_s = wall(lambda: exp.run(*narma))
    launches = launch_counts()
    check(launches == (2, 1, 0), f"CMT launches (scan, gram, into) = {launches}")
    check(bool(np.all(np.isfinite(res.nrmse))), "CMT NRMSE finite")
    n = len(CMT_REF_NRMSE_F64)
    j_tr, j_te = _input_layer(exp.config, _canon_batch(narma[0][:n], "inputs_train", dev),
                              _canon_batch(narma[2][:n], "inputs_test", dev))
    st_tr, fin = generate_states(exp.config.model, j_tr, exp.mask, method="kernel",
                                 return_final=True, device=dev)
    st_te = generate_states(exp.config.model, j_te, exp.mask, s0=fin, method="kernel",
                            device=dev)
    f64 = ridge64_nrmse(st_tr, narma[1][:n], st_te, narma[3][:n], lam=CMT_REF_LAM,
                        washout=exp.config.washout)
    seeds = []
    for i in range(n):
        got, lam = float(res.nrmse[i]), float(res.lam[i])
        row = {"seed": i, "f64_ridge_nrmse": f64[i], "f64_reference": CMT_REF_NRMSE_F64[i],
               "f64_gap": abs(f64[i] - CMT_REF_NRMSE_F64[i]), "pipeline_nrmse": got,
               "pipeline_reference": CMT_REF_NRMSE[i],
               "pipeline_gap": abs(got - CMT_REF_NRMSE[i]), "lam": lam}
        check(row["f64_gap"] <= CMT_NRMSE_TOL,
              f"CMT seed {i}: float64-ridge NRMSE {f64[i]} vs reference {CMT_REF_NRMSE_F64[i]}")
        if np.isclose(lam, CMT_REF_LAM, rtol=1e-6):
            check(row["pipeline_gap"] <= PARITY_NRMSE,
                  f"CMT seed {i}: NRMSE {got} vs reference {CMT_REF_NRMSE[i]}")
        else:
            row["gcv_rel_gap_to_reference_lam"] = gcv_tie(grams[0], i, lam, CMT_REF_LAM)
        seeds.append(row)
    del st_tr, st_te
    reset_counts()
    with record_stages() as stages:
        rec, run_s = wall(lambda: exp.run(*narma))
    check(launch_counts() == (2, 1, 0) and bool(np.array_equal(rec.nrmse, res.nrmse)),
          f"recorded CMT run: launches {launch_counts()}, NRMSE differs")
    emit({"phase": "cmt_main", "task": "narma10", "card": card, "B": B_MAIN,
          "N": exp.config.n_nodes,
          "model": repr(exp.config.model), "noise": "off",
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "nrmse_mean": float(res.nrmse.mean()), "nrmse_max": float(res.nrmse.max()),
          "lam_counts": {str(v): int(c) for v, c in zip(*np.unique(res.lam, return_counts=True))},
          "first_seeds_vs_reference": seeds,
          "tolerance": {"f64_ridge": CMT_NRMSE_TOL, "pipeline": PARITY_NRMSE},
          "k1_wall_s_per_launch": (stages["states_train"] + stages["states_test"]) / 2,
          "run_wall_s_first": first_s, "run_wall_s": run_s, "stages_wall_s": stages})
    return {"launches": launches, "exp": exp}


def phase_cmt_calibration(dev, narma, card: str) -> None:
    """Calibration on the card: the zero-power twin's tick map against
    SiliconMR's over the [0, 1]³ box (≤ PARITY_TICK) with the small-signal
    gains; the twin and SiliconMR through K1 on the same 64 seeds (mean
    |ΔNRMSE| ≤ PARITY_NRMSE); the twin streamed at chunk 256 through K1's CMT
    form and K3, its Gram bitwise the materialized K2 Gram."""
    import numpy as np

    from repro_torch.core import SiliconMR
    from repro_torch.devices import calibration_report, node_parity
    from repro_torch.pipeline import Experiment

    twin = cmt_model(power_mw=0.0)
    tick = node_parity(SiliconMR(), twin, device=dev)
    check(tick <= PARITY_TICK, f"per-tick parity {tick} > {PARITY_TICK}")
    runs, launches = {}, {}
    with solved_grams() as grams:
        for name, model, chunk in (("twin_streamed", twin, STREAM_CHUNK),
                                   ("twin", twin, None), ("silicon_mr", SiliconMR(), None)):
            reset_counts()
            runs[name] = Experiment(cmt_config(model=model, stream_chunk_k=chunk),
                                    device=dev).run(*narma)
            launches[name] = launch_counts()
    check(launches == {"twin_streamed": (8, 0, 4), "twin": (2, 1, 0), "silicon_mr": (2, 1, 0)},
          f"calibration launches {launches}")
    delta = np.abs(runs["twin"].nrmse - runs["silicon_mr"].nrmse)
    check(float(delta.mean()) <= PARITY_NRMSE, f"twin vs SiliconMR mean |ΔNRMSE| {delta.mean()}")
    streamed = streamed_vs_materialized("CMT twin", grams[:2], runs["twin_streamed"],
                                        runs["twin"])
    emit({"phase": "cmt_calibration", "card": card, "B": B_MAIN, "N": cmt_config().n_nodes,
          "tick_parity_max_abs": tick, "tick_bound": PARITY_TICK,
          "small_signal": calibration_report(SiliconMR(), twin, device=dev),
          "nrmse_mean": {k: float(v.nrmse.mean()) for k, v in runs.items()},
          "abs_delta_nrmse": {"mean": float(delta.mean()), "max": float(delta.max()),
                              "bound_on_mean": PARITY_NRMSE},
          "launches": {k: {"dfr_scan": v[0], "ridge_gram": v[1], "ridge_gram_into": v[2]}
                       for k, v in launches.items()},
          "streamed_twin_vs_materialized": streamed})


def phase_device_sweep(dev, card: str) -> None:
    """The (detuning × loss × power) robustness map at the benchmark's full
    size: 60 lanes on the calibrated twin, N = 64, NARMA10 of 1200 samples,
    streamed (chunk 128) on the ``fast`` path with per-lane device
    parameters, the fold in plain matmuls.  Every cell finite, some cell
    stable (NRMSE ≤ 0.8), the stable map the JAX package's (a cell within
    SWEEP_TOL of the bound may flip: reported); wall time and peak device
    memory.

    The stable cells' states are held where the fit is well posed, as in
    ``phase_cmt_main``: K1 at each cell's point, a float64 ridge at λ =
    SWEEP_LAMS[-1] within SWEEP_TOL of the same fit on the reference's
    states.  The map's own f32 Gram/eigh NRMSE moves by up to 5e-3 on these
    cells in the reference itself when its inputs move by an ulp
    (tests/test_torch_devices.py::test_f32_readout_spread_is_the_references_own):
    held to PARITY_NRMSE there, and reported."""
    import numpy as np
    import torch

    from repro_torch.core import generate_states, make_mask, tasks
    from repro_torch.devices import SweepGrid, run_device_sweep
    from repro_torch.pipeline import ExperimentConfig
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    grid = SweepGrid(**SWEEP_GRID)
    ds = tasks.narma10(SWEEP_SAMPLES, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    res, sweep_s = wall(lambda: run_device_sweep(
        cmt_model(power_mw=0.0), grid, ds, n_nodes=SWEEP_N, washout=SWEEP_WASHOUT,
        stream_chunk_k=SWEEP_CHUNK, ridge_l2=SWEEP_LAMS, device=dev))
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    check(launches == (0, 0, 0), f"the sweep's fast path launched kernels {launches}")
    check(bool(np.all(np.isfinite(res.nrmse))), "sweep NRMSE finite")
    ref = grid.fold(np.asarray(SWEEP_REF_NRMSE))
    got_map = res.stable_region(nrmse_max=SWEEP_STABLE)["map"]
    ref_map = np.isfinite(ref) & (ref <= SWEEP_STABLE)
    flips = [{"cell": grid.point(tuple(int(v) for v in idx)), "nrmse": float(res.nrmse[idx]),
              "reference": float(ref[idx])} for idx in zip(*np.nonzero(got_map != ref_map))]
    for f in flips:
        check(abs(f["reference"] - SWEEP_STABLE) <= SWEEP_TOL,
              f"sweep cell {f['cell']} flips stability ({f['nrmse']} vs {f['reference']})")
    both = got_map & ref_map
    check(bool(both.any()), "no stable cell on the sweep map")
    gap = float(np.abs(res.nrmse[both] - ref[both]).max())
    check(gap <= PARITY_NRMSE, f"sweep NRMSE vs reference on stable cells {gap}")
    check([c for c, _ in SWEEP_REF_STABLE_F64] == np.flatnonzero(ref_map.ravel()).tolist(),
          "SWEEP_REF_STABLE_F64 does not list the reference's stable cells")
    twin = cmt_model(power_mw=0.0)
    j_tr, j_te = _input_layer(ExperimentConfig(), _canon_batch(ds.inputs_train, "tr", dev),
                              _canon_batch(ds.inputs_test, "te", dev))
    mask = make_mask(SWEEP_N, seed=1, device=dev)
    cells = []
    for flat, want in SWEEP_REF_STABLE_F64:
        model = sweep_cell_model(twin, grid, flat)
        st_tr, fin = generate_states(model, j_tr, mask, method="kernel", return_final=True,
                                     device=dev)
        st_te = generate_states(model, j_te, mask, s0=fin, method="kernel", device=dev)
        got = ridge64_nrmse(st_tr, ds.targets_train[None], st_te, ds.targets_test[None],
                            lam=SWEEP_LAMS[-1], washout=SWEEP_WASHOUT)[0]
        cells.append({"cell": grid.point(np.unravel_index(flat, grid.shape)),
                      "f64_ridge_nrmse": got, "f64_reference": want, "f64_gap": abs(got - want),
                      "map_nrmse": float(res.nrmse.ravel()[flat]),
                      "map_reference": float(ref.ravel()[flat])})
        check(cells[-1]["f64_gap"] <= SWEEP_TOL,
              f"sweep cell {cells[-1]['cell']}: float64-ridge NRMSE {got} vs reference {want}")
    t_split = SWEEP_SAMPLES // 2
    state_bytes = grid.size * t_split * SWEEP_N * 4
    emit({"phase": "device_sweep", "card": card, "lanes": grid.size, "grid": SWEEP_GRID,
          "N": SWEEP_N, "samples": SWEEP_SAMPLES, "chunk": SWEEP_CHUNK, "method": "fast",
          "launches": {"dfr_scan": launches[0], "ridge_gram": launches[1],
                       "ridge_gram_into": launches[2]},
          "wall_s": sweep_s, "node_ticks": SWEEP_SAMPLES * SWEEP_N,
          "wall_us_per_node_tick": sweep_s / (SWEEP_SAMPLES * SWEEP_N) * 1e6,
          "peak_bytes": peak, "allocated_before": before,
          "state_tensor_bytes_per_split": state_bytes,
          "peak_over_quarter_state": (peak - before) / (state_bytes / 4),
          "stable_map_equals_reference": not flips, "flips_near_bound": flips,
          "stable_map_nrmse_max_gap": gap, "stable_cells_f64": cells,
          "tolerance": {"f64_ridge": SWEEP_TOL, "map": PARITY_NRMSE},
          "summary": res.stable_region(nrmse_max=SWEEP_STABLE)["summary"],
          "nrmse_map": np.round(res.nrmse, 5).tolist()})


def phase_fast_path(dev, card: str) -> None:
    """``generate_states(method="fast")`` on the card, each shape of
    FAST_SHAPES once, against K1 at the same inputs: SiliconMR's sequential
    chain bitwise (the kernel runs its ops exactly); MackeyGlass's log-depth
    affine scan within 1e-5 (another rounding, and powf); Literal's boolean
    scan within 1e-5 of its largest finite state, with the same non-finite
    states (its states overflow)."""
    import numpy as np
    import torch

    from repro_torch.core import (MackeyGlass, SiliconMR, SiliconMRLiteral, generate_states,
                                  make_mask)

    models = {"SiliconMR": (SiliconMR(), (0.0, 1.0)), "MackeyGlass": (MackeyGlass(), (-1.0, 1.0)),
              "SiliconMRLiteral": (SiliconMRLiteral(), (0.0, 1.0))}
    rng = np.random.default_rng(7)
    out = {}
    for name, (b, k, n) in FAST_SHAPES.items():
        model, levels = models[name]
        j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32, device=dev)
        mask = make_mask(n, levels=levels, seed=1, device=dev)
        fast, fast_s = wall(lambda: generate_states(model, j, mask, method="fast", device=dev))
        kern = generate_states(model, j, mask, method="kernel", device=dev)
        kernel_ms = cuda_ms(lambda: generate_states(model, j, mask, method="kernel", device=dev))
        finite = torch.isfinite(kern)
        check(torch.equal(finite, torch.isfinite(fast)), f"{name}: fast vs K1 non-finite states")
        err = max_err(fast[finite], kern[finite])
        scale = max(1.0, float(kern[finite].abs().max())) if name == "SiliconMRLiteral" else 1.0
        tol = 0.0 if name == "SiliconMR" else 1e-5
        check(err <= tol * scale, f"{name}: fast vs K1 {err} > {tol} x {scale}")
        out[name] = {"shape_bkn": [b, k, n], "fast_wall_s": fast_s, "kernel_ms": kernel_ms,
                     "fast_over_kernel": fast_s * 1e3 / kernel_ms, "max_abs_err_vs_kernel": err,
                     "state_scale": scale, "bitwise": bool(torch.equal(fast, kern)),
                     "nonfinite_states": int((~finite).sum())}
    emit({"phase": "fast_path", "card": card, "by_model": out})


def main_point(task: str = "narma10", accelerator: str = "Silicon MR"):
    """The paper's operating point of one cell, ``dfrc_tasks()[task]
    [accelerator]`` (a DFRCConfig); the main path runs NARMA10 on Silicon MR."""
    from repro_torch.configs import dfrc_tasks

    return dfrc_tasks()[task][accelerator]


def fig_cells():
    """(cell, dataset key, task, accelerator, metric) of every Fig. 5/6 cell."""
    keys = [("narma10", "narma10", "nrmse"), ("santa_fe", "santa_fe", "nrmse")]
    keys += [(f"channel_eq@{snr}dB", "channel_eq", "ser") for snr in FIG_SNRS]
    return [(f"{key}/{acc}", key, task, acc, metric)
            for key, task, metric in keys for acc in FIG_ACCELERATORS]


def figure_inputs(tasks, n_seeds: int) -> dict:
    """The stacked task seeds 0..n_seeds-1 of every Fig. 5/6 dataset key."""
    data = {"narma10": stack([tasks.narma10(2000, seed=s) for s in range(n_seeds)]),
            "santa_fe": tasks.santa_fe_seeds(6000, range(n_seeds))}
    for snr in FIG_SNRS:
        data[f"channel_eq@{snr}dB"] = stack([
            tasks.channel_equalization(9000, snr_db=float(snr), seed=s) for s in range(n_seeds)])
    return data


def figure_config(task: str, accelerator: str, **kw):
    """``ExperimentConfig.from_dfrc`` of the cell's operating point on K1,
    with the readout it gives (the SVD); ``kw`` overrides fields."""
    from repro_torch.pipeline import ExperimentConfig

    return dataclasses.replace(ExperimentConfig.from_dfrc(main_point(task, accelerator)),
                               state_method="kernel", **kw)


def split_states(cfg, mask, batch, dev):
    """K1's train and test states of ``batch`` through the pipeline's input
    layer, the test split resumed from the train split's carry."""
    from repro_torch.core import generate_states
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    j_tr, j_te = _input_layer(cfg, _canon_batch(batch[0], "inputs_train", dev),
                              _canon_batch(batch[2], "inputs_test", dev))
    st_tr, fin = generate_states(cfg.model, j_tr, mask, method="kernel", return_final=True,
                                 device=dev)
    return st_tr, generate_states(cfg.model, j_te, mask, s0=fin, method="kernel", device=dev)


def gcv64_scores(x, y, lambdas) -> list[float]:
    """The SVD readout's GCV score of each λ (``solve_gcv_svd``'s formula,
    λ' = λ·mean σ²) in float64, for features x [T, F] and targets y [T, C]:
    the scores of exact arithmetic, where an f32 pick may be round-off."""
    import torch

    x64, y64 = x.double(), y.double()
    u, s, _ = torch.linalg.svd(x64, full_matrices=False)
    uty = u.mT @ y64
    uy2, y2, s2 = torch.sum(uty * uty, dim=-1), float(torch.sum(y64 * y64)), s * s
    t = x.shape[0]
    out = []
    for lam in lambdas:
        shrink = s2 / (s2 + lam * torch.sum(s2) / x.shape[1])
        rss = max(y2 - float(torch.sum((2.0 * shrink - shrink * shrink) * uy2)), 0.0)
        out.append(t * rss / max(t - float(torch.sum(shrink)), 1.0) ** 2)
    return out


def hold_figure_seeds(dev, cell: str, cfg, mask, batch, metric: str, res_on) -> dict:
    """Seeds 0..3 of one Fig. 5/6 cell against the JAX package: noise off
    (a run of those seeds) within FIG_NRMSE_TOL / FIG_SER_TOL of FIG_REF_OFF
    unless the λ picks differ and tie in float64 GCV on the card's features
    (``gcv64_scores``), or, for
    a FIG_PIPELINE_EXEMPT cell, not at all; a float64 ridge on the card's
    noise-off states within FIG_F64_TOL of FIG_REF_F64; noise on
    (``res_on``, the B_MAIN run) within the noise bands of FIG_REF_ON."""
    import numpy as np
    import torch

    from repro_torch.pipeline import Experiment, with_bias

    ref_vals, ref_lams = FIG_REF_OFF[cell]
    n = len(ref_vals)
    seeds4 = tuple(x[:n] for x in batch)
    off = Experiment(dataclasses.replace(cfg, state_noise_rel=0.0), device=dev).run(*seeds4)
    got = getattr(off, metric)
    tol, band = ((FIG_NRMSE_TOL, FIG_NOISE_NRMSE_BAND) if metric == "nrmse"
                 else (FIG_SER_TOL, FIG_NOISE_SER_BAND))
    out = {"noise_off": [], "noise_on": []}
    st_tr, st_te = split_states(cfg, mask, seeds4, dev)
    f64 = ridge64_nrmse(st_tr, seeds4[1], st_te, seeds4[3], lam=FIG_F64_LAM,
                        washout=cfg.washout)
    lams = np.asarray(cfg.ridge_l2, dtype=np.float32)
    for i in range(n):
        row = {"seed": i, "value": float(got[i]), "reference": ref_vals[i],
               "gap": abs(float(got[i]) - ref_vals[i]), "lam": float(off.lam[i]),
               "reference_lam": ref_lams[i], "f64_ridge_nrmse": f64[i],
               "f64_reference": FIG_REF_F64[cell][i],
               "f64_gap": abs(f64[i] - FIG_REF_F64[cell][i])}
        check(row["f64_gap"] <= FIG_F64_TOL,
                    f"{cell} seed {i}: float64-ridge NRMSE {f64[i]} vs {FIG_REF_F64[cell][i]}")
        if cell in FIG_PIPELINE_EXEMPT:
            pass
        elif row["gap"] > tol:
            own, other = (int(np.argmin(np.abs(lams - v))) for v in (off.lam[i], ref_lams[i]))
            score = gcv64_scores(with_bias(st_tr[i, cfg.washout:]),
                                 torch.as_tensor(seeds4[1][i, cfg.washout:, None], device=dev),
                                 cfg.ridge_l2)
            row["gcv64_rel_gap_to_reference_lam"] = rel = abs(score[other] - score[own]) / min(
                score[other], score[own])
            check(own != other and rel <= GCV_TIE_RTOL,
                        f"{cell} seed {i}: noise-off {metric} {got[i]} vs reference "
                        f"{ref_vals[i]} (λ {off.lam[i]} vs {ref_lams[i]}, GCV gap {rel})")
        out["noise_off"].append(row)
        on = float(getattr(res_on, metric)[i])
        out["noise_on"].append({"seed": i, "value": on, "reference": FIG_REF_ON[cell][i],
                                "gap": abs(on - FIG_REF_ON[cell][i])})
        check(abs(on - FIG_REF_ON[cell][i]) <= band,
                    f"{cell} seed {i}: noise-on {metric} {on} vs reference {FIG_REF_ON[cell][i]}")
    out["tolerance"] = {"noise_off": None if cell in FIG_PIPELINE_EXEMPT else tol,
                        "noise_on": band, "gcv_tie_rtol": GCV_TIE_RTOL, "f64_ridge": FIG_F64_TOL}
    return out


def figure_reductions(means: dict, seed0: dict) -> dict:
    """The accelerator comparisons of benchmarks/fig5_nrmse.py:39-45 and
    fig6_ser.py:34-35 (1 - MR/MZI; Fig. 6 on the SER averaged over the SNRs;
    MR/MG on NARMA10), from seed 0 as the benchmarks run it and from the
    B_MAIN-seed means, beside the paper's."""
    def fig6(vals, acc):
        return float(sum(vals[f"channel_eq@{snr}dB/{acc}"] for snr in FIG_SNRS) / len(FIG_SNRS))

    out = {}
    for name, vals in (("seed0", seed0), ("mean_over_seeds", means)):
        red = {t: 1.0 - vals[f"{t}/Silicon MR"] / vals[f"{t}/All Optical (MZI)"]
               for t in ("narma10", "santa_fe")}
        red["channel_eq"] = 1.0 - fig6(vals, "Silicon MR") / max(
            fig6(vals, "All Optical (MZI)"), 1e-9)
        out[name] = {"mr_vs_mzi_reduction": red,
                     "narma10_mr_vs_mg_ratio": vals["narma10/Silicon MR"]
                     / vals["narma10/Electronic (MG)"],
                     "channel_eq_mean_ser": {acc: fig6(vals, acc) for acc in FIG_ACCELERATORS}}
    out["paper_mr_vs_mzi_reduction"] = FIG_PAPER_CLAIMS
    return out


def phase_paper_figures(dev, tasks, card: str) -> dict:
    """Fig. 5 and Fig. 6 on the card: every cell of ``fig_cells`` over B_MAIN
    task seeds through ``Experiment.run`` of ``figure_config`` (K1 ×2, the
    SVD readout, sampled digitiser noise), then the K2 Gram + eigh readout
    on the same states (the same K1 launches and noise draws); per cell the
    metric's mean/min/max, the λ picks, the run's wall seconds and its
    ``states`` and ``solve`` stages, and seeds 0..3 held to the JAX package
    (``hold_figure_seeds``); then the accelerator comparisons
    (``figure_reductions``).  Every value finite."""
    import numpy as np

    from repro_torch.pipeline import Experiment, record_stages

    t0 = time.perf_counter()
    data = figure_inputs(tasks, B_MAIN)
    inputs_s = time.perf_counter() - t0
    rows, means, seed0, launches = {}, {}, {}, {}
    for cell, key, task, acc, metric in fig_cells():
        cfg = figure_config(task, acc)
        batch = data[key]
        exp = Experiment(cfg, device=dev)
        reset_counts()
        with record_stages() as stages:
            res, run_s = wall(lambda: exp.run(*batch))
        k1 = launch_counts()
        check(k1 == (2, 0, 0), f"{cell}: launches (scan, gram, into) = {k1}")
        form = f"{type(cfg.model).__name__} N={cfg.n_nodes}"
        launches[form] = launches.get(form, 0) + k1[0]
        vals = getattr(res, metric)
        check(vals.shape == (B_MAIN,) and bool(np.all(np.isfinite(vals)))
              and bool(np.all(np.isfinite(res.y_pred))), f"{cell}: {metric} not finite")
        gram = Experiment(dataclasses.replace(cfg, readout_use_kernel=True),
                          device=dev).run(*batch)
        gvals = getattr(gram, metric)
        check(bool(np.all(np.isfinite(gvals))), f"{cell}: Gram readout {metric} not finite")
        means[cell], seed0[cell] = float(vals.mean()), float(vals[0])
        rows[cell] = {
            "N": cfg.n_nodes, "metric": metric, "mean": means[cell], "min": float(vals.min()),
            "max": float(vals.max()),
            "lam_counts": {str(v): int(c) for v, c in zip(*np.unique(res.lam,
                                                                     return_counts=True))},
            "run_wall_s": run_s,
            "states_s": stages.get("states_train", 0.0) + stages.get("states_test", 0.0),
            "solve_s": stages.get("solve", 0.0),
            "gram_eigh_readout": {"mean": float(gvals.mean()), "min": float(gvals.min()),
                                  "max": float(gvals.max())},
            "held": hold_figure_seeds(dev, cell, cfg, exp.mask, batch, metric, res)}
    emit({"phase": "paper_figures", "card": card, "B": B_MAIN, "cells": rows,
          "k1_launches_by_form": launches, "inputs_host_s": inputs_s,
          "comparisons": figure_reductions(means, seed0),
          "seconds": time.perf_counter() - t0})
    return {"data": data, "launches": launches}


def composed_topologies():
    """The depth × loops grid of benchmarks/composed_reservoirs.py:91-118,
    every cell at 48 virtual nodes: the paper's SiliconMR, a slower ring
    (τ_ph = 150 ps) and a sin² link at gain 0.28 (:84-88)."""
    from repro_torch.core import ReservoirStage as S
    from repro_torch.core import SiliconMR, chain

    paper, slow = SiliconMR(), SiliconMR(tau_ph_ps=150.0)
    sin2 = dict(link="sin2", link_gain=0.28)
    return {
        "d1_l1_baseline": chain(S(model=paper, n_nodes=48, mask_seed=3)),
        "d1_l2": chain(S(model=paper, n_nodes=24, loops=2, mask_seed=3)),
        "d2_l1": chain(S(model=slow, n_nodes=40, mask_seed=3, **sin2),
                       S(model=paper, n_nodes=8, mask_seed=10)),
        "d2_l2": chain(S(model=slow, n_nodes=20, loops=2, mask_seed=3, **sin2),
                       S(model=paper, n_nodes=8, mask_seed=10)),
        "d3_l1": chain(S(model=slow, n_nodes=36, mask_seed=3, **sin2),
                       S(model=paper, n_nodes=8, mask_seed=10, **sin2),
                       S(model=paper, n_nodes=4, mask_seed=17)),
        "d3_l2": chain(S(model=slow, n_nodes=16, loops=2, mask_seed=3, **sin2),
                       S(model=paper, n_nodes=6, loops=2, mask_seed=10, **sin2),
                       S(model=paper, n_nodes=4, mask_seed=17)),
    }


def composed_config(graph, **kw):
    """The composed MC probe's Experiment config on K1 and K3, noise off."""
    from repro_torch.pipeline import ExperimentConfig

    base = dict(n_nodes=graph.width, washout=MC_WASHOUT, ridge_l2=MC_LAMS, topology=graph,
                stream_chunk_k=MC_CHUNK, state_method="kernel", readout_use_kernel=True,
                state_noise_rel=0.0)
    base.update(kw)
    return ExperimentConfig(**base)


def ridge64_mc(x, y, x_te, y_te, lam: float) -> list[float]:
    """The memory capacity of a float64 ridge at ``lam`` (λ' = λ·tr(G)/F)
    on each instance's bias-extended features: x [B, T, F] with targets
    y [B, T, D], scored on x_te [B, T', F] against y_te [B, T', D]."""
    import torch

    from repro_torch.core.metrics import memory_capacity_score

    out = []
    for i in range(x.shape[0]):
        x64 = torch.as_tensor(x[i]).double()
        g = x64.mT @ x64
        lamp = lam * float(torch.trace(g)) / g.shape[-1]
        w = torch.linalg.solve(g + lamp * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device),
                               x64.mT @ torch.as_tensor(y[i], device=g.device).double())
        pred = (torch.as_tensor(x_te[i], device=g.device).double() @ w).cpu().numpy()
        out.append(memory_capacity_score(y_te[i], pred))
    return out


def composed_features(graph, batch, washout: int, dev, method: str = "kernel"):
    """The graph's bias-extended features of ``batch`` (materialized by
    ``graph_states``, through the input layer of ``composed_config``; the
    test split resumed from the train split): (fit rows [B, T - washout, F],
    test rows [B, T', F])."""
    from repro_torch.core import build_stage_masks, graph_states
    from repro_torch.pipeline import with_bias
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    masks = build_stage_masks(graph, device=dev)
    j_tr, j_te = _input_layer(composed_config(graph), _canon_batch(batch[0], "inputs_train", dev),
                              _canon_batch(batch[2], "inputs_test", dev))
    f_tr, fin = graph_states(graph, j_tr, masks, method=method, return_final=True, device=dev)
    f_te = graph_states(graph, j_te, masks, s0=fin, method=method, device=dev)
    return with_bias(f_tr[:, washout:]), with_bias(f_te)


def composed_f64_mc(graph, batch, washout: int, dev, method: str = "kernel") -> list[float]:
    """``ridge64_mc`` at COMPOSED_F64_LAM on ``composed_features``."""
    x_tr, x_te = composed_features(graph, batch, washout, dev, method)
    return ridge64_mc(x_tr, batch[1][:, washout:], x_te, batch[3], COMPOSED_F64_LAM)


def exact_gram_mc(x, y, x_te, y_te, dev) -> tuple[list[float], list[float]]:
    """(MC, λ) of each instance under the pipeline's f32 GCV solve
    (``solve_gcv``) on ``dev``, fed the exact statistics of its features x
    [B, T, F] and targets y [B, T, D]: G = XᵀX and c = Xᵀy summed in float64
    and rounded once to f32, so no fold's summation order enters; scored on
    x_te [B, T', F] against y_te."""
    import torch

    from repro_torch.core.metrics import memory_capacity_score
    from repro_torch.pipeline import solve_gcv

    x64, y64 = torch.as_tensor(x).double(), torch.as_tensor(y, device=x.device).double()
    g, c = (x64.mT @ x64).float().to(dev), (x64.mT @ y64).float().to(dev)
    y32 = y64.float().to(dev)
    w, idx = solve_gcv(g, c, torch.sum(y32 * y32, dim=(1, 2)), x.shape[1], MC_LAMS)
    pred = (torch.as_tensor(x_te).float().to(dev) @ w).cpu().numpy()
    return ([memory_capacity_score(y_te[i], pred[i]) for i in range(x.shape[0])],
            [MC_LAMS[int(i)] for i in idx])


def phase_composed(dev, tasks, card: str) -> dict:
    """Composed reservoir graphs on the card (Queue 1 item 10): the six
    topologies of ``composed_topologies`` on the MC probe over B_MAIN seeds,
    K1 once a stage a chunk (the loops of a stage folded into per-lane
    lanes) and K3 once a fit chunk; seeds 0..2 held to the JAX package (the
    run, the run with the plain fold, and the exact Gram of its features
    solved on the host: where the f32 MC's gap comes from); the best
    composed cell beats the single loop by MC_MARGIN; a depth-1 graph
    is the single-loop streamed fit bitwise (w, λ index, carry); d3_l2
    through K1 is its ``fast`` path bitwise; the chain resumed at three
    uneven cuts folds into the Gram of one pass bitwise; d3_l2 at K =
    COMPOSED_LONG_K a split holds under a quarter of one split's
    [B, K, 48] f32 tensor; the d2_l1 topology per WDM channel at R = B_MAIN."""
    import numpy as np
    import torch

    from repro_torch.core import build_stage_masks, make_mask
    from repro_torch.core.metrics import memory_capacity_score
    from repro_torch.pipeline import (Experiment, WDMExperiment, composed_chunk_states_fn,
                                      fit_ridge_streaming, fit_ridge_streaming_composed,
                                      solve_gcv, with_bias)
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer
    from repro_torch.pipeline.ridge import _fold_chunk, _plan_fold

    t0 = time.perf_counter()
    mc = stack([tasks.memory_capacity(MC_SAMPLES, max_delay=MC_MAX_DELAY, seed=s)
                for s in range(B_MAIN)])
    topo = composed_topologies()
    k_split = mc[0].shape[1]
    n_chunks = -(-k_split // MC_CHUNK)
    cells, launches = {}, {"dfr_scan": 0, "ridge_gram_into": 0}
    n = COMPOSED_SEEDS
    for name, g in topo.items():
        exp = Experiment(composed_config(g), device=dev)
        reset_counts()
        res, run_s = wall(lambda: exp.run(*mc))
        k1, k2, k3 = launch_counts()
        check((k1, k2, k3) == (2 * n_chunks * g.depth, 0, n_chunks),
              f"{name}: launches (scan, gram, into) = {(k1, k2, k3)}")
        launches["dfr_scan"] += k1
        launches["ridge_gram_into"] += k3
        check(res.readout_w.shape == (B_MAIN, g.width + 1, MC_MAX_DELAY)
              and bool(np.all(np.isfinite(res.y_pred))), f"{name}: readout or predictions")
        mcs = [memory_capacity_score(mc[3][b], res.y_pred[b]) for b in range(B_MAIN)]
        first = tuple(x[:n] for x in mc)
        x_tr, x_te = composed_features(g, first, MC_WASHOUT, dev)
        f64 = ridge64_mc(x_tr, first[1][:, MC_WASHOUT:], x_te, first[3], COMPOSED_F64_LAM)
        # where the f32 MC's gap comes from: the same run with the plain
        # fold (cuBLAS in place of K3), and the f32 solve fed the exact
        # Gram of the same K1 features on the card and on the host
        plain = Experiment(composed_config(g, readout_use_kernel=False), device=dev).run(*mc)
        witness = {"plain_fold": ([memory_capacity_score(mc[3][b], plain.y_pred[b])
                                   for b in range(n)], [float(v) for v in plain.lam[:n]])}
        for where in ("card", "cpu"):
            witness[f"exact_gram_{where}_solve"] = exact_gram_mc(
                x_tr, first[1][:, MC_WASHOUT:], x_te, first[3],
                dev if where == "card" else torch.device("cpu"))
        seeds = []
        for i in range(n):
            ref = COMPOSED_REF_MC[name][i]
            row = {"seed": i, "mc": mcs[i], "reference": ref,
                   "gap": abs(mcs[i] - ref), "lam": float(res.lam[i]),
                   "f64_ridge_mc": f64[i], "f64_reference": COMPOSED_REF_MC_F64[name][i],
                   "f64_gap": abs(f64[i] - COMPOSED_REF_MC_F64[name][i])}
            for path, (vals, lams) in witness.items():
                row[path] = {"mc": vals[i], "gap": abs(vals[i] - ref), "lam": lams[i]}
            check(row["f64_gap"] <= COMPOSED_F64_TOL,
                        f"{name} seed {i}: float64-ridge MC {f64[i]} vs {row['f64_reference']}")
            if name not in COMPOSED_F32_EXEMPT:
                for what, gap, tol in (
                        ("K3 fold", row["gap"], COMPOSED_MC_TOL),
                        ("plain fold", row["plain_fold"]["gap"], COMPOSED_MC_TOL),
                        ("exact Gram, host solve", row["exact_gram_cpu_solve"]["gap"],
                         COMPOSED_HOST_MC_TOL)):
                    check(gap <= tol, f"{name} seed {i}: MC ({what}) {gap} from the reference "
                          f"{ref}")
            seeds.append(row)
        cells[name] = {"depth": g.depth, "loops": max(st.loops for st in g.stages),
                       "width": g.width, "mc_mean": float(np.mean(mcs)),
                       "mc_min": float(np.min(mcs)), "mc_max": float(np.max(mcs)),
                       "launches": {"dfr_scan": k1, "ridge_gram_into": k3},
                       "run_wall_s": run_s, "host_ms_per_chunk": run_s * 1e3 / (2 * n_chunks),
                       "first_seeds_vs_reference": seeds}
    base = cells["d1_l1_baseline"]["mc_mean"]
    best = max((c for c in cells if c != "d1_l1_baseline"), key=lambda c: cells[c]["mc_mean"])
    margin = cells[best]["mc_mean"] - base
    check(margin >= MC_MARGIN, f"best composed {best} beats the single loop by {margin}")

    # depth 1 == the single-loop streamed fit, bitwise (w, λ index, carry)
    g1 = topo["d1_l1_baseline"]
    st = g1.stages[0]
    j_tr, _ = _input_layer(composed_config(g1), _canon_batch(mc[0], "inputs_train", dev),
                           _canon_batch(mc[2], "inputs_test", dev))
    y_tr = torch.as_tensor(mc[1], dtype=torch.float32, device=dev)
    kw = dict(washout=MC_WASHOUT, chunk_k=MC_CHUNK, lambdas=MC_LAMS, device=dev)
    w_c, i_c, s_c = fit_ridge_streaming_composed(g1, build_stage_masks(g1, device=dev), j_tr,
                                                 y_tr, **kw)
    w_s, i_s, s_s = fit_ridge_streaming(st.model, make_mask(st.n_nodes, seed=st.mask_seed,
                                                            device=dev), j_tr, y_tr, **kw)
    check(torch.equal(w_c, w_s) and torch.equal(i_c, i_s) and torch.equal(s_c[0][:, 0], s_s),
          "a depth-1 topology is not the single-loop streamed fit bitwise")

    # d3_l2 through K1 == its fast path, bitwise
    g3 = topo["d3_l2"]
    res_k = Experiment(composed_config(g3), device=dev).run(*mc)
    res_f, fast_s = wall(lambda: Experiment(composed_config(g3, state_method="fast"),
                                            device=dev).run(*mc))
    check(all(np.array_equal(getattr(res_k, f), getattr(res_f, f))
              for f in ("readout_w", "lam", "y_pred", "nrmse")),
          "d3_l2 through K1 is not its fast path bitwise")

    # the chain resumed at three uneven cuts folds into one pass's Gram
    masks3 = build_stage_masks(g3, device=dev)
    fn = composed_chunk_states_fn(g3, masks3, device=dev)
    plan = _plan_fold(g3.width + 1, k_split, use_kernel=True, block_t=512, n_cols=MC_MAX_DELAY,
                      batch=B_MAIN)

    def fold(bounds):
        f = g3.width + 1
        gm = torch.zeros((B_MAIN, f, f), device=dev)
        cm = torch.zeros((B_MAIN, f, MC_MAX_DELAY), device=dev)
        s = tuple(torch.zeros((B_MAIN, lp, w), device=dev) for lp, w in g3.carry_layout)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            feats, s = fn(j_tr[:, lo:hi].contiguous(), s)
            _fold_chunk(plan, gm, cm, torch.zeros(B_MAIN, device=dev), with_bias(feats),
                        y_tr[:, lo:hi].contiguous())
        return gm, cm, s

    cuts = (0, 37, 38, 421, k_split)
    one, cut = fold((0, k_split)), fold(cuts)
    y2 = torch.sum(y_tr * y_tr, dim=(1, 2))
    check(torch.equal(one[0], cut[0]) and torch.equal(one[1], cut[1])
          and all(torch.equal(a, b) for a, b in zip(one[2], cut[2]))
          and torch.equal(solve_gcv(one[0], one[1], y2, k_split, MC_LAMS)[0],
                          solve_gcv(cut[0], cut[1], y2, k_split, MC_LAMS)[0]),
          f"d3_l2 resumed at {cuts[1:-1]} is not one pass bitwise")
    del one, cut

    # the memory contract at K = COMPOSED_LONG_K a split
    long = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in stack([
        tasks.memory_capacity(2 * COMPOSED_LONG_K, max_delay=MC_MAX_DELAY, seed=s)
        for s in range(B_MAIN)])]
    state_bytes = B_MAIN * COMPOSED_LONG_K * g3.width * 4
    exp = Experiment(composed_config(g3, stream_chunk_k=COMPOSED_LONG_CHUNK,
                                     collect_y_pred=False), device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res_l, long_s = wall(lambda: exp.run(*long))
    peak = torch.cuda.max_memory_allocated() - before
    check(bool(np.all(np.isfinite(res_l.nrmse))), "long composed NRMSE finite")
    check(peak < state_bytes / 4, f"composed long stream: {peak} B above the start >= a quarter "
          f"of {state_bytes} B")
    del long

    # the d2_l1 topology per WDM channel
    g2 = topo["d2_l1"]
    reset_counts()
    wdm, wdm_s = wall(lambda: WDMExperiment(composed_config(g2), B_MAIN, device=dev).run(*mc))
    wdm_launches = launch_counts()
    check(wdm.readout_w.shape == (B_MAIN, g2.width + 1, MC_MAX_DELAY)
          and bool(np.all(np.isfinite(wdm.readout_w))) and bool(np.all(np.isfinite(wdm.nrmse))),
          f"WDM d2_l1 readouts {wdm.readout_w.shape}")
    emit({"phase": "composed", "card": card, "B": B_MAIN, "width": 48, "K_split": k_split,
          "chunk": MC_CHUNK, "cells": cells,
          "payoff": {"baseline_mc": base, "best_composed": best,
                     "best_composed_mc": cells[best]["mc_mean"], "margin": margin,
                     "required_margin": MC_MARGIN},
          "tolerance": {"mc": COMPOSED_MC_TOL, "exact_gram_host_solve_mc": COMPOSED_HOST_MC_TOL,
                        "f64_ridge_mc": COMPOSED_F64_TOL,
                        "mc_exempt": COMPOSED_F32_EXEMPT},
          "depth1_bitwise_single_loop": True, "d3_l2_kernel_bitwise_fast": True,
          "d3_l2_fast_wall_s": fast_s, "resume_cuts": cuts[1:-1], "resume_bitwise": True,
          "long_stream": {"K_split": COMPOSED_LONG_K, "chunk": COMPOSED_LONG_CHUNK,
                          "peak_bytes_above_start": peak, "allocated_at_start": before,
                          "state_tensor_bytes_per_split": state_bytes, "wall_s": long_s,
                          "nrmse_mean": float(np.mean(res_l.nrmse))},
          "wdm_d2_l1": {"R": B_MAIN, "readout_width": g2.width + 1, "wall_s": wdm_s,
                        "launches": {"dfr_scan": wdm_launches[0],
                                     "ridge_gram_into": wdm_launches[2]}},
          "seconds": time.perf_counter() - t0})
    return {"launches": launches, "graph": g3, "j": j_tr, "y": y_tr}


# the contracts phase: the gate at the registry's shapes, the block-copy
# fixture's tiles, and a long stream whose peak memory the card measures
CONTRACT_ENTRIES = 20
COPY_SHAPE = (2048, 1024)
COPY_TILE = (32, 256)
CONTRACT_LONG_K = 20000


def phase_side_checks(dev, card: str) -> dict:
    """The side process beside the scan kernel's edge grid (none of it
    timed): the scan kernel at the main width, K1ᵀ's and the Gram kernel's
    edge grids, then the contracts; returns the contracts' result."""
    phase_scan_checks(dev)
    phase_scan_grad_checks(dev)
    phase_gram_checks(dev)
    return phase_contracts(dev, card)


def phase_contracts(dev, card: str) -> dict:
    """The port's program contracts on the card (``repro_torch.analysis``):
    every registered entry point run once through K1-K3 under its rules,
    with the card's own checks (each kernel launched once a call, the run
    under ``set_sync_debug_mode("error")`` where an entry allows no sync
    site, the peak device memory); the seeded violation caught; the
    block-copy fixture under ``SmemBudget`` (an in-budget tile launches,
    the 8 MiB tile is flagged and refused before its launch); and
    ``NoStateTensor``'s peak-memory half on a K = 20000 streamed fit at the
    main width, under a quarter of one [B, K, N] f32 state tensor."""
    import numpy as np
    import torch

    from repro_torch.analysis import NoStateTensor, Program, SmemBudget, card_checks
    from repro_torch.analysis.cli import run
    from repro_torch.core import make_mask
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.pipeline import fit_ridge_streaming

    t0 = time.perf_counter()
    reset_counts()
    report = run(device=dev, seed_violation=True)
    entries = [e for e in report["entry_points"] if e["name"] != "seeded_violation"]
    (seeded,) = [e for e in report["entry_points"] if e["name"] == "seeded_violation"]
    n_viol = sum(e["n_violations"] for e in entries)
    for e in entries:
        check(e["ok"], f"contract entry {e['name']}: {e['rules']} {e.get('error', '')}")
        check(all(v[0] == v[1] for v in e["launches_calls"].values()),
              f"{e['name']}: launches != calls {e['launches_calls']}")
    check(len(entries) == CONTRACT_ENTRIES, f"{len(entries)} contract entries")
    check(not seeded["ok"] and any(v["rule"] == "NoStateTensor" and v["path"]
                                   for r in seeded["rules"] for v in r["violations"]),
          "the seeded violation was not caught")

    # the fixture: in budget it launches and copies bitwise; the whole-array
    # tile is flagged, and the wrapper refuses it before a launch
    x = torch.randn(COPY_SHAPE, device=dev)
    fits = Program(lambda a: copy_ops.block_copy(a, COPY_TILE), (x,), name="block_copy")
    check(not SmemBudget().check(fits) and not card_checks(fits, (SmemBudget(),))
          and torch.equal(fits.trace.result, x), "block_copy in budget")
    over = Program(lambda a: copy_ops.block_copy(a, COPY_SHAPE), (x,), name="block_copy_over")
    flagged = SmemBudget().check(over)
    check(bool(flagged) and isinstance(over.error, ValueError)
          and over.counts["block_copy"] == (0, 1), f"block_copy over budget: {flagged}")

    # NoStateTensor's peak-memory half at the main width
    rng = np.random.default_rng(5)
    n_nodes = stream_config().n_nodes
    j = torch.as_tensor(rng.uniform(0, 1, (B_MAIN, CONTRACT_LONG_K)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.uniform(0, 1, (B_MAIN, CONTRACT_LONG_K)), dtype=torch.float32,
                        device=dev)
    mask = make_mask(n_nodes, seed=1, device=dev)
    state_bytes = B_MAIN * CONTRACT_LONG_K * n_nodes * 4
    long_rule = NoStateTensor(CONTRACT_LONG_K, B_MAIN * CONTRACT_LONG_K * n_nodes,
                              max_peak_bytes=state_bytes // 4)
    torch.cuda.empty_cache()
    long = Program(lambda jj, yy: fit_ridge_streaming(
        stream_config().model, mask, jj, yy, washout=60, chunk_k=STREAM_CHUNK,
        lambdas=(1e-6,), use_kernel=True, device=dev), (j, y), name="long_stream_fit")
    long_viols = long_rule.check(long) + card_checks(long, ())
    check(not long_viols and long.error is None, f"long streamed fit: {long_viols} {long.error}")
    long_peak = long.peak_bytes
    del j, y, long
    copies = copy_ops.block_copy.launches
    check(copies >= 1, "the contracts phase launched no block_copy")
    emit({"phase": "contracts", "card": card, "entries": len(entries),
          "violations": n_viol, "launches_eq_calls": True, "seeded_caught": True,
          "torch": report["torch_version"], "device_name": report["device_name"],
          "entry_seconds": {e["name"]: e["seconds"] for e in entries},
          "peak_bytes": {e["name"]: e["peak_bytes"] for e in entries},
          "sync_sites": {e["name"]: sorted({s["op"] for s in e["syncs"]}) for e in entries},
          "block_copy": {"tile": list(COPY_TILE), "launches": copies,
                         "smem_flagged": [v.message for v in flagged]},
          "long_stream_fit": {"B": B_MAIN, "K": CONTRACT_LONG_K, "N": n_nodes,
                              "chunk": STREAM_CHUNK, "peak_bytes": long_peak,
                              "budget_bytes": state_bytes // 4},
          "seconds": time.perf_counter() - t0})
    return {"block_copy_launches": copies}


@contextlib.contextmanager
def plain_mixer():
    """Route the LM's reservoir mixer through the plain versions of the
    scan kernel and of its adjoint (on the card's tensors) for the body of
    the ``with``."""
    from repro_torch.core import layer as mixer
    from repro_torch.kernels.dfr_scan import ops as scan_ops

    scan, grad = mixer.dfr_scan, mixer.dfr_scan_grad
    mixer.dfr_scan, mixer.dfr_scan_grad = scan_plain, scan_ops.dfr_scan_grad_plain
    try:
        yield
    finally:
        mixer.dfr_scan, mixer.dfr_scan_grad = scan, grad


def profile_decode(cfg, params, served: dict, n_steps: int = LM_PROFILE_STEPS) -> dict:
    """``profile_calls`` over ``n_steps`` more decode steps (the launcher's
    ``decode``) from a served batch's cache (served with that much slack)."""
    from repro_torch.launch import serve

    more = {"ids": [served["ids"][:, -1:]], "logits": [], "cache": served["cache"],
            "decode_step_s": []}
    return profile_calls(lambda: serve.decode(cfg, params, more), n_steps, "decode_steps")


def decode_vs_forward(cfg, params, prompts, served: dict, context=None) -> dict:
    """The served logits (prefill's last position, then each decode step)
    against one ``forward`` over the prompt and the served ids: the largest
    gap, and whether it is within the reference's decode bound."""
    import torch

    from repro_torch.models import forward

    toks = torch.cat([prompts, served["ids"][:, :-1]], dim=1)
    full, _ = forward(cfg, params, toks, context=context)
    want = full[:, prompts.shape[1] - 1:].float()
    got = served["logits"].float()
    gap = (got - want).abs()
    return {"max_abs_gap": float(gap.max()), "max_abs_logit": float(want.abs().max()),
            "max_gap_over_bound": float((gap / (DECODE_ATOL + DECODE_RTOL * want.abs())).max()),
            "within_reference_bound": bool(torch.allclose(got, want, atol=DECODE_ATOL,
                                                          rtol=DECODE_RTOL))}


def serving_report(cfg, served: dict, b: int, prompt: int = LM_SERVE_PROMPT) -> dict:
    import numpy as np

    steps = np.asarray(served["decode_step_s"])
    return {"B": b, "prompt": prompt, "new_tokens": served["ids"].shape[1],
            "dtype": cfg.dtype, "prefill_ms": served["prefill_s"] * 1e3,
            "decode_ms_per_token_p50": float(np.percentile(steps, 50) * 1e3),
            "decode_ms_per_token_p90": float(np.percentile(steps, 90) * 1e3),
            "decode_tokens_per_s": b * len(steps) / float(steps.sum()),
            "prefill_tokens_per_s": b * prompt / served["prefill_s"]}


@contextlib.contextmanager
def moe_meter(replay=None):
    """Record each MoE layer's routing for the body of the ``with``: a list,
    one top_e [B, S, k] a call of ``moe.route``, in call order.  With
    ``replay`` (one [B, S', k] a layer, S' >= S), each layer takes those
    experts in place of its own top-k, weighted by its own probabilities
    at them, renormalised: a forward that routes as a served run did."""
    import torch

    from repro_torch.models import moe

    route = moe.route
    log = []

    def metered(cfg, p, x):
        probs, top_p, top_e = route(cfg, p, x)
        if replay is not None:
            top_e = replay[len(log)][:, :x.shape[1]]
            top_p = torch.gather(probs, -1, top_e)
            top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
        log.append(top_e)
        return probs, top_p, top_e

    moe.route = metered
    try:
        yield log
    finally:
        moe.route = route


def moe_decode_vs_forward(cfg, params, prompts, new: int, context, own_factor: float) -> dict:
    """An MoE arch's served run (the launcher's ``generate``) under the
    meter, then forwards over the same tokens: the tokens whose expert set
    differs, in any MoE layer, between the served run and a forward (a
    near-tie that the two paths' rounding decides apart); decode held to a
    forward that takes the served run's experts (``decode_vs_forward``);
    and the share of slots a forward drops at the config's own capacity
    factor."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import forward, moe

    n_moe = cfg.moe_layers_per_unit * cfg.n_units
    with moe_meter() as log:
        served = serve.generate(cfg, params, prompts, new, context=context)
    routed = [torch.cat(log[layer::n_moe], dim=1) for layer in range(n_moe)]
    toks = torch.cat([prompts, served["ids"][:, :-1]], dim=1)
    with moe_meter() as own:
        forward(cfg, params, toks, context=context)
    differs = torch.zeros(toks.shape, dtype=torch.bool, device=toks.device)
    for mine, full in zip(routed, own, strict=True):
        differs |= (mine.sort(dim=-1).values != full.sort(dim=-1).values).any(-1)
    with moe_meter(replay=routed):
        dvf = decode_vs_forward(cfg, params, prompts, served, context)
    own_cfg = dataclasses.replace(cfg, capacity_factor=own_factor)
    with moe_meter() as own:
        forward(own_cfg, params, toks, context=context)
    cap = moe.capacity(own_cfg, toks.shape[1])
    dropped = sum(int((moe._group_positions(e.reshape(e.shape[0], -1), cfg.n_experts)
                       >= cap).sum()) for e in own)
    return {"decode_vs_forward": dvf, "routing": "the served run's experts",
            "expert_set_flips": int(differs.sum()), "tokens_compared": differs.numel(),
            "dropped_share_at_own_factor": {"capacity_factor": own_factor,
                                            "share": dropped / sum(e.numel() for e in own)}}


def row_split_spread(cfg, params, toks, context=None) -> float:
    """The largest gap between a batched forward's logits and its first
    row's alone: the same arithmetic at another GEMM shape, so how far the
    model carries the card's rounding."""
    from repro_torch.models import forward

    full, _ = forward(cfg, params, toks, context=context)
    one, _ = forward(cfg, params, toks[:1], context=None if context is None else context[:1])
    return float((full[:1].float() - one.float()).abs().max())


def tree_numel(node) -> int:
    """Elements of a params tree (dicts and tuples of tensors)."""
    if isinstance(node, dict):
        return sum(tree_numel(v) for v in node.values())
    if isinstance(node, tuple):
        return sum(tree_numel(v) for v in node)
    return node.numel()


def lm_arch_cell(dev, card: str, arch: str, n_layers: int, b: int, prompt: int, new: int,
                 dtypes) -> None:
    """One arch of LM_ARCH_CELLS at full width through the launcher's
    ``generate``: prefill ms, decode ms a token (p50, p90), tokens/s, decode
    held to one forward over the same tokens (f32: the reference's bound;
    bf16: DECODE_BF16_ATOL), a bf16 decode profile for LM_PROFILED.  An MoE
    arch serves at the dropless capacity factor E/k (cap = S: a forward over
    S tokens then drops no slot that a one-token decode keeps), with the
    share of slots its forward would drop at the config's own factor and,
    in bf16, the tokens whose expert set differs between decode and forward.
    Emits the cell's line; the params are freed before it returns."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=n_layers)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_s = wall(lambda: init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    for blk, unit in zip(cfg.unit, params["units"], strict=True):
        if blk.mixer == "cross_attn":
            unit["mixer/gate"].fill_(math.atanh(LM_CROSS_GATE))
    n_params = tree_numel(params)
    prompts = torch.as_tensor(lm_tokens(cfg, (b, prompt), 5), device=dev)
    ctx = lm_context(cfg, b, 6)
    ctx = None if ctx is None else torch.as_tensor(ctx, device=dev)
    rep = {"layers": n_layers, "of_layers": base.n_layers, "n_params": n_params,
           "param_bytes": 4 * n_params, "init_s": init_s,
           "context": None if ctx is None else list(ctx.shape)}
    if cfg.n_experts:
        rep["capacity_factor"] = cfg.capacity_factor
    if any(blk.mixer == "cross_attn" for blk in cfg.unit):
        rep["cross_gate_tanh"] = LM_CROSS_GATE
    if any(blk.mixer == "slstm" for blk in cfg.unit):
        rep["own_init_row_split_spread"] = row_split_spread(
            dataclasses.replace(cfg, dtype="float32"), params, prompts, ctx)
        calm_slstm(cfg, params)
        rep["slstm_r_rec_scale"] = "1/sqrt(head_dim)"
    for dtype in dtypes:
        c = dataclasses.replace(cfg, dtype=dtype)
        serve.generate(c, params, prompts[:, :8], 2, context=ctx)          # warm
        served = serve.generate(c, params, prompts, new, slack=LM_PROFILE_STEPS, context=ctx)
        r = serving_report(c, served, b, prompt)
        check(bool(torch.isfinite(served["logits"]).all()), f"{arch} {dtype}: logits")
        if cfg.n_experts:
            r.update(moe_decode_vs_forward(c, params, prompts, new, ctx, base.capacity_factor))
            dvf = r["decode_vs_forward"]
        else:
            r["decode_vs_forward"] = dvf = decode_vs_forward(c, params, prompts, served, ctx)
            toks = torch.cat([prompts, served["ids"][:, :-1]], dim=1)
            r["row_split_spread"] = row_split_spread(c, params, toks, ctx)
        if dtype == "float32":
            check(dvf["within_reference_bound"], f"{arch} f32 decode vs forward: {dvf}")
        else:
            bound = DECODE_BF16_ATOL_BY_ARCH.get(arch, DECODE_BF16_ATOL)
            dvf["bf16_atol"] = bound
            check(dvf["max_abs_gap"] <= bound, f"{arch} bf16 decode vs forward: {dvf}")
            if arch in LM_PROFILED:
                r["profile"] = profile_decode(c, params, served)
        rep[dtype] = r
        del served
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "lm_serving", "cell": arch, "card": card, **rep,
          "seconds": time.perf_counter() - t0})


def lm_smoke_vs_reference(dev) -> dict:
    """Each arch of LM_ARCH_CELLS at its smoke config in f32 on the numpy
    weights: the logit summary's gap to the JAX package's
    (LM_SMOKE_SUMMARY), checked within LM_SUMMARY_TOL."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import forward

    gaps = {}
    for arch, *_ in LM_ARCH_CELLS:
        cfg = smoke_config(arch)
        params = convert.lm_params_from_reference(lm_numpy_params(cfg, LM_SEED), device=dev)
        toks = torch.as_tensor(lm_tokens(cfg, LM_CHECK_SHAPE, LM_TOKENS_SEED), device=dev)
        ctx = lm_context(cfg, LM_CHECK_SHAPE[0], LM_CONTEXT_SEED)
        logits, _ = forward(cfg, params, toks,
                            context=None if ctx is None else torch.as_tensor(ctx, device=dev))
        check(bool(torch.isfinite(logits).all()), f"{arch} smoke logits not finite")
        gaps[arch] = summary_gap(lm_logit_summary(logits.cpu().numpy()), LM_SMOKE_SUMMARY[arch])
        check(gaps[arch] <= LM_SUMMARY_TOL, f"{arch} smoke f32 logits vs the JAX package: "
                                            f"{gaps[arch]}")
    return {"shape_bs": list(LM_CHECK_SHAPE), "summary_max_gap": gaps, "tol": LM_SUMMARY_TOL}


def phase_lm_serving(dev, card: str) -> dict:
    """The LM serving path (``repro_torch.models`` through
    ``runtime.steps.serve_prefill`` / ``serve_decode``) at full width:

    (a) reservoir_lm in f32 (12 layers, d 768, N 256, R 3, vocab 32000) on
        the numpy weights (``lm_numpy_params``, readout non-zero): the logit
        summary within LM_SUMMARY_TOL of the JAX package's, and K1 launched
        once a layer (launches == calls == 12 a forward);
    (b) reservoir_lm serving 8 requests of 512 prompt tokens, 64 new tokens,
        in bf16 (its config's dtype) and in f32: prefill ms, decode ms a
        token (p50, p90), tokens/s, K1 launched 12 times a prefill
        ([24, 512, 256]) and 12 times a decode step ([24, 1, 256]), each
        counted apart, and its share of a decode step; decode held to one
        forward over the same tokens (f32: the reference's bound; bf16:
        DECODE_BF16_ATOL);
    (c) the mixer on K1 against its plain route on the card, bitwise, at
        [4, 48] tokens (and 16 more resumed from its carry), f32 and bf16;
    (d) granite-8b at full width (36 layers, d 4096, GQA 32/8, f32 params
        ≈ 32 GB drawn on the card from a torch.Generator), prefill 4 × 128
        and 16 decode steps in f32 (decode held to its forward at the
        reference's bound) and in bf16 (timed, DECODE_BF16_ATOL); the chunked
        attention against the dense one at Skv 4096, chunk 1024;
    (e) each arch of LM_ARCH_CELLS: its smoke config against the JAX
        package's logits (``lm_smoke_vs_reference``), then its full-width
        cell on a line of its own (``lm_arch_cell``)."""
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import layer as mixer
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_params, layers

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}

    def k1_counts():
        return scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls

    # (a) full width, f32, against the JAX package's logits
    cfg32 = dataclasses.replace(get_config("reservoir_lm"), dtype="float32")
    host, draw_s = wall(lambda: lm_numpy_params(cfg32, LM_SEED))
    params = convert.lm_params_from_reference(host, device=dev)
    del host
    toks = torch.as_tensor(lm_tokens(cfg32, LM_CHECK_SHAPE, LM_TOKENS_SEED), device=dev)
    reset_counts()
    (logits, _), fwd_s = wall(lambda: forward(cfg32, params, toks))
    counts = k1_counts()
    check(counts == (cfg32.n_layers, cfg32.n_layers),
          f"reservoir_lm forward: K1 (launches, calls) {counts}, want {cfg32.n_layers} each")
    gap = summary_gap(lm_logit_summary(logits.cpu().numpy()), LM_REF_SUMMARY)
    check(bool(torch.isfinite(logits).all()) and logits.shape == (*LM_CHECK_SHAPE, 32000),
          f"reservoir_lm logits {tuple(logits.shape)} not finite")
    check(gap <= LM_SUMMARY_TOL, f"reservoir_lm f32 logits vs the JAX package: {gap}")
    out["reservoir_lm_f32_vs_reference"] = {
        "shape_bs": list(LM_CHECK_SHAPE), "summary_max_gap": gap, "tol": LM_SUMMARY_TOL,
        "k1_launches_calls": list(counts), "numpy_draw_s": draw_s, "forward_s": fwd_s}

    # (b) serving 8 requests: bf16 (timed), then f32 (held to its forward)
    prompts = torch.as_tensor(lm_tokens(cfg32, (LM_SERVE_B, LM_SERVE_PROMPT), 2), device=dev)
    cfg16 = get_config("reservoir_lm")
    check(cfg16.dtype == "bfloat16", f"reservoir_lm serves in {cfg16.dtype}")
    serve.generate(cfg16, params, prompts[:, :16], 4)                    # warm
    # the launcher's own steps, K1 counted over the prefill and over the
    # decode steps apart: 12 launches a prefill, 12 a decode step
    reset_counts()
    served16 = serve.start(cfg16, params, prompts, LM_SERVE_NEW, slack=LM_PROFILE_STEPS)
    prefill_counts = k1_counts()
    reset_counts()
    for _ in range(LM_SERVE_NEW - 1):
        serve.decode(cfg16, params, served16)
    decode_counts = k1_counts()
    served16 = serve.joined(served16)
    want = {"prefill": cfg16.n_layers, "decode": cfg16.n_layers * (LM_SERVE_NEW - 1)}
    for name, counts in (("prefill", prefill_counts), ("decode", decode_counts)):
        check(counts == (want[name], want[name]),
              f"reservoir_lm serving {name}: K1 (launches, calls) {counts}, want {want[name]}")
    rep16 = serving_report(cfg16, served16, LM_SERVE_B)
    rep16["k1_launches_calls"] = {"prefill": list(prefill_counts),
                                  "decode": list(decode_counts)}
    rep16["decode_vs_forward"] = dvf = decode_vs_forward(cfg16, params, prompts, served16)
    check(dvf["max_abs_gap"] <= DECODE_BF16_ATOL, f"reservoir_lm bf16 decode vs forward: {dvf}")
    rep16["profile"] = profile_decode(cfg16, params, served16)
    # K1 alone at the decode step's shape: 12 calls a step
    b_r = LM_SERVE_B * mixer._n_channels(cfg16)
    gen = torch.Generator(device=dev).manual_seed(3)
    j1 = torch.rand((b_r, 1), generator=gen, device=dev)
    s1 = torch.rand((b_r, cfg16.reservoir_nodes), generator=gen, device=dev) * 0.3
    mask = mixer._mask(cfg16.reservoir_nodes, dev)
    k1_ms = cuda_ms(lambda: scan_ops.dfr_scan(mixer._model(cfg16), j1, mask, s1, return_final=True,
                                             out_dtype=torch.bfloat16), reps=50)
    rep16["k1_decode_call_ms"] = k1_ms
    rep16["k1_share_of_decode_step_p50"] = (cfg16.n_layers * k1_ms
                                            / rep16["decode_ms_per_token_p50"])
    out["reservoir_lm_bf16_serving"] = rep16
    served32 = serve.generate(cfg32, params, prompts, LM_SERVE_NEW)
    rep32 = serving_report(cfg32, served32, LM_SERVE_B)
    rep32["decode_vs_forward"] = dvf = decode_vs_forward(cfg32, params, prompts, served32)
    check(dvf["within_reference_bound"], f"reservoir_lm f32 decode vs forward: {dvf}")
    out["reservoir_lm_f32_serving"] = rep32
    lm_drive = {"prefill_launches": prefill_counts[0], "decode_launches": decode_counts[0],
                "b_r": b_r}
    del served16, served32

    # (c) the mixer on K1 against its plain route, bitwise
    mp = {k[len("mixer/"):]: v[0] for k, v in params["units"][0].items()
          if k.startswith("mixer/")}
    b, s = LM_MIXER_CHECK
    h = torch.randn((b, s + 16, cfg32.d_model), generator=gen, device=dev)
    mixer_checks = {}
    for dt in (torch.float32, torch.bfloat16):
        x = h.to(dt)
        y_k, c_k = mixer.apply_reservoir(cfg32, mp, x[:, :s])
        y_k2, c_k2 = mixer.apply_reservoir(cfg32, mp, x[:, s:], cache=c_k)
        with plain_mixer():
            (y_p, c_p), plain_s = wall(lambda: mixer.apply_reservoir(cfg32, mp, x[:, :s]))
            y_p2, c_p2 = mixer.apply_reservoir(cfg32, mp, x[:, s:], cache=c_p)
        same = all(torch.equal(a, r) for a, r in ((y_k, y_p), (y_k2, y_p2), (c_k[0], c_p[0]),
                                                   (c_k[1], c_p[1]), (c_k2[0], c_p2[0])))
        check(same, f"mixer on K1 vs its plain route ({dt}): "
                    f"{max_err(y_k, y_p)}, {max_err(y_k2, y_p2)}")
        mixer_checks[str(dt).removeprefix("torch.")] = {"bitwise": True, "plain_s": plain_s}
    out["mixer_k1_vs_plain"] = {"shape_bsd": [b, s, cfg32.d_model], "resumed": 16,
                                **mixer_checks}
    # layer 0's drive of the prompts, its K1 lanes [B·R, P], for the kernels line
    u0 = params["units"][0]
    h0 = layers.rmsnorm(layers.embed_tokens(cfg16, params["embed"], prompts), u0["norm_mixer"][0],
                        cfg16.norm_eps)
    j0 = torch.sigmoid(h0.float() @ u0["mixer/w_in"][0])
    lm_drive["j"] = j0.permute(0, 2, 1).reshape(b_r, LM_SERVE_PROMPT).contiguous()
    lm_drive["model"], lm_drive["mask"] = mixer._model(cfg16), mask
    del params, h, h0, j0
    torch.cuda.empty_cache()

    # (d) granite-8b at full width
    g32 = dataclasses.replace(get_config("granite-8b"), dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    gparams, init_s = wall(lambda: init_params(
        g32, torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = tree_numel(gparams)
    gprompts = torch.as_tensor(lm_tokens(g32, (GRANITE_B, GRANITE_PROMPT), 4), device=dev)
    granite = {"n_params": n_params, "param_bytes": 4 * n_params, "init_s": init_s}
    for cfg in (g32, get_config("granite-8b")):
        serve.generate(cfg, gparams, gprompts[:, :8], 2)                 # warm
        served = serve.generate(cfg, gparams, gprompts, GRANITE_NEW, slack=LM_PROFILE_STEPS)
        rep = serving_report(cfg, served, GRANITE_B)
        rep["prompt"] = GRANITE_PROMPT
        rep["prefill_tokens_per_s"] = GRANITE_B * GRANITE_PROMPT / served["prefill_s"]
        rep["decode_vs_forward"] = dvf = decode_vs_forward(cfg, gparams, gprompts, served)
        check(bool(torch.isfinite(served["logits"]).all()), f"granite-8b {cfg.dtype}: logits")
        if cfg.dtype == "float32":
            check(dvf["within_reference_bound"], f"granite-8b f32 decode vs forward: {dvf}")
        else:
            check(dvf["max_abs_gap"] <= DECODE_BF16_ATOL,
                  f"granite-8b bf16 decode vs forward: {dvf}")
        rep["profile"] = profile_decode(cfg, gparams, served)
        granite[cfg.dtype] = rep
        del served
    granite["peak_bytes"] = torch.cuda.max_memory_allocated()
    del gparams
    torch.cuda.empty_cache()
    # the chunked attention against the dense one at Skv 4096, chunk 1024
    hq, hkv, hd = g32.n_heads, g32.n_kv_heads, g32.head_dim
    q = torch.randn((1, SDPA_SKV, hq, hd), generator=gen, device=dev)
    k = torch.randn((1, SDPA_SKV, hkv, hd), generator=gen, device=dev)
    v = torch.randn((1, SDPA_SKV, hkv, hd), generator=gen, device=dev)
    dense, dense_s = wall(lambda: layers._sdpa_dense(g32, q, k, v, causal=True))
    chunked, chunked_s = wall(lambda: layers._sdpa_chunked(g32, q, k, v, causal=True,
                                                           chunk=SDPA_CHUNK))
    err = max_err(chunked, dense)
    check(err <= 1e-5, f"chunked attention vs dense at Skv {SDPA_SKV}: {err}")
    granite["sdpa_chunked_vs_dense"] = {"shape_q": list(q.shape), "shape_kv": list(k.shape),
                                        "chunk": SDPA_CHUNK, "max_abs_err": err,
                                        "dense_s": dense_s, "chunked_s": chunked_s}
    del q, k, v, dense, chunked
    torch.cuda.empty_cache()
    out["granite_8b"] = granite
    # (e) the other archs: each smoke config against the JAX package's
    # logits, then each full-width cell on its own line
    out["smoke_archs_vs_reference"] = lm_smoke_vs_reference(dev)
    emit({"phase": "lm_serving", "card": card, **out, "seconds": time.perf_counter() - t0})
    for cell in LM_ARCH_CELLS:
        lm_arch_cell(dev, card, *cell)
    return lm_drive


def phase_lm_training(dev, card: str) -> dict:
    """The LM training path (``repro_torch.launch.train`` → ``runtime.trainer``
    → ``runtime.steps.train_step`` → ``optim.adamw``) on the card:

    (a) reservoir_lm at full width (12 layers, d 768, N 256, R 3, vocab
        32000; bf16 activations over f32 params, 4 microbatches, remat
        "full") trained LM_TRAIN_STEPS steps of LM_TRAIN_BATCH ×
        LM_TRAIN_SEQ tokens through ``launch.train.main``: every loss finite
        and the mean of the last 3 below the first; K1 launched 12 × 4 × 2
        times a step (the remat runs each forward again in the backward) and
        K1ᵀ 12 × 4, launches == calls; step ms p50/p90 (without step 0),
        tokens/s, peak memory, grad norms; then ``main`` again to
        LM_TRAIN_STEPS + LM_TRAIN_RESUMED, which resumes from the
        checkpoint at step LM_TRAIN_STEPS and runs the rest;
    (b) one more step of the same under ``torch.profiler``: the device's
        busy share, and K1's and K1ᵀ's share of the busy time and device ms
        a launch;
    (c) every leaf's gradient through K1 and K1ᵀ against the plain route's
        (both scans' plain versions, on the card), full width cut to 2
        layers, 2 × 32 tokens on numpy weights: bitwise, else within
        LM_TRAIN_GRAD_TOL of the leaf's largest |gradient|;
    (d) the f32 smoke train step from the JAX package's numpy state, 3
        steps: loss and grad norm within LM_TRAIN_TOL of LM_TRAIN_SMOKE.

    Returns the inputs of the kernels line's training rows: K1's at layer
    0's first training forward, K1ᵀ's at the step's first backward (layer
    11, microbatch 0), and the launches a step."""
    import io
    import math
    import shutil

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import layer as mixer
    from repro_torch.data import DataConfig, host_batch
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves_with_path
    from repro_torch.runtime.steps import init_train_state, loss_fn, train_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("reservoir_lm")
    check(cfg.dtype == "bfloat16" and cfg.microbatches == 4 and cfg.remat == "full",
          f"reservoir_lm trains in {cfg.dtype}, {cfg.microbatches} microbatches, "
          f"remat {cfg.remat}")
    per_step = {"dfr_scan": cfg.n_layers * cfg.microbatches * 2,
                "dfr_scan_grad": cfg.n_layers * cfg.microbatches}
    wrappers = {"dfr_scan": scan_ops.dfr_scan, "dfr_scan_grad": scan_ops.dfr_scan_grad}

    def counts():
        return {k: (w.launches, w.calls) for k, w in wrappers.items()}

    # (a) full width through the launcher, then resumed from its checkpoint
    shutil.rmtree(LM_TRAIN_CKPT, ignore_errors=True)
    argv = ["--arch", "reservoir_lm", "--no-reduce", "--batch", str(LM_TRAIN_BATCH),
            "--seq", str(LM_TRAIN_SEQ), "--device", "cuda",
            "--checkpoint-dir", str(LM_TRAIN_CKPT)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        hist, run_s = wall(lambda: train.main(argv + ["--steps", str(LM_TRAIN_STEPS)]))
    peak = torch.cuda.max_memory_allocated()
    got = counts()
    for k, want in per_step.items():
        check(got[k] == (want * LM_TRAIN_STEPS,) * 2,
              f"lm training: {k} (launches, calls) {got[k]}, want {want} a step")
    losses = [h["loss"] for h in hist]
    check(len(hist) == LM_TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"lm training losses {losses}")
    check(float(np.mean(losses[-3:])) < losses[0], f"lm training loss did not fall: {losses}")
    step_ms = np.asarray([h["step_time_s"] for h in hist[1:]]) * 1e3
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    out = {"training": {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "reservoir_nodes": cfg.reservoir_nodes, "channels": mixer._n_channels(cfg),
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "microbatches": cfg.microbatches,
        "remat": cfg.remat, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
        "steps": LM_TRAIN_STEPS, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist], "lrs": [h["lr"] for h in hist],
        "step0_ms": hist[0]["step_time_s"] * 1e3,
        "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "tokens_per_s": tokens / float(np.percentile(step_ms, 50) / 1e3),
        "peak_bytes": peak, "run_s": run_s,
        "launches_calls": {k: list(v) for k, v in got.items()},
        "launches_per_step": per_step, "main_last_line": printed.getvalue().strip()}}
    reset_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        resumed, resume_s = wall(lambda: train.main(
            argv + ["--steps", str(LM_TRAIN_STEPS + LM_TRAIN_RESUMED)]))
    got = counts()
    check([h["step"] for h in resumed] == list(range(LM_TRAIN_STEPS,
                                                     LM_TRAIN_STEPS + LM_TRAIN_RESUMED)),
          f"resumed run's steps {[h['step'] for h in resumed]}")
    for k, want in per_step.items():
        check(got[k] == (want * LM_TRAIN_RESUMED,) * 2,
              f"resumed training: {k} (launches, calls) {got[k]}")
    check(all(math.isfinite(h["loss"]) for h in resumed), "resumed losses")
    out["resumed"] = {"from_step": LM_TRAIN_STEPS, "steps": len(resumed),
                      "losses": [h["loss"] for h in resumed], "run_s": resume_s,
                      "main_last_line": printed.getvalue().strip()}
    shutil.rmtree(LM_TRAIN_CKPT, ignore_errors=True)

    # (b) one step profiled, after one that records K1's and K1ᵀ's inputs
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
                      global_batch=LM_TRAIN_BATCH)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=LM_TRAIN_STEPS)
    batch = train.batch_to_device(host_batch(data, 0), dev)
    seen = {}
    scan, grad = mixer.dfr_scan, mixer.dfr_scan_grad

    def scan_spy(model, j, mask, s0, **kw):
        if "k1" not in seen:
            seen["k1"] = (model, j.detach().clone(), mask, s0.detach().clone())
        return scan(model, j, mask, s0, **kw)

    def grad_spy(model, *args):
        if "k1t" not in seen:
            seen["k1t"] = (model, *(a.detach().clone() for a in args))
        return grad(model, *args)

    mixer.dfr_scan, mixer.dfr_scan_grad = scan_spy, grad_spy
    try:
        train_step(cfg, opt, state, batch)
    finally:
        mixer.dfr_scan, mixer.dfr_scan_grad = scan, grad
    out["profile_one_step"] = prof = profile_calls(
        lambda: train_step(cfg, opt, state, batch), 1, "steps",
        shares={"k1": "dfr_scan_chain_kernel", "k1t": "dfr_scan_grad_kernel"})
    for label, kernel in (("k1", "dfr_scan"), ("k1t", "dfr_scan_grad")):
        if f"{label}_device_ms" in prof:  # device ms a launch in the profiled step
            prof[f"{label}_ms_per_call"] = prof[f"{label}_device_ms"] / per_step[kernel]
    del state, batch
    torch.cuda.empty_cache()

    # (c) the kernel route's gradients against the plain route's
    cfg2 = dataclasses.replace(cfg, n_layers=LM_TRAIN_GRAD_LAYERS, microbatches=1)
    params = convert.lm_params_from_reference(lm_numpy_params(cfg2, LM_SEED), device=dev)
    named = tree_leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    b, sl = LM_TRAIN_GRAD_SHAPE
    (toks,) = lm_train_batches(cfg2, 1, (b, sl), LM_TOKENS_SEED)
    gbatch = {k: torch.as_tensor(v, device=dev) for k, v in toks.items()}

    def grads():
        loss, _ = loss_fn(cfg2, params, gbatch)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    reset_counts()
    g_kernel = grads()
    got = counts()
    want = {"dfr_scan": 2 * cfg2.n_layers, "dfr_scan_grad": cfg2.n_layers}
    check(all(got[k] == (v, v) for k, v in want.items()),
          f"gradient check: kernel route launches {got}, want {want}")
    with plain_mixer():
        g_plain, plain_s = wall(grads)
    leaf_err, n_bitwise = {}, 0
    for (path, _), gk, gp in zip(named, g_kernel, g_plain, strict=True):
        if gk is None or gp is None:
            check(gk is None and gp is None, f"{path}: a gradient on one route only")
            continue
        n_bitwise += same_bits(gk, gp)
        rel = max_err(gk, gp) / max(float(gp.abs().max()), 1e-30)
        leaf_err[path] = rel
        check(rel <= LM_TRAIN_GRAD_TOL, f"{path}: kernel vs plain route gradient {rel}")
    out["gradients_vs_plain_route"] = {
        "layers": cfg2.n_layers, "shape_bs": [b, sl], "dtype": cfg2.dtype, "remat": cfg2.remat,
        "leaves": len(leaf_err), "bitwise_leaves": n_bitwise,
        "max_rel_err": max(leaf_err.values()), "tol": LM_TRAIN_GRAD_TOL,
        "none_leaves": [p for (p, _), g in zip(named, g_kernel) if g is None],
        "plain_s": plain_s}
    del params, leaves, g_kernel, g_plain
    torch.cuda.empty_cache()

    # (d) the f32 smoke train step against the JAX package's
    smoke = lm_smoke_train(dev)
    gaps = {k: max(abs(a - b) for a, b in zip(smoke[k], LM_TRAIN_SMOKE[k], strict=True))
            for k in smoke}
    check(max(gaps.values()) <= LM_TRAIN_TOL, f"smoke train step vs the JAX package: {gaps}")
    out["smoke_vs_reference"] = {"steps": LM_TRAIN_SMOKE_STEPS, "shape_bs":
                                 list(LM_TRAIN_SMOKE_SHAPE), **smoke, "max_gap": gaps,
                                 "tol": LM_TRAIN_TOL}
    emit({"phase": "lm_training", "card": card, **out, "seconds": time.perf_counter() - t0})
    return {"k1": seen["k1"], "k1t": seen["k1t"], "per_step": per_step,
            "launches": {k: v * LM_TRAIN_STEPS for k, v in per_step.items()}}


def calm_slstm(cfg, params) -> None:
    """Draw each sLSTM's r_rec of ``params`` at 1/sqrt(head_dim) where
    ``init_params`` draws it at 1/sqrt(heads) (see LM_ARCH_CELLS), in
    place."""
    import math

    import torch

    hd = cfg.d_model // cfg.n_heads
    with torch.no_grad():
        for blk, unit in zip(cfg.unit, params["units"], strict=True):
            if blk.mixer == "slstm":
                unit["mixer/r_rec"].mul_(math.sqrt(cfg.n_heads / hd))


def xlstm_unit_config():
    """xlstm-1.3b at full width cut to PSERVE_XLSTM_LAYERS layers (one unit
    of 7 mLSTM and 1 sLSTM blocks), f32."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("xlstm-1.3b"), dtype="float32",
                               n_layers=PSERVE_XLSTM_LAYERS)


def nudge_params(params, dev) -> None:
    """Multiply every leaf of ``params`` by 1 ± PAR_NUDGE (signs drawn on
    ``dev`` from PAR_NUDGE_SEED), in place: a move of every sum of the
    size tensor parallelism's reordered partial sums make."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    gen = torch.Generator(device=dev).manual_seed(PAR_NUDGE_SEED)
    with torch.no_grad():
        for p in tree_leaves(params):
            sign = torch.randint(0, 2, p.shape, generator=gen, device=dev) * 2 - 1
            p.mul_(1 + PAR_NUDGE * sign)


def par_config():
    """reservoir_lm at full width with f32 activations (the parallel phase)."""
    from repro_torch.launch.time_parallel import config

    return config()


def par_granite_config():
    """granite-8b at full width cut to PAR_GRANITE_LAYERS layers, f32."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite-8b"), dtype="float32",
                               n_layers=PAR_GRANITE_LAYERS)


def par_batches(cfg, steps: int = PAR_STEPS, shape=PAR_BATCH) -> list[dict]:
    """The token stream's first ``steps`` global batches of ``shape``
    (numpy)."""
    from repro_torch.launch.time_parallel import batches

    return batches(cfg, steps, shape)


def par_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def par_device(dev_type: str):
    """This rank's device (the one card, TF32 off as phase_build sets it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device(dev_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def par_steps(cfg, state, batches, dev, mesh=None) -> dict:
    """Train ``state`` over ``batches`` (under ``mesh`` when given): each
    step's metrics, host ms, K1/K1ᵀ (launches, calls) and collectives, and
    the peak device bytes (``launch.time_parallel.step_figures``)."""
    from repro_torch.launch.time_parallel import step_figures

    return step_figures(cfg, state, batches, dev, LM_TRAIN_OPT, mesh=mesh)


def par_init(cfg, dev, microbatches=None):
    """The phase's train state of ``cfg`` (seed 0; an sLSTM's r_rec as
    ``calm_slstm`` draws it) on ``dev``, with ``microbatches`` in its config
    when given."""
    import torch

    from repro_torch.runtime.steps import init_train_state

    run_cfg = cfg if microbatches is None else dataclasses.replace(cfg, microbatches=microbatches)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    calm_slstm(cfg, state["params"])
    return run_cfg, state


def pdfrc_cases(chans) -> dict:
    """The DFRC pipeline's mesh cases, name -> (kind, numpy inputs):
    phase_wdm's channels ``chans`` per channel and, their first stream on
    PDFRC_SHARED_R channels, shared; phase_composed's MC probe; the
    reduced device map's NARMA10."""
    import numpy as np

    from repro_torch.core import tasks

    mc = stack([tasks.memory_capacity(MC_SAMPLES, max_delay=MC_MAX_DELAY, seed=s)
                for s in range(B_MAIN)])
    r = PDFRC_SHARED_R
    shared = (np.repeat(chans[0][:1], r, axis=0), chans[1][0],
              np.repeat(chans[2][:1], r, axis=0), chans[3][0])
    return {"wdm": ("wdm", chans), "wdm_shared": ("shared", shared),
            "composed": ("composed", mc), "composed_wdm": ("composed_wdm", mc),
            "device_sweep": ("sweep", tasks.narma10(PDFRC_SWEEP_SAMPLES, seed=0))}


def pdfrc_run(kind: str, data, dev) -> dict:
    """One case of ``pdfrc_cases`` in this process, under whatever mesh is
    active: its numpy results, its one GCV solve (``solve``: the inputs
    (G, c, ‖y‖², sample count, λs) and outputs (w, λ index), on the host),
    K1's and K3's (launches, calls) and its host seconds."""
    import numpy as np

    from repro_torch.devices import SweepGrid, run_device_sweep
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.pipeline import Experiment, WDMExperiment, ridge

    topo = composed_topologies()
    runs = {
        "wdm": lambda: WDMExperiment(stream_config(n_nodes=N_WDM, state_noise_rel=0.0),
                                     data[0].shape[0], device=dev).run(*data),
        "shared": lambda: WDMExperiment(stream_config(n_nodes=N_WDM, state_noise_rel=0.0),
                                        data[0].shape[0], shared_readout=True,
                                        device=dev).run(*data),
        "composed": lambda: Experiment(composed_config(topo[PDFRC_COMPOSED]),
                                       device=dev).run(*data),
        "composed_wdm": lambda: WDMExperiment(composed_config(topo["d2_l1"]), data[0].shape[0],
                                              device=dev).run(*data),
        "sweep": lambda: run_device_sweep(
            cmt_model(power_mw=0.0), SweepGrid(**SWEEP_GRID), data, n_nodes=PDFRC_SWEEP_N,
            washout=SWEEP_WASHOUT, stream_chunk_k=SWEEP_CHUNK, ridge_l2=SWEEP_LAMS, device=dev),
    }
    solves, solve = [], ridge.solve_gcv

    def spy(g, c, y2, n_samples, lambdas):
        out = solve(g, c, y2, n_samples, lambdas)
        solves.append({"g": g.cpu(), "c": c.cpu(), "y2": y2.cpu(), "n": n_samples,
                       "lambdas": lambdas, "w": out[0].cpu(), "idx": out[1].cpu()})
        return out

    reset_counts()
    ridge.solve_gcv = spy
    try:
        res, run_s = wall(runs[kind])
    finally:
        ridge.solve_gcv = solve
    check(len(solves) == 1, f"parallel dfrc {kind}: {len(solves)} solves, want one")
    k1, k3 = scan_ops.dfr_scan, gram_ops.gram_accumulate_batched_into
    return {"results": {k: None if getattr(res, k, None) is None else np.asarray(getattr(res, k))
                        for k in PDFRC_RESULTS},
            "solve": solves[0], "k1": [k1.launches, k1.calls],
            "k3": [k3.launches, k3.calls], "run_s": run_s}


def pdfrc_mesh_runs(cases: dict, mesh, dev) -> dict:
    """Every case of ``cases`` under ``mesh`` (``pdfrc_run``), with the
    collectives each recorded."""
    from repro_torch.parallel import sharding

    out = {}
    for name, (kind, data) in cases.items():
        with sharding.use_mesh(mesh), sharding.record_collectives() as events:
            out[name] = pdfrc_run(kind, data, dev)
        out[name]["collectives"] = [dict(e) for e in events]
    return out


def pipe_tokens(batch):
    """PAR_BATCH's tokens ``batch["tokens"]`` [B, S] cut into PIPE_MICRO
    microbatches, [PIPE_MICRO, B / PIPE_MICRO, S] (numpy)."""
    toks = batch["tokens"]
    return toks.reshape(PIPE_MICRO, toks.shape[0] // PIPE_MICRO, toks.shape[1])


def pipe_stage_params(params: dict, stage: int, n_stages: int) -> tuple:
    """Stage ``stage``'s units of ``params``: its slice of U / ``n_stages``
    contiguous units of each stacked [U, ...] unit leaf, copied, so the
    rest of the tree can be freed."""
    units = params["units"]
    per = next(iter(units[0].values())).shape[0] // n_stages
    return tuple({k: v[stage * per:(stage + 1) * per].clone() for k, v in pos.items()}
                 for pos in units)


def pipe_stage_fn(cfg):
    """``stage_fn(units, h)``: the stage's units (``pipe_stage_params``, or
    the whole stack) folded over h [mb, S, d], each block as
    ``models.model.forward`` applies it without a plan."""
    import torch

    from repro_torch.models.model import _apply_block, _unit_params

    def stage_fn(units, h):
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        for u in range(next(iter(units[0].values())).shape[0]):
            for blk, p in zip(cfg.unit, _unit_params(units, u), strict=True):
                h, _, _ = _apply_block(cfg, blk, p, h, positions=positions)
        return h

    return stage_fn


def pipe_embed(cfg, params, tokens):
    """Token embeddings of microbatched tokens [M, mb, S]: [M, mb, S, d]."""
    from repro_torch.models import layers

    m, mb, s = tokens.shape
    return layers.embed_tokens(cfg, params["embed"], tokens.reshape(m * mb, s)).view(
        m, mb, s, -1)


def pipe_head(cfg, params, h):
    """The final norm and logits of microbatched hidden states [M, mb, S, d]:
    [M, mb, S, V]."""
    from repro_torch.models import layers

    m, mb, s, d = h.shape
    x = layers.rmsnorm(h.reshape(m * mb, s, d), params["final_norm"]["scale"], cfg.norm_eps)
    return layers.logits_from_hidden(cfg, params["embed"], x).view(m, mb, s, -1)


def pipe_fold(cfg, params, x):
    """One process's fold: every unit over each microbatch x[m] in turn,
    [M, mb, S, d]."""
    import torch

    fn = pipe_stage_fn(cfg)
    return torch.stack([fn(params["units"], x[m]) for m in range(x.shape[0])])


def pipe_run(cfg, params, tokens, dev, apply) -> dict:
    """Embed ``tokens`` [M, mb, S], run ``apply(x)`` on them 1 + PIPE_CALLS
    times (each call timed on the host between device synchronises, with
    K1's (launches, calls) and the collectives it records as (kind, bytes,
    axis)), then the head.  Returns the calls, the last outputs and their
    logits, the bytes of ``params`` and the case's peak device bytes: the
    params and the most the run held beside them (what else the process
    held at the start left out)."""
    import torch

    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding

    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    other = 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        other = torch.cuda.memory_allocated(dev) - param_bytes
    calls = []
    with torch.no_grad():
        x = pipe_embed(cfg, params, torch.as_tensor(tokens, device=dev))
        for _ in range(1 + PIPE_CALLS):
            scan_ops.dfr_scan.launches = scan_ops.dfr_scan.calls = 0
            par_sync(dev)
            t0 = time.perf_counter()
            with sharding.record_collectives() as events:
                h = apply(x)
            par_sync(dev)
            calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "k1": (scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls),
                          "collectives": [(e["kind"], e["bytes"], e["axis"]) for e in events]})
        logits = pipe_head(cfg, params, h)
    return {"calls": calls, "h": h, "logits": logits, "param_bytes": param_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - other if dev.type == "cuda"
            else 0}


def pipe_one_process(cfg, tokens, dev) -> dict:
    """The pipeline case in one process (``pipe_run`` of ``pipe_fold`` on
    the whole tree, drawn as ``pserve_params`` draws it); its outputs and
    logits saved under PAR_DIR for the ranks to hold theirs against.
    Returns the calls, the peak and param bytes and the greedy ids."""
    import torch

    params = pserve_params(cfg, dev)
    run = pipe_run(cfg, params, tokens, dev, lambda x: pipe_fold(cfg, params, x))
    torch.save({"h": run["h"].cpu(), "logits": run["logits"].cpu()}, PAR_DIR / "pipe_fold.pt")
    return {"calls": run["calls"], "peak_bytes": run["peak_bytes"],
            "param_bytes": run["param_bytes"], "ids": run["logits"].argmax(-1).cpu()}


def pipe_rank(cfg, tokens, dev) -> dict:
    """This rank's side of the pipeline case: a ("stage",) mesh of
    PIPE_STAGES over the two ranks on ``dev``, the rank's stage's units of
    the tree ``pserve_params`` draws (the rest freed), ``pipe_run`` of
    ``pipeline.pipeline_apply``; its outputs and logits held against the
    one process's under PAR_DIR.  Returns the rank's stage and units, the
    calls, the peak and param bytes, whether the outputs lay on ``dev``,
    bitwise flags and gaps, the greedy ids and the case's seconds."""
    import torch

    from repro_torch.parallel import pipeline, sharding

    t_case = time.perf_counter()
    mesh = pipeline.make_stage_mesh(PIPE_STAGES, device_type=dev.type)
    stage = sharding.coordinate(mesh, "stage")
    full = pserve_params(cfg, dev)
    params = {"embed": full["embed"], "final_norm": full["final_norm"],
              "units": pipe_stage_params(full, stage, PIPE_STAGES)}
    del full
    fn = pipe_stage_fn(cfg)
    run = pipe_run(cfg, params, tokens, dev,
                   lambda x: pipeline.pipeline_apply(fn, params["units"], x, mesh=mesh))
    ref = torch.load(PAR_DIR / "pipe_fold.pt", mmap=True)
    h, logits = run.pop("h"), run.pop("logits")
    h_host, logits_host = h.cpu(), logits.cpu()
    out = {**run, "stage": stage, "units": next(iter(params["units"][0].values())).shape[0],
           "on_device": h.device == dev,
           "h_bitwise": torch.equal(h_host, ref["h"]),
           "logits_bitwise": torch.equal(logits_host, ref["logits"]),
           "h_gap": float((h_host - ref["h"]).abs().max()),
           "logit_gap": float((logits_host - ref["logits"]).abs().max()),
           "ids": logits.argmax(-1).cpu()}
    del ref, h_host, logits_host, params, h, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["case_s"] = time.perf_counter() - t_case
    return out


def pipe_report(cfg, tokens, one: dict, one_s: float, ranks: list) -> dict:
    """Hold each rank's pipeline case (``pipe_rank``) to the one process's
    (``pipe_one_process``): outputs and logits bitwise and on the card,
    greedy ids equal, K1 launches == calls == the stage's units × the T =
    M + S − 1 ticks on every call (every stage computes on every tick, as
    in the reference), the collectives exact (a stage but the last sends T
    permutes of one microbatch's activations over "stage", every rank gets
    all M outputs in one broadcast).  Returns the line's figures: host ms a
    call (p50) against the fold's, the bubble (S − 1)/T, peak and param
    bytes."""
    import statistics

    import numpy as np

    m, mb, seq = tokens.shape
    n_stages, per_stage = PIPE_STAGES, cfg.n_units // PIPE_STAGES
    ticks = m + n_stages - 1
    act = mb * seq * cfg.d_model * 4
    check(all(tuple(c["k1"]) == (cfg.n_units * m,) * 2 and not c["collectives"]
              for c in one["calls"]),
          f"pipeline one process: K1 (launches, calls) a fold "
          f"{[c['k1'] for c in one['calls']]}, want {cfg.n_units * m}; no collectives")
    by_rank = []
    for rank, r in enumerate(ranks):
        where = f"pipeline rank {rank} (stage {r['stage']})"
        check(r["stage"] == rank and r["units"] == per_stage and r["on_device"],
              f"{where}: stage, units {r['units']}, on the card {r['on_device']}")
        check(r["h_bitwise"] and r["logits_bitwise"],
              f"{where}: not bitwise the one process's fold (outputs {r['h_gap']}, "
              f"logits {r['logit_gap']} off)")
        check(np.array_equal(r["ids"], one["ids"]), f"{where}: greedy ids differ")
        want = ([("collective-permute", act, "stage")] * (ticks if r["stage"] < n_stages - 1
                                                          else 0)
                + [("broadcast", m * act, "stage")])
        for i, c in enumerate(r["calls"]):
            check(tuple(c["k1"]) == (per_stage * ticks,) * 2,
                  f"{where} call {i}: K1 (launches, calls) {c['k1']}, want "
                  f"{per_stage * ticks}")
            check([tuple(e) for e in c["collectives"]] == want,
                  f"{where} call {i}: collectives {c['collectives']}, want {want}")
        ms = [c["ms"] for c in r["calls"][1:]]
        by_rank.append({"stage": r["stage"], "units": r["units"], "apply_ms": ms,
                        "apply_ms_p50": statistics.median(ms), "first_ms": r["calls"][0]["ms"],
                        "peak_bytes": r["peak_bytes"], "param_bytes": r["param_bytes"],
                        "k1_launches_calls": list(r["calls"][-1]["k1"]),
                        "permutes": len(want) - 1, "permute_bytes": act,
                        "broadcast_bytes": m * act, "outputs_bitwise": True,
                        "logits_bitwise": True, "case_s": r["case_s"]})
    fold_ms = [c["ms"] for c in one["calls"][1:]]
    fold_p50 = statistics.median(fold_ms)
    return {"stages": n_stages, "microbatches": m, "microbatch_tokens": [mb, seq],
            "units_per_stage": per_stage, "ticks": ticks, "bubble": (n_stages - 1) / ticks,
            "backend": "gloo", "greedy_ids_equal": True,
            "one_process": {"fold_ms": fold_ms, "fold_ms_p50": fold_p50,
                            "first_ms": one["calls"][0]["ms"], "peak_bytes": one["peak_bytes"],
                            "param_bytes": one["param_bytes"],
                            "k1_launches_calls": list(one["calls"][-1]["k1"]), "s": one_s},
            "by_rank": by_rank,
            "rank_over_one_process_p50": max(r["apply_ms_p50"] for r in by_rank) / fold_p50,
            "seconds": one_s + max(r["case_s"] for r in by_rank)}


def par_rank(rank: int, cfg, gcfg, xcfg, dev_type: str, batches, gbatches, xbatches, narma,
             exp_cfg, dfrc) -> dict:
    """One rank of the parallel phase's two (gloo, the one card): the
    sharded steps of reservoir_lm on the (2, 1) and (1, 2) meshes from the
    seeded state, the gathered params of each written by rank 0 under
    PAR_DIR; NARMA10 through ``Experiment`` and the DFRC cases ``dfrc``
    (``pdfrc_cases``) under the (2, 1) mesh; then
    granite-8b's and xlstm-1.3b's sharded steps on (1, 2), each rank's param
    blocks (xlstm's first moments) held against its blocks of the one
    process's under PAR_DIR (each leaf's largest gap)."""
    import numpy as np
    import torch

    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.pipeline import Experiment
    from repro_torch.runtime.steps import state_pspecs

    dev = par_device(dev_type)
    out = {"pipeline": pipe_rank(cfg, pipe_tokens(batches[0]), dev)}
    for shape in ((2, 1), (1, 2)):
        name = f"mesh_{shape[0]}x{shape[1]}"
        mesh = make_mesh(shape, ("data", "model"), device_type=dev.type)
        specs = state_pspecs(cfg, mesh)
        state = sharding.tree_shard(par_init(cfg, dev)[1], specs, mesh)
        torch.cuda.empty_cache()
        run = par_steps(cfg, state, batches, dev, mesh=mesh)
        params = sharding.tree_gather(run.pop("state")["params"], specs["params"], mesh)
        if rank == 0:
            torch.save([t.cpu() for t in tree_leaves(params)], PAR_DIR / f"{name}.pt")
        del params
        torch.cuda.empty_cache()
        out[name] = run
    # NARMA10 over the two data ranks
    exp_mesh = make_mesh((2, 1), ("data", "model"), device_type=dev.type)
    exp = Experiment(exp_cfg, device=dev)
    reset_counts()
    par_sync(dev)
    t0 = time.perf_counter()
    with sharding.use_mesh(exp_mesh), sharding.record_collectives() as events:
        res = exp.run(*narma)
    run_s = time.perf_counter() - t0
    out["experiment"] = {"nrmse": np.asarray(res.nrmse), "run_s": run_s,
                         "launches": list(launch_counts()),
                         "collective_bytes": collective_bytes(events)}
    del exp
    out["dfrc"], out["dfrc_s"] = wall(lambda: pdfrc_mesh_runs(dfrc, exp_mesh, dev))
    torch.cuda.empty_cache()
    # granite-8b and xlstm-1.3b on (1, 2): each rank holds its blocks
    # against the one process's
    mesh = make_mesh((1, 2), ("data", "model"), device_type=dev.type)
    for name, run_cfg, run_batches in (("granite", gcfg, gbatches), ("xlstm", xcfg, xbatches)):
        specs = state_pspecs(run_cfg, mesh)
        state = sharding.tree_shard(par_init(run_cfg, dev)[1], specs, mesh)
        torch.cuda.empty_cache()
        run = par_steps(run_cfg, state, run_batches, dev, mesh=mesh)
        ref = torch.load(PAR_DIR / f"{name}_1x1.pt", mmap=True)
        state = run.pop("state")
        held = state["opt"]["m"] if name == "xlstm" else state["params"]
        run["leaf_gaps"] = [
            float((t.detach() - sharding.shard(w, spec, mesh).to(dev)).abs().max())
            for t, w, spec in zip(tree_leaves(held), ref,
                                  sharding.spec_leaves(specs["params"]), strict=True)]
        del ref, state
        torch.cuda.empty_cache()
        out[f"{name}_1x2"] = run
    return out


def par_nccl_rank(rank: int, cfg, dev_type: str, batches, dfrc) -> dict:
    """One sharded step through NCCL at world 1 (mesh (1, 1)): its params,
    written under PAR_DIR, and metrics; then the DFRC cases ``dfrc`` on the
    same mesh (``pdfrc_mesh_runs``)."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.runtime.steps import state_pspecs

    dev = par_device(dev_type)
    mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    specs = state_pspecs(cfg, mesh)
    state = sharding.tree_shard(par_init(cfg, dev)[1], specs, mesh)
    run = par_steps(cfg, state, batches[:1], dev, mesh=mesh)
    torch.save([t.cpu() for t in tree_leaves(run.pop("state")["params"])],
               PAR_DIR / "nccl_world1.pt")
    run["backend"] = torch.distributed.get_backend()
    run["dfrc"] = pdfrc_mesh_runs(dfrc, mesh, dev)
    return run


def pdfrc_check(name: str, one: dict, got: dict, where: str, block, dev) -> dict:
    """Hold a run of DFRC case ``name`` over a mesh (``got``) to the one
    process's (``one``): K1 and K3 launches == calls == the one process's;
    its solve's inputs bitwise its block of the one process's (``block``:
    (index, count) along the instances, None: the whole); every result
    bitwise, but where its batch is a block and the solve alone differs:
    the one process's solve inputs, cut to the block and solved here at the
    rank's batch size, give the rank's w and λ bitwise (cuSOLVER's eigh
    takes another routine at another batch size), and there NRMSE within
    PDFRC_EIGH_NRMSE_TOL.  Returns the run's record."""
    import numpy as np
    import torch

    from repro_torch.pipeline import ridge

    what = f"parallel dfrc {name} {where}"
    for kernel in ("k1", "k3"):
        check(got[kernel] == one[kernel] and got[kernel][0] == got[kernel][1],
              f"{what}: {kernel} (launches, calls) {got[kernel]}, one process {one[kernel]}")

    def part(t):
        t = torch.as_tensor(t)
        if block is None:
            return t
        b = t.shape[0] // block[1]
        return t[block[0] * b:(block[0] + 1) * b]

    mine, theirs = got["solve"], one["solve"]
    check(all(torch.equal(torch.as_tensor(mine[k]), part(theirs[k])) for k in ("g", "c", "y2")),
          f"{what}: the solve's inputs are not bitwise the one process's")
    same = all(np.array_equal(got["results"][k], one["results"][k])
               if one["results"][k] is not None else got["results"][k] is None
               for k in PDFRC_RESULTS)
    rec = {"case": "bitwise", "max_nrmse_gap": 0.0}
    if not same:
        w, idx = ridge.solve_gcv(*(part(theirs[k]).to(dev) for k in ("g", "c", "y2")),
                                 theirs["n"], tuple(theirs["lambdas"]))
        witness = (torch.equal(w.cpu(), torch.as_tensor(mine["w"])) and
                   torch.equal(idx.cpu(), torch.as_tensor(mine["idx"])))
        gap = float(np.abs(got["results"]["nrmse"] - one["results"]["nrmse"]).max())
        check(block is not None and witness and gap <= PDFRC_EIGH_NRMSE_TOL,
              f"{what}: not bitwise the one process's run (NRMSE gap {gap}; the block's "
              f"solve at the rank's batch size gives the rank's bits: {witness})")
        rec = {"case": f"eigh at batch {w.shape[0]} against {theirs['g'].shape[0]}",
               "max_nrmse_gap": gap,
               "lam_flips": int((got["results"]["lam"] != one["results"]["lam"]).sum())}
    return {**rec, "run_s": got["run_s"], "k1": got["k1"], "k3": got["k3"]}


def pdfrc_collectives(name: str, kind: str, data, got: dict, where: str, group: int) -> dict:
    """The collectives of a DFRC case's mesh run: a per-instance case one
    all-gather over "data" (its results); the shared readout one over
    "data" a fit and an evaluation chunk, of the chunk's features."""
    events = got["collectives"]
    if kind == "shared":
        n = sum(-(-data[i].shape[1] // STREAM_CHUNK) for i in (0, 2))
        one = {"kind": "all-gather", "bytes": 4 * STREAM_CHUNK * data[0].shape[0] * N_WDM,
               "group": group, "axis": "data"}
        ok = events == [one] * n
    else:
        ok = len(events) == 1 and all(events[0][k] == v for k, v in
                                      (("kind", "all-gather"), ("axis", "data"),
                                       ("group", group)))
    check(ok, f"parallel dfrc {name} {where}: collectives {events[:3]} ({len(events)})")
    return {"count": len(events), "bytes": sum(e["bytes"] for e in events)}


def phase_parallel(dev, narma, chans, card: str) -> None:
    """The sharded train step, the sharded Experiment and the DFRC cases
    over a mesh on the card (see the module doc, phase 24); ``chans`` are
    phase_wdm's channels."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.time_parallel import summary
    from repro_torch.models.model import meta_params
    from repro_torch.optim.adamw import tree_leaves, tree_leaves_with_path
    from repro_torch.pipeline import Experiment, ExperimentConfig

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, gcfg, xcfg = par_config(), par_granite_config(), xlstm_unit_config()
    check(cfg.n_layers == 12 and cfg.d_model == 768 and cfg.reservoir_nodes == 256 and
          cfg.vocab_size == 32000 and cfg.microbatches == 4 and cfg.remat == "full",
          f"the parallel phase's reservoir_lm: {cfg}")
    check(gcfg.d_model == 4096 and gcfg.n_heads == 32 and gcfg.n_kv_heads == 8 and
          gcfg.d_ff == 14336 and gcfg.vocab_size == 49152 and gcfg.n_layers ==
          PAR_GRANITE_LAYERS and gcfg.microbatches == 8 and gcfg.remat == "full",
          f"the parallel phase's granite-8b: {gcfg}")
    check(xcfg.d_model == 2048 and xcfg.n_units == 1 and xcfg.microbatches == 4 and
          xcfg.remat == "full", f"the parallel phase's xlstm-1.3b: {xcfg}")
    batches, gbatches = par_batches(cfg), par_batches(gcfg, PAR_GRANITE_STEPS)
    xbatches = par_batches(xcfg, PAR_XLSTM_STEPS, PAR_XLSTM_BATCH)
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True, exist_ok=True)

    # the unsharded step on the card (losses, params after step 1 and after
    # the last), and its own spread: under another split of its token sums
    # (the same steps at more microbatches of fewer rows: reservoir_lm 8 of
    # one row, each gradient's token sums split as each (2, 1) rank's are;
    # granite-8b 4 of two rows where it takes 8 of one), and under a
    # ±PAR_NUDGE relative nudge of every weight, which moves every sum as
    # tensor parallelism's reordered partial sums do
    def unsharded(run_cfg, host_batches, microbatches: int, keep_first=False, nudge=False,
                  moments=False):
        run_cfg, state = par_init(run_cfg, dev, microbatches)
        if nudge:
            nudge_params(state["params"], dev)
        run = {"metrics": [], "ms": [], "k1": [], "k1t": [], "peak_bytes": 0}
        after_one = None
        for i, batch in enumerate(host_batches):
            one = par_steps(run_cfg, state, [batch], dev)
            for k in ("metrics", "ms", "k1", "k1t"):
                run[k] += one[k]
            run["peak_bytes"] = max(run["peak_bytes"], one["peak_bytes"])
            if i == 0 and keep_first:
                after_one = [t.detach().clone() for t in tree_leaves(state["params"])]
        held = state["opt"]["m"] if moments else state["params"]
        return run, after_one, [t.detach() for t in tree_leaves(held)]

    def spreads(run, final, other):
        """(the loss spread, each leaf's spread) of ``other`` (an
        ``unsharded`` result) around the unsharded run ``run``, ``final``."""
        other_run, _, other_final = other
        return (max(abs(x["loss"] - y["loss"]) for x, y in zip(run["metrics"],
                                                              other_run["metrics"])),
                [float((r - w).abs().max()) for w, r in zip(final, other_final, strict=True)])

    def tolerances(final, *spread_pairs):
        """The loss tolerance and each leaf's: PAR_SPREAD_FACTOR × the
        largest of the given spreads, floored at LM_TRAIN_TOL and
        PAR_PARAM_TOL of the leaf's largest |param|."""
        loss = max(LM_TRAIN_TOL, PAR_SPREAD_FACTOR * max(p[0] for p in spread_pairs))
        leaves = [PAR_SPREAD_FACTOR * max(max(p[1][k] for p in spread_pairs),
                                          PAR_PARAM_TOL * float(w.abs().max()))
                  for k, w in enumerate(final)]
        return loss, leaves

    def param_gaps(name, leaf_paths, gaps, tols):
        """Each leaf's largest gap to the unsharded step's within its
        tolerance (``tolerances``)."""
        for path, gap, tol in zip(leaf_paths, gaps, tols, strict=True):
            check(gap <= tol, f"parallel {name}: {path} {gap} off the unsharded step, "
                              f"tolerance {tol}")
        return {"max_gap_over_tol": max(g / t for g, t in zip(gaps, tols)),
                "bitwise_leaves": sum(g == 0.0 for g in gaps), "leaves": len(gaps),
                "spread_factor": PAR_SPREAD_FACTOR, "floor": PAR_PARAM_TOL}

    ref, after_one, final = unsharded(cfg, batches, cfg.microbatches, keep_first=True)
    paths = [p for p, _ in tree_leaves_with_path(meta_params(cfg))]
    per_step = {"dfr_scan": cfg.n_layers * cfg.microbatches * 2,
                "dfr_scan_grad": cfg.n_layers * cfg.microbatches}
    check(all(tuple(c) == (per_step["dfr_scan"],) * 2 for c in ref["k1"]) and
          all(tuple(c) == (per_step["dfr_scan_grad"],) * 2 for c in ref["k1t"]),
          f"parallel: the unsharded step's K1/K1ᵀ (launches, calls) {ref['k1']} {ref['k1t']}")
    split = spreads(ref, final, unsharded(cfg, batches, PAR_BATCH[0]))
    nudged = spreads(ref, final, unsharded(cfg, batches, cfg.microbatches, nudge=True))
    # (2, 1) splits the token sums: held to that split's spread, as PR 23
    # held it; (1, 2) reorders each product's sums: the larger of both
    tols = {"mesh_2x1": tolerances(final, split), "mesh_1x2": tolerances(final, split, nudged)}
    torch.cuda.empty_cache()

    # granite-8b in one process: its params after the last step go to
    # PAR_DIR, where each rank reads its blocks
    gref, _, gfinal = unsharded(gcfg, gbatches, gcfg.microbatches)
    torch.save([t.cpu() for t in gfinal], PAR_DIR / "granite_1x1.pt")
    gsplit = spreads(gref, gfinal, unsharded(gcfg, gbatches, gcfg.microbatches // 2))
    torch.cuda.empty_cache()
    gnudged = spreads(gref, gfinal, unsharded(gcfg, gbatches, gcfg.microbatches, nudge=True))
    gloss_tol, gtols = tolerances(gfinal, gsplit, gnudged)
    gpaths = [p for p, _ in tree_leaves_with_path(meta_params(gcfg))]
    del gfinal
    torch.cuda.empty_cache()
    # xlstm-1.3b likewise (its split: 2 microbatches of four rows), its
    # first moments held (PAR_XLSTM_BATCH)
    xref, _, xfinal = unsharded(xcfg, xbatches, xcfg.microbatches, moments=True)
    torch.save([t.cpu() for t in xfinal], PAR_DIR / "xlstm_1x1.pt")
    xsplit = spreads(xref, xfinal, unsharded(xcfg, xbatches, xcfg.microbatches // 2,
                                             moments=True))
    torch.cuda.empty_cache()
    xnudged = spreads(xref, xfinal, unsharded(xcfg, xbatches, xcfg.microbatches, nudge=True,
                                              moments=True))
    xloss_tol, xtols = tolerances(xfinal, xsplit, xnudged)
    xpaths = [p for p, _ in tree_leaves_with_path(meta_params(xcfg))]
    del xfinal
    torch.cuda.empty_cache()

    # NARMA10 and the DFRC cases in one process
    exp_cfg = dataclasses.replace(ExperimentConfig.from_dfrc(main_point()),
                                  state_method="kernel", readout_use_kernel=True)
    one = Experiment(exp_cfg, device=dev).run(*narma)
    dfrc = pdfrc_cases(chans)
    dfrc_one = {name: pdfrc_run(kind, data, dev) for name, (kind, data) in dfrc.items()}
    for name, run in dfrc_one.items():
        check(run["k1"][0] == run["k1"][1] and run["k3"][0] == run["k3"][1],
              f"parallel dfrc {name} one process: K1 {run['k1']} K3 {run['k3']}")
    torch.cuda.empty_cache()

    # the pipeline case's fold in one process, its outputs under PAR_DIR
    pipe_toks = pipe_tokens(batches[0])
    pipe_one, pipe_one_s = wall(lambda: pipe_one_process(cfg, pipe_toks, dev))
    torch.cuda.empty_cache()

    ranks, ranks_s = wall(lambda: run_ranks(par_rank, 2, store_dir=str(PAR_DIR),
                                            args=(cfg, gcfg, xcfg, dev.type, batches,
                                                  gbatches, xbatches, narma, exp_cfg, dfrc),
                                            timeout=PAR_TIMEOUT_S, threads=None))
    out = {"config": {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                      "reservoir_nodes": cfg.reservoir_nodes, "vocab": cfg.vocab_size,
                      "dtype": cfg.dtype, "microbatches": cfg.microbatches,
                      "remat": cfg.remat, "batch": list(PAR_BATCH), "steps": PAR_STEPS,
                      "backend": "gloo", "ranks": 2},
           "unsharded": {"losses": [m["loss"] for m in ref["metrics"]], "step_ms": ref["ms"],
                         "peak_bytes": ref["peak_bytes"],
                         "loss_spread": {"one_row_microbatches": split[0], "nudged": nudged[0]},
                         "loss_tol": {k: v[0] for k, v in tols.items()}},
           "ranks_s": ranks_s, "pr23_route": PAR_PR23_ROUTE,
           "pipeline": pipe_report(cfg, pipe_toks, pipe_one, pipe_one_s,
                                   [r["pipeline"] for r in ranks])}
    for name in ("mesh_2x1", "mesh_1x2"):
        got = torch.load(PAR_DIR / f"{name}.pt")
        rec = {"by_rank": []}
        for rank, r in enumerate(ranks):
            run = r[name]
            losses = [m["loss"] for m in run["metrics"]]
            gaps = [abs(a - b["loss"]) for a, b in zip(losses, ref["metrics"])]
            check(max(gaps) <= tols[name][0], f"parallel {name} rank {rank}: loss gaps "
                                              f"{gaps}, tolerance {tols[name][0]}")
            check(all(tuple(c) == (per_step["dfr_scan"],) * 2 for c in run["k1"]) and
                  all(tuple(c) == (per_step["dfr_scan_grad"],) * 2 for c in run["k1t"]),
                  f"parallel {name} rank {rank}: K1 {run['k1']} K1ᵀ {run['k1t']} "
                  f"(launches, calls) a step, want {per_step}")
            rec["by_rank"].append(summary(run))
        rec["params"] = param_gaps(name, paths, [float((g.to(dev) - w).abs().max())
                                                 for g, w in zip(got, final, strict=True)],
                                   tols[name][1])
        out[name] = rec
    del got
    # granite-8b and xlstm-1.3b on (1, 2)
    for name, c, run_ref, split_, nudged_, loss_tol, tols_, paths_, shape_, steps_ in (
            ("granite_1x2", gcfg, gref, gsplit, gnudged, gloss_tol, gtols, gpaths, PAR_BATCH,
             PAR_GRANITE_STEPS),
            ("xlstm_1x2", xcfg, xref, xsplit, xnudged, xloss_tol, xtols, xpaths,
             PAR_XLSTM_BATCH, PAR_XLSTM_STEPS)):
        rec = {"config": {"arch": c.name, "layers": c.n_layers, "d_model": c.d_model,
                          "vocab": c.vocab_size, "dtype": c.dtype,
                          "microbatches": c.microbatches, "remat": c.remat,
                          "batch": list(shape_), "steps": steps_},
               "unsharded": {"losses": [m["loss"] for m in run_ref["metrics"]],
                             "step_ms": run_ref["ms"], "peak_bytes": run_ref["peak_bytes"],
                             "loss_spread": {"half_the_microbatches": split_[0],
                                             "nudged": nudged_[0]},
                             "loss_tol": loss_tol},
               "by_rank": []}
        for rank, r in enumerate(ranks):
            run = r[name]
            gaps = [abs(m["loss"] - w["loss"]) for m, w in zip(run["metrics"],
                                                              run_ref["metrics"])]
            check(max(gaps) <= loss_tol, f"parallel {name} rank {rank}: loss gaps {gaps}, "
                                         f"tolerance {loss_tol}")
            held = "first_moments" if name == "xlstm_1x2" else "params"
            rec["by_rank"].append({**summary(run), held: param_gaps(
                f"{name} rank {rank} {held}", paths_, run["leaf_gaps"], tols_)})
        out[name] = rec
    # NCCL at world 1
    nccl_dfrc = {"wdm_shared": dfrc["wdm_shared"]}
    (nccl,) = run_ranks(par_nccl_rank, 1, store_dir=str(PAR_DIR), backend="nccl",
                        args=(cfg, dev.type, batches, nccl_dfrc), timeout=PAR_TIMEOUT_S,
                        threads=None)
    got = torch.load(PAR_DIR / "nccl_world1.pt")
    same = all(torch.equal(g.to(dev), w) for g, w in zip(got, after_one, strict=True))
    check(nccl["backend"] == "nccl" and same and nccl["metrics"][0] == ref["metrics"][0],
          f"parallel: one NCCL step at world 1 is not bitwise the unsharded step "
          f"({nccl['backend']}, params {same})")
    out["nccl_world1"] = {"params_bitwise": same, "metrics_bitwise": True,
                          "step_ms": nccl["ms"],
                          "collectives_per_step": nccl["collectives"][-1]}
    # NARMA10 over two ranks
    exp_out = []
    for rank, r in enumerate(ranks):
        e = r["experiment"]
        gap = float(np.abs(e["nrmse"] - one.nrmse).max())
        check(gap <= PAR_NRMSE_TOL, f"parallel experiment rank {rank}: NRMSE gap {gap}")
        check(e["launches"] == [2, 1, 0], f"parallel experiment rank {rank}: launches "
                                          f"(scan, gram, into) {e['launches']}")
        exp_out.append({"max_nrmse_gap": gap, "run_s": e["run_s"], "launches": e["launches"],
                        "collective_bytes": e["collective_bytes"]})
    out["experiment"] = {"B": int(narma[0].shape[0]), "N": exp_cfg.n_nodes,
                         "nrmse_mean": float(one.nrmse.mean()), "by_rank": exp_out,
                         "tol": PAR_NRMSE_TOL}
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    emit({"phase": "parallel", "card": card, **out, "seconds": time.perf_counter() - t0})

    # the DFRC cases over the two ranks, and the shared readout on NCCL
    dfrc_out = {"config": {"wdm": {"R": B_MAIN, "N": N_WDM, "chunk": STREAM_CHUNK},
                           "wdm_shared": {"R": PDFRC_SHARED_R, "F": PDFRC_SHARED_R * N_WDM + 1},
                           "composed": PDFRC_COMPOSED, "composed_wdm": "d2_l1",
                           "device_sweep": {"lanes": dfrc_one["device_sweep"]["results"]["nrmse"].size,
                                            "N": PDFRC_SWEEP_N,
                                            "samples": PDFRC_SWEEP_SAMPLES}},
                "one_process_s": sum(run["run_s"] for run in dfrc_one.values()),
                "ranks_s": [r["dfrc_s"] for r in ranks], "tol": PDFRC_EIGH_NRMSE_TOL}
    for name, (kind, data) in dfrc.items():
        rec = {"one_process_s": dfrc_one[name]["run_s"], "k1": dfrc_one[name]["k1"],
               "k3": dfrc_one[name]["k3"], "by_rank": []}
        for rank, r in enumerate(ranks):
            got = r["dfrc"][name]
            rec["by_rank"].append({
                **pdfrc_check(name, dfrc_one[name], got, f"rank {rank}",
                              None if kind == "shared" else (rank, len(ranks)), dev),
                "collectives": pdfrc_collectives(name, kind, data, got, f"rank {rank}", 2)})
        dfrc_out[name] = rec
    got = nccl["dfrc"]["wdm_shared"]
    dfrc_out["nccl_world1_wdm_shared"] = {
        **pdfrc_check("wdm_shared", dfrc_one["wdm_shared"], got, "NCCL at world 1", None, dev),
        "collectives": pdfrc_collectives("wdm_shared", "shared", dfrc["wdm_shared"][1], got,
                                         "NCCL at world 1", 1)}
    emit({"phase": "parallel_dfrc", "card": card, **dfrc_out})
    return {"pipeline": out["pipeline"]}


def pserve_configs() -> dict:
    """The parallel serving phase's configs: reservoir_lm at full width and
    depth, granite-8b at full width cut to PSERVE_GRANITE_LAYERS layers,
    both f32."""
    from repro_torch.configs import get_config

    granite = get_config("granite-8b")
    return {"reservoir_lm": dataclasses.replace(get_config("reservoir_lm"), dtype="float32"),
            "granite-8b": dataclasses.replace(granite, dtype="float32",
                                              n_layers=PSERVE_GRANITE_LAYERS),
            "xlstm-1.3b": xlstm_unit_config()}


def pserve_cases() -> tuple:
    """(name, arch, mesh shape, batch) of the phase's sharded runs."""
    b = PSERVE_BATCH[0]
    return (("reservoir_lm_1x2", "reservoir_lm", (1, 2), b),
            ("reservoir_lm_2x1", "reservoir_lm", (2, 1), b),
            ("reservoir_lm_2x1_batch1", "reservoir_lm", (2, 1), 1),
            ("granite-8b_1x2", "granite-8b", (1, 2), b),
            ("xlstm-1.3b_1x2", "xlstm-1.3b", (1, 2), b))


def pserve_params(cfg, dev):
    """The phase's params of ``cfg`` (and the parallel phase's pipeline
    case's), drawn on ``dev`` from PSERVE_SEED (an sLSTM's r_rec at
    1/sqrt(head_dim): ``calm_slstm``)."""
    import torch

    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(PSERVE_SEED), device=dev)
    calm_slstm(cfg, params)
    return params


def pserve_model_gathers(cfg, m: int, rows: int) -> int:
    """The bytes a decode step's all-gathers over "model" return on a rank
    of a (1, ``m``) mesh serving ``rows`` rows of xlstm ``cfg`` (f32): each
    leaf the plan gathers whole whose spec names "model" ("gathered"), the
    logits' vocab columns, and a layer's activations: the mLSTM's
    ``up_proj`` product, the sLSTM's pre-activations and (its heads a
    block) its output with the cache's m.  No weight block a block computes
    on, and no C, n, c or h cache block."""
    from repro_torch.models.model import meta_params
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding

    mesh = sharding.AbstractMesh((1, m), ("data", "model"))
    labels = sharding.spec_leaves(sharding.use_labels(cfg, mesh))
    specs = sharding.spec_leaves(sharding.param_pspecs(cfg, mesh))
    total = sum(4 * t.numel() for t, label, spec in
                zip(tree_leaves(meta_params(cfg)), labels, specs, strict=True)
                if label == "gathered" and any("model" in sharding.entry_axes(e) for e in spec))
    total += 4 * rows * cfg.vocab_size
    for blk in cfg.unit:
        d = cfg.d_model
        per = 2 * d * cfg.mlstm_expand if blk.mixer == "mlstm" else 4 * d + d + cfg.n_heads
        total += 4 * rows * per * cfg.n_units
    return total


def pserve_run(cfg, params, prompts, dev, decodes: int, *, feed=None, batch=None) -> dict:
    """Serve ``prompts`` (under the active mesh, if any: this rank's blocks
    and rows of a batch of ``batch``): a prefill, then ``decodes`` decode
    steps fed the columns of ``feed`` (None: greedy).  Returns the logits
    of each step (host), the greedy ids [B, 1 + decodes],
    prefill ms, each decode step's ms, K1's (launches, calls) of each step,
    the collectives of the last decode step and the peak device bytes."""
    import torch

    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.parallel import sharding
    from repro_torch.runtime.steps import serve_decode, serve_prefill

    max_len = prompts.shape[1] + decodes
    out = {"logits": [], "decode_ms": [], "k1": []}
    ids = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        reset_counts()
        par_sync(dev)
        t0 = time.perf_counter()
        logit, cache = serve_prefill(cfg, params, prompts, max_len=max_len, batch=batch)
        par_sync(dev)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["k1"].append((scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls))
        for i in range(decodes + 1):
            out["logits"].append(logit.cpu())
            ids.append(torch.argmax(logit, dim=-1)[:, None])
            if i == decodes:
                break
            tok = ids[-1] if feed is None else feed[:, i:i + 1]
            reset_counts()
            par_sync(dev)
            t0 = time.perf_counter()
            with sharding.record_collectives() as events:
                logit, cache = serve_decode(cfg, params, cache, tok)
            par_sync(dev)
            out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            out["k1"].append((scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls))
    out["ids"] = torch.cat(ids, dim=1)
    out["events"] = [dict(e) for e in events]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return out


def pserve_rank(rank: int, dev_type: str, cfgs: dict, cases: tuple, prompts: dict,
                feeds: dict, decodes: int) -> dict:
    """One rank of the parallel serving phase's two (gloo, the one card):
    each case (``pserve_cases``) from the seeded params of its config in
    ``cfgs``, cut by ``param_pspecs``, its rows of the prompts and of the
    feed; a short warm serve first.  Every rank's greedy ids gathered and
    checked identical."""
    import torch

    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import gathered_ids
    from repro_torch.parallel import sharding

    dev = par_device(dev_type)
    out = {}
    for name, arch, shape, batch in cases:
        cfg = cfgs[arch]
        mesh = make_mesh(shape, ("data", "model"), device_type=dev.type)
        params = sharding.tree_shard(pserve_params(cfg, dev), sharding.param_pspecs(cfg, mesh),
                                     mesh)
        rows = sharding.serve_rows(torch.as_tensor(prompts[arch][:batch], device=dev), mesh)
        feed = sharding.serve_rows(torch.as_tensor(feeds[(arch, batch)], device=dev), mesh)
        with sharding.use_mesh(mesh):
            pserve_run(cfg, params, rows[:, :16], dev, 2, feed=feed, batch=batch)  # warm
            run = pserve_run(cfg, params, rows, dev, decodes, feed=feed, batch=batch)
        run["ids"] = gathered_ids(run["ids"], batch, mesh)
        run["decode_collective_bytes"] = collective_bytes(run["events"])
        run["decode_model_gather_bytes"] = sum(e["bytes"] for e in run["events"]
                                               if e["kind"] == "all-gather" and
                                               e["axis"] == "model")
        run["decode_collectives"] = len(run.pop("events"))
        out[name] = run
        del params
        torch.cuda.empty_cache()
    return out


def pserve_nccl_rank(rank: int, dev_type: str, cfg, prompts, feed, decodes: int) -> dict:
    """``cfg`` served through NCCL at world 1 on the (1, 1) mesh, after a
    short warm serve."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import gathered_ids
    from repro_torch.parallel import sharding

    dev = par_device(dev_type)
    mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
    params = sharding.tree_shard(pserve_params(cfg, dev), sharding.param_pspecs(cfg, mesh),
                                 mesh)
    prompts, feed = torch.as_tensor(prompts, device=dev), torch.as_tensor(feed, device=dev)
    with sharding.use_mesh(mesh):
        pserve_run(cfg, params, prompts[:, :16], dev, 2, feed=feed, batch=prompts.shape[0])
        run = pserve_run(cfg, params, prompts, dev, decodes, feed=feed, batch=prompts.shape[0])
    run["ids"] = gathered_ids(run["ids"], prompts.shape[0], mesh)
    run["backend"] = torch.distributed.get_backend()
    run.pop("events")
    return run


def phase_parallel_serving(dev, card: str) -> None:
    """Sharded serving on the card (see the module doc, phase 25)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfgs, cases = pserve_configs(), pserve_cases()
    res, granite, xl = cfgs["reservoir_lm"], cfgs["granite-8b"], cfgs["xlstm-1.3b"]
    check(res.n_layers == 12 and res.d_model == 768 and res.reservoir_nodes == 256 and
          res.vocab_size == 32000 and granite.d_model == 4096 and granite.n_heads == 32 and
          granite.n_kv_heads == 8 and granite.d_ff == 14336 and granite.vocab_size == 49152 and
          xl.d_model == 2048 and xl.n_heads == 4 and xl.d_model * xl.mlstm_expand == 4096 and
          int(xl.d_model * xl.slstm_proj) == 2730 and xl.vocab_size == 50304 and
          xl.n_units == 1 and len(xl.unit) == 8,
          f"the parallel serving phase's configs: {cfgs}")
    shutil.rmtree(PSERVE_DIR, ignore_errors=True)
    PSERVE_DIR.mkdir(parents=True, exist_ok=True)

    # one process: each arch's greedy serve (its ids feed the ranks) and its
    # own row-split spread (PSERVE_NUDGED: and its spread under a nudge of
    # every weight, fed the same ids)
    prompts, feeds, ref, tol = {}, {}, {}, {}
    for arch, cfg in cfgs.items():
        prompts[arch] = lm_tokens(cfg, PSERVE_BATCH, PSERVE_SEED)
        params = pserve_params(cfg, dev)
        toks = torch.as_tensor(prompts[arch], device=dev)
        with torch.no_grad():
            spread = row_split_spread(cfg, params, toks)
        tol[arch] = {"row_split_spread": spread}
        for batch in sorted({b for _, a, _, b in cases if a == arch}):
            pserve_run(cfg, params, toks[:batch, :16], dev, 2)                    # warm
            run = pserve_run(cfg, params, toks[:batch], dev, PSERVE_DECODES)
            feeds[(arch, batch)] = run["ids"][:, :PSERVE_DECODES].cpu().numpy()
            ref[(arch, batch)] = run
        if arch in PSERVE_NUDGED:
            nudge_params(params, dev)
            (batch,) = {b for _, a, _, b in cases if a == arch}
            nudged = pserve_run(cfg, params, toks[:batch], dev, PSERVE_DECODES,
                                feed=torch.as_tensor(feeds[(arch, batch)], device=dev))
            tol[arch]["nudged_spread"] = max(
                float((g - w).abs().max())
                for g, w in zip(nudged["logits"], ref[(arch, batch)]["logits"], strict=True))
        tol[arch]["tol"] = max(PAR_SPREAD_FACTOR * max(v for v in tol[arch].values()),
                               PSERVE_TOL_FLOOR)
        del params
        torch.cuda.empty_cache()
    per_step = res.n_layers
    for batch in {b for _, a, _, b in cases if a == "reservoir_lm"}:
        k1 = ref[("reservoir_lm", batch)]["k1"]
        check(all(tuple(c) == (per_step, per_step) for c in k1),
              f"parallel serving: the unsharded serve's K1 (launches, calls) {k1}")

    ranks, ranks_s = wall(lambda: run_ranks(pserve_rank, 2, store_dir=str(PSERVE_DIR),
                                            args=(dev.type, cfgs, cases, prompts, feeds,
                                                  PSERVE_DECODES),
                                            timeout=PSERVE_TIMEOUT_S, threads=None))
    out = {"configs": {arch: {"layers": c.n_layers, "d_model": c.d_model,
                              "vocab": c.vocab_size, "dtype": c.dtype}
                       for arch, c in cfgs.items()},
           "batch": list(PSERVE_BATCH), "decode_steps": PSERVE_DECODES, "backend": "gloo",
           "ranks": 2, "tol": tol, "ranks_s": ranks_s, "unsharded": {}}
    for (arch, batch), run in ref.items():
        out["unsharded"][f"{arch}_batch{batch}"] = {
            "prefill_ms": run["prefill_ms"],
            "decode_ms_p50": float(np.percentile(run["decode_ms"], 50)),
            "peak_bytes": run["peak_bytes"]}
    for name, arch, shape, batch in cases:
        want = ref[(arch, batch)]
        rec = {"mesh": list(shape), "batch": batch, "by_rank": []}
        ids0 = torch.as_tensor(ranks[0][name]["ids"])
        for rank, r in enumerate(ranks):
            run = r[name]
            d = rank // shape[1]
            rows = slice(0, batch) if batch % shape[0] else \
                slice(d * batch // shape[0], (d + 1) * batch // shape[0])
            gap = max(float((torch.as_tensor(g) - w[rows]).abs().max())
                      for g, w in zip(run["logits"], want["logits"], strict=True))
            check(gap <= tol[arch]["tol"], f"parallel serving {name} rank {rank}: logits "
                                           f"{gap} off one process's, tolerance {tol[arch]}")
            check(torch.equal(torch.as_tensor(run["ids"]), ids0),
                  f"parallel serving {name}: the ranks' greedy ids differ")
            if arch == "reservoir_lm":
                check(all(tuple(c) == (per_step, per_step) for c in run["k1"]),
                      f"parallel serving {name} rank {rank}: K1 (launches, calls) "
                      f"{run['k1']}, want {per_step} each a step")
            if arch == "xlstm-1.3b":
                want_bytes = pserve_model_gathers(cfgs[arch], shape[1], rows.stop - rows.start)
                check(run["decode_model_gather_bytes"] == want_bytes,
                      f"parallel serving {name} rank {rank}: a decode step all-gathered "
                      f"{run['decode_model_gather_bytes']} bytes over \"model\", want "
                      f"{want_bytes} (the whole leaves and the activations alone)")
            rec["by_rank"].append({
                "max_logit_gap": gap, "prefill_ms": run["prefill_ms"],
                "decode_ms_p50": float(np.percentile(run["decode_ms"], 50)),
                "peak_bytes": run["peak_bytes"],
                "k1_launches_calls_per_step": list(run["k1"][-1]),
                "decode_collective_bytes": run["decode_collective_bytes"],
                "decode_model_gather_bytes": run["decode_model_gather_bytes"],
                "decode_collectives": run["decode_collectives"]})
        rec["ids_share_equal_unsharded"] = float((ids0 == want["ids"].cpu()).float().mean())
        out[name] = rec
    # NCCL at world 1
    one = ref[("reservoir_lm", PSERVE_BATCH[0])]
    (nccl,) = run_ranks(pserve_nccl_rank, 1, store_dir=str(PSERVE_DIR), backend="nccl",
                        args=(dev.type, res, prompts["reservoir_lm"],
                              feeds[("reservoir_lm", PSERVE_BATCH[0])], PSERVE_DECODES),
                        timeout=PSERVE_TIMEOUT_S, threads=None)
    same = all(torch.equal(torch.as_tensor(g), w)
               for g, w in zip(nccl["logits"], one["logits"], strict=True))
    check(nccl["backend"] == "nccl" and same and
          torch.equal(torch.as_tensor(nccl["ids"]), one["ids"].cpu()),
          f"parallel serving: NCCL at world 1 is not bitwise the unsharded serve "
          f"({nccl['backend']}, logits {same})")
    check(all(tuple(c) == (per_step, per_step) for c in nccl["k1"]),
          f"parallel serving NCCL: K1 (launches, calls) {nccl['k1']}")
    out["nccl_world1"] = {"logits_bitwise": same, "ids_bitwise": True,
                          "prefill_ms": nccl["prefill_ms"],
                          "decode_ms_p50": float(np.percentile(nccl["decode_ms"], 50))}
    shutil.rmtree(PSERVE_DIR, ignore_errors=True)
    emit({"phase": "parallel_serving", "card": card, **out,
          "seconds": time.perf_counter() - t0})


def phase_kernels_line(dev, narma, paths: dict) -> None:
    """Each kernel at the shapes of the path it rides, with that path's
    launch count: K1 at one streamed chunk (broadcast mask, N = 900) and in
    its per-lane mode at one WDM chunk (N = 100); K2 at the main path's
    Gram; K3 at a fold chunk of each path that launches it (streamed
    NARMA10 [64, 256, 901], WDM [64, 256, 101], the shared readout
    [1, 256, 801]), onto the symmetric running stacks K2 made of the chunk
    before, as the fold hands them in.  Each Gram row carries its bound
    share (bound_ms / ms) and its time against one PyTorch call
    (vs_library = ms / library_ms).

    K1 (SiliconMR) is held to its plain version exactly where its paths
    launch it, each time on the first SPLIT_CHECK_K periods (the plain
    version's node loop, tens of seconds a 256-period chunk at N = 900,
    is the line's slowest part): on chunk 1 of the stream, resumed from the kernel's
    carry after chunk 0 (f32 states and carry; bf16 states the f32 states
    rounded, bitwise, and within half a bf16 ulp of the plain f32 state),
    and on a whole split from a zero state, as the materialized paths
    launch it (NARMA10 [64, 1000, 900], WDM [64, 10000, 100]).
    ``plain_ms`` is the plain version's time on the resumed periods
    (``plain_shape_bkn``); the kernel is timed on the whole chunk.  Beside its
    roofline bound, each K1 row has its chain bound (``chain_bound_ms``:
    K·N dependent chain steps at the card's maximum SM clock, each of
    CHAIN_OPS f32 ops at the latency ``chain_cycles`` measures in this run,
    beside the measured cycles of the kernel's own chain step) and the
    lanes a block of its layout.

    Two K1 rows time a whole split from zero as its path launches it, held
    to the plain version on its first periods (``split_row``): the CMT
    form at the cmt_main split [64, 1000, 900] (its chain bound from the
    CMT chain step that ``chain_cycles`` measures) and the host
    accelerator's [1, 1000, 900]."""
    import torch

    from repro_torch.core import build_stage_masks, generate_states, make_mask
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.readout_apply import ops as apply_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops
    from repro_torch.launch.time_kernels import kernel_times
    from repro_torch.pipeline import composed_chunk_states_fn, with_bias
    from repro_torch.pipeline.experiment import _canon_batch, _input_layer

    cfg, exp = paths["main"]["cfg"], paths["main"]["exp"]
    model = cfg.model
    tr_in = _canon_batch(narma[0], "inputs_train", dev)
    j_tr, _ = _input_layer(cfg, tr_in, tr_in)
    y_tr = _canon_batch(narma[1], "targets_train", dev)[..., None]
    rows = []
    cycles = chain_cycles(dev)
    clocks = sm_clocks_mhz()

    def times(fn, reps, bound, library=None):
        """The kernel's ``ms``, ``cold_ms`` and ``call_ms`` (kernel_times),
        its bound share of ``cold_ms``, and the library call's times."""
        t = kernel_times(fn, reps)
        out = {"ms": t["ms"], "cold_ms": t["cold_ms"], "call_ms": t["call_ms"],
               "host_ahead": t["host_ahead"], "bound_share": bound / t["cold_ms"]}
        if library is not None:
            lt = kernel_times(library, reps)
            out.update(library_ms=lt["ms"], library_cold_ms=lt["cold_ms"],
                       library_call_ms=lt["call_ms"], library_host_ahead=lt["host_ahead"],
                       vs_library=t["ms"] / lt["ms"])
        return out

    def plain_time(fn, reps):
        return kernel_times(fn, reps, cold=False)["ms"]

    def scan_row(name, j, mask, launches, path, chunk=STREAM_CHUNK, model=model):
        b, k = j.shape
        n = mask.shape[-1]
        zero = torch.zeros((b, n), dtype=torch.float32, device=dev)
        checks = []
        # chunk 1, resumed from the kernel's carry after chunk 0: its first
        # ck periods (the plain version's node loop is the run's slowest part)
        ck = min(chunk, SPLIT_CHECK_K)
        _, carry = scan_ops.dfr_scan(model, j[:, :chunk], mask, zero, return_final=True)
        j1 = j[:, chunk:2 * chunk].contiguous()
        j1c = j1[:, :ck].contiguous()
        out, fin = scan_ops.dfr_scan(model, j1c, mask, carry, return_final=True)
        out16 = scan_ops.dfr_scan(model, j1c, mask, carry, out_dtype=torch.bfloat16)
        (ref, ref_fin), plain_s = wall(lambda: scan_ops.dfr_scan_plain(model, j1c, mask, carry))
        err = max(max_err(out, ref), max_err(fin, ref_fin))
        # rounding an f32 state to bf16 (8 significant bits) moves it by at most
        # 2^-8 of itself
        bf16_excess = float(((out16.float() - ref).abs() - ref.abs() * 2.0 ** -8).max())
        checks.append({"what": "chunk 1 from the carry of chunk 0, its first periods",
                       "shape_bkn": [b, ck, n], "max_abs_err": err,
                       "bf16_err_beyond_half_ulp": bf16_excess, "plain_s": plain_s})
        check(err == 0.0, f"{name} vs plain on a resumed chunk: {err}")
        check(bf16_excess <= 2e-6, f"{name} bf16 states vs plain: {bf16_excess} beyond half an ulp")
        check(torch.equal(out16, out.to(torch.bfloat16)),
              f"{name}: bf16 states are not the f32 states rounded")
        del out, out16, ref
        # the whole split from a zero state, as the materialized paths
        # launch it; its first ck periods against the plain version
        out = scan_ops.dfr_scan(model, j, mask, zero)[:, :ck]
        (ref, _), full_s = wall(lambda: scan_ops.dfr_scan_plain(model, j[:, :ck].contiguous(),
                                                                 mask, zero))
        err_full = max_err(out, ref)
        checks.append({"what": "whole split from zero, its first periods", "shape_bkn": [b, k, n],
                       "checked_k": ck, "max_abs_err": err_full, "plain_s": full_s})
        check(err_full == 0.0, f"{name} vs plain on a whole split: {err_full}")
        del out, ref
        bound, by = bound_ms(4 * (b * chunk + mask.numel() + 2 * b * n + b * chunk * n),
                             SCAN_OPS_PER_STEP * b * chunk * n)
        t = times(lambda: scan_ops.dfr_scan(model, j1, mask, carry), 5, bound)
        ms = t["ms"]
        # each lane's K·N steps are one dependent chain, each step at least
        # CHAIN_OPS dependent f32 ops; lanes run side by side
        chain_bound = chunk * n * cycles["least_step"] / (clocks["max"] * 1e3)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/dfr_scan.cu",
                     "replaces": "src/repro/kernels/dfr_scan/dfr_scan.py:97",
                     "launches": launches, "path": path,
                     "max_abs_err": max(c["max_abs_err"] for c in checks), **t,
                     "plain_ms": plain_s * 1e3, "plain_shape_bkn": [b, ck, n],
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "chain_bound_ms": chain_bound,
                     "chain_bound_share": chain_bound / ms, "chain_cycles_per_step": cycles,
                     "sm_clock_mhz": clocks,
                     "lanes_per_block": scan_ops.scan_layout(b, n, mask.ndim == 2).lanes,
                     "shape_bkn": [b, chunk, n], "checks": checks})

    scan_row("dfr_scan", j_tr, exp.mask, paths["streaming"]["launches"][0],
             "streaming NARMA10, one launch per chunk")
    wdm = paths["wdm"]
    chans = wdm["chans"]
    j_wdm, _ = _input_layer(wdm["cfg"], _canon_batch(chans[0], "inputs_train", dev),
                            _canon_batch(chans[2], "inputs_test", dev))
    scan_row("dfr_scan_per_lane", j_wdm, wdm["masks"], wdm["launches"][0],
             "streaming WDM, one per-lane launch per chunk")

    def gram_row(name, replaces, launches, path, chunks, y_chunks):
        """K2 on ``chunks[0]`` alone, or K3 folding ``chunks[1]`` onto the
        running stacks K2 made of ``chunks[0]`` (symmetric bitwise, as every
        G0 the fold hands in), against the plain version and one PyTorch
        call on the same inputs.  K3 is also held to its plain version from
        a non-symmetric G0 (its full semantics), outside the timing."""
        into = len(chunks) == 2
        x, y = chunks[-1], y_chunks[-1]
        b, t, f = x.shape
        cols = y.shape[-1]
        if into:
            g0, c0 = gram_ops.gram_accumulate_batched(chunks[0], y_chunks[0])
            g, c = gram_ops.gram_accumulate_batched_into(g0.clone(), c0.clone(), x, y,
                                                         round_y=False)
            gp, cp = gram_ops.gram_plain_batched(x, y, g0=g0.clone(), c0=c0.clone(),
                                                 round_y=False)
        else:
            g, c = gram_ops.gram_accumulate_batched(x, y)
            gp, cp = gram_ops.gram_plain_batched(x, y)
        err = max(max_err(g, gp), max_err(c, cp))
        check(torch.allclose(g, gp, rtol=1e-5, atol=1e-4)
              and torch.allclose(c, cp, rtol=1e-5, atol=1e-4),
              f"{name} vs plain at {[b, t, f]}: {err}")
        check(torch.equal(g, g.mT), f"{name}: G is not symmetric bitwise at {[b, t, f]}")
        if into:
            r0 = torch.rand_like(g0)
            rc = torch.rand_like(c0)
            gi, ci = gram_ops.gram_accumulate_batched_into(r0.clone(), rc.clone(), x, y,
                                                           round_y=False)
            gq, cq = gram_ops.gram_plain_batched(x, y, g0=r0.clone(), c0=rc.clone(),
                                                 round_y=False)
            check(torch.allclose(gi, gq, rtol=1e-5, atol=1e-4)
                  and torch.allclose(ci, cq, rtol=1e-5, atol=1e-4),
                  f"{name} from a non-symmetric G0: {max_err(gi, gq)}")
            del r0, rc, gi, ci, gq, cq
            g_run, c_run = g0.clone(), c0.clone()
            kernel = (lambda: gram_ops.gram_accumulate_batched_into(
                g_run, c_run, x, y, round_y=False))
            g_pl, c_pl = g0.clone(), c0.clone()
            plain_ms = plain_time(lambda: gram_ops.gram_plain_batched(
                x, y, g0=g_pl, c0=c_pl, round_y=False), 5)
            lib_call, library = "torch.baddbmm", (lambda: torch.baddbmm(g0, x.mT, x))
            zeros = torch.zeros_like(g0), torch.zeros_like(c0)
            vs_bound = {"kernel": gram_error_ratio(*gram_ops.gram_accumulate_batched_into(
                            *zeros, x, y, round_y=False), x, y),
                        "plain": gram_error_ratio(*gram_ops.gram_plain_batched(
                            x, y, round_y=False), x, y)}
        else:
            kernel = (lambda: gram_ops.gram_accumulate_batched(x, y))
            plain_ms = plain_time(lambda: gram_ops.gram_plain_batched(x, y), 5)
            lib_call, library = "torch.bmm", (lambda: torch.bmm(x.mT, x))
            vs_bound = {"kernel": gram_error_ratio(g, c, x, y),
                        "plain": gram_error_ratio(gp, cp, x, y)}
        # G is symmetric: the function needs F(F+1)/2 dot products over T,
        # plus the F·C of c; accumulate-into also reads G0 and c0 and adds them
        bound, by = bound_ms(4 * (b * t * (f + cols) + (1 + into) * b * f * (f + cols)),
                             b * t * f * (f + 1) + 2 * b * t * f * cols
                             + into * b * (f * (f + 1) // 2 + f * cols))
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/ridge_gram.cu",
                     "replaces": replaces, "launches": launches, "path": path,
                     "max_abs_err": err, **times(kernel, 5, bound, library),
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_call": lib_call,
                     "shape_btf": [b, t, f], "g0": "K2 of the chunk before" if into else None,
                     "symmetric_bitwise": True, "error_vs_f32_sum_bound": vs_bound})
        return g

    k2, k3 = ("src/repro/kernels/ridge_gram/ridge_gram.py:118",
              "src/repro/kernels/ridge_gram/ridge_gram.py:147")
    # K2 at the main path's Gram: features [B, T - washout, N + 1]
    states = generate_states(model, j_tr, exp.mask, method="kernel", device=dev)
    g_main = gram_row("ridge_gram", k2, paths["main"]["launches"][1], "materialized NARMA10",
                      [with_bias(states[:, cfg.washout:])], [y_tr[:, cfg.washout:]])
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(g_main), reps=2)
    bb, f = g_main.shape[:2]
    del g_main
    svd_x = {"NARMA10 MR readout": with_bias(states[:, cfg.washout:])}

    # K3 at the streamed fold's chunk 1 of 256 rows, onto the running stacks
    # of chunk 0: bias-extended states [B, 256, N + 1] and f32 targets
    def two_chunks(st, yy):
        return ([with_bias(st[:, :STREAM_CHUNK]), with_bias(st[:, STREAM_CHUNK:2 * STREAM_CHUNK])],
                [yy[:, :STREAM_CHUNK].contiguous(),
                 yy[:, STREAM_CHUNK:2 * STREAM_CHUNK].contiguous()])

    gram_row("ridge_gram_into", k3, paths["streaming"]["launches"][2],
             "streaming NARMA10, one launch per fit chunk", *two_chunks(states, y_tr))
    del states
    # K3 at the WDM fold's chunk [64, 256, N_WDM + 1] (per-lane states)
    zero_w = torch.zeros((j_wdm.shape[0], N_WDM), dtype=torch.float32, device=dev)
    st_w = scan_ops.dfr_scan(wdm["cfg"].model, j_wdm[:, :2 * STREAM_CHUNK].contiguous(),
                             wdm["masks"], zero_w)
    y_w = _canon_batch(chans[1], "targets_train", dev)[..., None]
    gram_row("ridge_gram_into_wdm", k3, wdm["launches"][2],
             "streaming WDM, one launch per fit chunk", *two_chunks(st_w, y_w))
    del j_wdm, st_w
    # K3 at the shared readout's chunk [1, 256, R·N + 1] (one instance)
    shared = wdm["shared"]
    xs = shared["x"][None, :2 * STREAM_CHUNK]
    ys = shared["y"][None, :2 * STREAM_CHUNK]
    gram_row("ridge_gram_into_shared", k3, shared["launches"],
             "WDM shared readout, one launch per fit chunk",
             [xs[:, :STREAM_CHUNK].contiguous(), xs[:, STREAM_CHUNK:].contiguous()],
             [ys[:, :STREAM_CHUNK].contiguous(), ys[:, STREAM_CHUNK:].contiguous()])
    # the serving tick at B = 4096: K1 on chunk 1 of 32 periods from the carry
    # of chunk 0, K3 folding chunk 2 (all rows past the washout) onto the
    # stacks K2 made of chunk 1
    serve = paths["serving"]
    ticks = serve["ticks"]
    scan_row("dfr_scan_serving", serve["j"][:, :2 * SERVE_CHUNK].contiguous(), serve["mask"],
             serve["launches"]["dfr_scan"], f"serving, B = {SERVE_B}: one launch a tick "
             f"({ticks} ticks)", chunk=SERVE_CHUNK)
    st_s = scan_ops.dfr_scan(serve["model"], serve["j"], serve["mask"],
                             torch.zeros((SERVE_B, SERVE_N), device=dev))
    y_s = serve["y"][..., None]
    ck = SERVE_CHUNK
    gram_row("ridge_gram_into_serving", k3, serve["launches"]["ridge_gram_into"],
             f"serving, B = {SERVE_B}: one launch a tick ({ticks} ticks)",
             [with_bias(st_s[:, ck:2 * ck]), with_bias(st_s[:, 2 * ck:])],
             [y_s[:, ck:2 * ck].contiguous(), y_s[:, 2 * ck:].contiguous()])
    for row in rows:
        if row["name"].endswith("_serving"):
            row["launches_per_tick"] = row["launches"] / ticks
    del st_s

    def split_row(name, model, j, mask, launches, path, check_k, tol, step_cycles, ops):
        """K1 on a whole split from a zero state, as a materialized path
        launches it: timed at its full shape, held to its plain version on
        the first ``check_k`` periods (whose time is ``plain_ms``).  A form
        with no node chain (MZISine: ``step_cycles`` None) has no chain
        bound.  MackeyGlass's helper-warp route is also held bitwise to the
        chain kernel's MackeyGlass route on the whole split (states and
        carry; that one call's device time is ``chain_route_ms``)."""
        b, k = j.shape
        n = mask.shape[-1]
        per_lane = mask.ndim == 2
        zero = torch.zeros((b, n), dtype=torch.float32, device=dev)
        jk = j[:, :check_k].contiguous()
        out = scan_ops.dfr_scan(model, jk, mask, zero)
        (ref, _), plain_s = wall(lambda: scan_ops.dfr_scan_plain(model, jk, mask, zero))
        err = max_err(out, ref)
        check(err <= tol, f"{name} vs plain on the first {check_k} periods: {err} > {tol}")
        del out, ref
        route = scan_ops.scan_route(model)
        layout = scan_ops.launch_layout(model, b, n, per_lane)
        vs_chain = {}
        if route == "helpers":
            got = scan_ops.dfr_scan(model, j, mask, zero, return_final=True)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            want = scan_ops.dfr_scan_at(model, j, mask, zero, scan_ops.scan_layout(b, n, per_lane))
            end.record()
            end.synchronize()
            bitwise = all(same_bits(x, y) for x, y in zip(got, want))
            check(bitwise, f"{name}: the helper-warp route is not the chain route bitwise on "
                           f"the whole split {[b, k, n]}")
            vs_chain = {"chain_route_bitwise_whole_split": bitwise,
                        "chain_route_ms": start.elapsed_time(end)}
            del got, want
        bound, by = bound_ms(4 * (b * k + mask.numel() + 2 * b * n + b * k * n), ops * b * k * n)
        t = times(lambda: scan_ops.dfr_scan(model, j, mask, zero), 3, bound)
        ms = t["ms"]
        chain_bound = (None if step_cycles is None
                       else k * n * step_cycles / (clocks["max"] * 1e3))
        if vs_chain:
            vs_chain["chain_route_share_of_chain_bound"] = chain_bound / vs_chain["chain_route_ms"]
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/dfr_scan.cu",
                     "replaces": "src/repro/kernels/dfr_scan/dfr_scan.py:97",
                     "launches": launches, "path": path, "max_abs_err": err,
                     "exact_vs_plain": err == 0.0, **t, "plain_ms": plain_s * 1e3,
                     "plain_shape_bkn": [b, check_k, n], "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "chain_bound_ms": chain_bound,
                     "chain_bound_share": None if chain_bound is None else chain_bound / ms,
                     "chain_cycles_per_step": cycles,
                     "cycles_per_node_at_max_clock": ms * clocks["max"] * 1e3 / (k * n),
                     "sm_clock_mhz": clocks, "kernel_route": route,
                     "lanes_per_block": None if layout is None else layout.lanes,
                     "shape_bkn": [b, k, n], **vs_chain})

    # the materialized NARMA10 path's train split, as Experiment.run launches
    # it (twice a run: train and test)
    split_row("dfr_scan_materialized", model, j_tr, exp.mask, paths["main"]["launches"][0],
              "materialized NARMA10, one launch a split", SPLIT_CHECK_K, 0.0,
              cycles["least_step"], SCAN_OPS_PER_STEP)
    # the CMT form at the cmt_main path's split; its chain bound counts the
    # CMT chain step as measured (chain_cycles "cmt_step")
    cmt_exp = paths["cmt"]["exp"]
    cmt = cmt_exp.config.model
    split_row("dfr_scan_cmt", cmt, j_tr, cmt_exp.mask, paths["cmt"]["launches"][0],
              "cmt_main: materialized NARMA10 on the CMT cavity", CMT_CHECK_K, 1e-5,
              cycles["cmt_step"], cmt_ops_per_step(cmt.n_substeps))
    # the host accelerator's split, one lane (seed 0's train split)
    split_row("dfr_scan_accelerator", model, j_tr[:1].contiguous(), exp.mask,
              paths["accelerator"]["launches"][0], "DFRCAccelerator fit + predict, B = 1",
              SPLIT_CHECK_K, 0.0, cycles["least_step"], SCAN_OPS_PER_STEP)
    # the Fig. 5/6 cells' other forms, each at a train split of its cells:
    # MackeyGlass on its helper-warp route (its chain bound from the MG chain
    # step that chain_cycles measures, the mul-add the chain warp runs alone;
    # the helper warps issue the chain-free powf and division beside it,
    # which the bound does not count) and MZISine (no node chain: its byte
    # bound)
    figs = paths["figures"]
    for name, key, task, acc, ops in (
            ("dfr_scan_mg", "narma10", "narma10", "Electronic (MG)", MG_OPS_PER_STEP),
            ("dfr_scan_mg", "channel_eq@24dB", "channel_eq", "Electronic (MG)", MG_OPS_PER_STEP),
            ("dfr_scan_mzi", "narma10", "narma10", "All Optical (MZI)", MZI_OPS_PER_STEP)):
        fcfg = figure_config(task, acc)
        fmask = make_mask(fcfg.n_nodes, levels=fcfg.mask_levels, seed=fcfg.mask_seed, device=dev)
        tr = _canon_batch(figs["data"][key][0], "inputs_train", dev)
        j_f, _ = _input_layer(fcfg, tr, tr)
        form = f"{type(fcfg.model).__name__} N={fcfg.n_nodes}"
        step = cycles["mg_step"] if ops == MG_OPS_PER_STEP else None
        split_row(f"{name}_{key.split('@')[0]}", fcfg.model, j_f, fmask, figs["launches"][form],
                  f"paper_figures: {form}, every cell of the form (B = {B_MAIN}, 2 a cell)",
                  SPLIT_CHECK_K, 1e-5, step, ops)
        if key == "channel_eq@24dB":
            st_f = generate_states(fcfg.model, j_f, fmask, method="kernel", device=dev)
            svd_x["channel_eq MG readout"] = with_bias(st_f[:, fcfg.washout:])
            del st_f
    # the composed path: K1 per-lane at d3_l2's first stage (two loops a
    # lane pair, the slow ring), K3 at its fold chunk [B, 64, 49]
    comp = paths["composed"]
    g3 = comp["graph"]
    st0 = g3.stages[0]
    m0 = build_stage_masks(g3, device=dev)[0].repeat(B_MAIN, 1)
    scan_row("dfr_scan_composed_per_lane", comp["j"].repeat_interleave(st0.loops, dim=0), m0,
             comp["launches"]["dfr_scan"], "composed: one launch a stage a chunk (six "
             "topologies; this row d3_l2's first stage)", chunk=MC_CHUNK, model=st0.model)
    fn = composed_chunk_states_fn(g3, build_stage_masks(g3, device=dev), device=dev)
    f0, carry = fn(comp["j"][:, :MC_CHUNK].contiguous(), (None,) * g3.depth)
    f1, _ = fn(comp["j"][:, MC_CHUNK:2 * MC_CHUNK].contiguous(), carry)
    yc = comp["y"]
    gram_row("ridge_gram_into_composed", k3, comp["launches"]["ridge_gram_into"],
             "composed: one launch a fit chunk (six topologies; this row d3_l2)",
             [with_bias(f0), with_bias(f1)],
             [yc[:, :MC_CHUNK].contiguous(), yc[:, MC_CHUNK:2 * MC_CHUNK].contiguous()])
    # the LM's reservoir mixer: K1 at reservoir_lm's lanes (B·R = 24, N =
    # 256) on layer 0's prompt drive, at the prefill's 512 periods from a
    # zero state (as the prefill launches it) and at a decode step's one
    # period resumed from a carry
    lm = paths["lm"]
    split_row("dfr_scan_lm_prefill", lm["model"], lm["j"], lm["mask"], lm["prefill_launches"],
              "lm_serving: reservoir_lm prefill, one launch a layer (12)", SPLIT_CHECK_K, 0.0,
              cycles["least_step"], SCAN_OPS_PER_STEP)
    scan_row("dfr_scan_lm_decode", lm["j"][:, :2].contiguous(), lm["mask"],
             lm["decode_launches"], f"lm_serving: reservoir_lm decode, one launch a layer a "
             f"step ({lm['decode_launches']} over {LM_SERVE_NEW - 1} steps)", chunk=1,
             model=lm["model"])
    # the pipelined reservoir_lm (phase_parallel): K1 on a microbatch's B·R
    # = 6 lanes, a stage's unit at a tick, on layer 0's drive of the
    # prefill's first two rows
    pipe = paths["parallel"]["pipeline"]
    pipe_rank0 = pipe["by_rank"][0]
    pipe_lanes = lm["j"].shape[0] // LM_SERVE_B * pipe["microbatch_tokens"][0]
    split_row("dfr_scan_lm_pipeline", lm["model"], lm["j"][:pipe_lanes].contiguous(),
              lm["mask"], pipe_rank0["k1_launches_calls"][0],
              f"parallel: reservoir_lm over {pipe['stages']} gloo pipeline stages, one launch "
              f"a unit a tick on each rank ({pipe_rank0['units']} units x {pipe['ticks']} "
              f"ticks a call)", SPLIT_CHECK_K, 0.0, cycles["least_step"], SCAN_OPS_PER_STEP)

    # the LM's training step (phase_lm_training): K1 emitting f32 states at
    # layer 0's first forward, from zero, as the step launches it (12 layers
    # x 4 microbatches x 2 a step: the remat runs each forward again), and
    # K1ᵀ at the step's first backward (layer 11, microbatch 0; 12 x 4)
    tr = paths["lm_training"]
    model_t, j_t, mask_t, _ = tr["k1"]
    split_row("dfr_scan_lm_train", model_t, j_t, mask_t, tr["launches"]["dfr_scan"],
              f"lm_training: reservoir_lm train step, f32 states, {tr['per_step']['dfr_scan']} "
              f"launches a step ({LM_TRAIN_STEPS} steps)", SPLIT_CHECK_K, 0.0,
              cycles["least_step"], SCAN_OPS_PER_STEP)
    rows[-1]["launches_per_step"] = tr["per_step"]["dfr_scan"]

    def grad_row(name, args, launches, per_step, path):
        """K1ᵀ at its path's shape: held bitwise to its plain version on the
        first SPLIT_CHECK_K periods of the same inputs (whose time is
        ``plain_ms``), timed at the full shape, with its byte bound and its
        chain bound (K·N steps of its chain step, a mul and an add, at the
        latency ``chain_cycles`` measures: ``grad_step``); also timed with
        TPA saturation (beta 0.5, the helpers' division) on the same inputs,
        and its block layout."""
        model, j, mask, s0, states, g, g_fin = args
        b, k = j.shape
        n = mask.shape[-1]
        ck = SPLIT_CHECK_K
        cut = (model, j[:, :ck].contiguous(), mask, s0, states[:, :ck].contiguous(),
               g[:, :ck].contiguous(), g_fin)
        dj, ds0 = scan_ops.dfr_scan_grad(*cut)
        (pj, ps), plain_s = wall(lambda: scan_ops.dfr_scan_grad_plain(*cut))
        err = max(max_err(dj, pj), max_err(ds0, ps))
        check(same_bits(dj, pj) and same_bits(ds0, ps),
              f"{name} vs plain on the first {ck} periods: {err}")
        check(bool(torch.isfinite(scan_ops.dfr_scan_grad(*args)[0]).all()), f"{name}: dj")
        # the gradient of the states and the f32 states read once, j, s0,
        # g_fin and the mask; dj and ds0 written
        bound, by = bound_ms(4 * (2 * b * k * n + 2 * b * k + 3 * b * n + n),
                             GRAD_OPS_PER_STEP * b * k * n)
        t = times(lambda: scan_ops.dfr_scan_grad(*args), 5, bound)
        tpa_args = (dataclasses.replace(model, beta_tpa=0.5), *args[1:])
        tpa = kernel_times(lambda: scan_ops.dfr_scan_grad(*tpa_args), 5)
        chain_bound = k * n * cycles["grad_step"] / (clocks["max"] * 1e3)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/dfr_scan_grad.cu",
                     "replaces": "src/repro/core/layer.py:71",
                     "replaces_note": "no TPU kernel: the gradient of the reference mixer's "
                                      "lax.scan, which jax.grad differentiates; the port's "
                                      "forward is K1",
                     "launches": launches, "launches_per_step": per_step, "path": path,
                     "max_abs_err": err, "bitwise_vs_plain": True, **t,
                     "plain_ms": plain_s * 1e3, "plain_shape_bkn": [b, ck, n],
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "chain_bound_ms": chain_bound, "chain_bound_share": chain_bound / t["ms"],
                     "chain_cycles_per_step": cycles,
                     "cycles_per_node_at_max_clock": t["ms"] * clocks["max"] * 1e3 / (k * n),
                     "sm_clock_mhz": clocks,
                     "beta_0p5": {key: tpa[key] for key in ("ms", "cold_ms", "call_ms")},
                     "layout": scan_ops.grad_layout(b, n)._asdict(),
                     "lanes_per_block": scan_ops.grad_layout(b, n).lanes, "shape_bkn": [b, k, n]})

    grad_row("dfr_scan_grad_lm_train", tr["k1t"], tr["launches"]["dfr_scan_grad"],
             tr["per_step"]["dfr_scan_grad"],
             f"lm_training: reservoir_lm train step, {tr['per_step']['dfr_scan_grad']} launches "
             f"a step ({LM_TRAIN_STEPS} steps)")

    def apply_row(name, x, w, launches, path):
        """The readout-apply kernel against its plain version (the widened
        matmul), bitwise from call to call, and one ``torch.baddbmm`` on the
        features already in f32."""
        b, t, n = x.shape
        cols = w.shape[-1]
        out = apply_ops.readout_apply(x, w)
        ref = apply_ops.readout_apply_plain(x, w)
        scale = with_bias(x).float().abs() @ w.abs()
        rel = float(((out - ref).abs() / scale).max())
        check(rel <= 1e-6, f"{name} vs plain at {[b, t, n]}: {rel} of the sum's magnitude")
        check(torch.equal(out, apply_ops.readout_apply(x, w)),
              f"{name}: two calls differ at {[b, t, n]}")
        xf = x.float()
        bound, by = bound_ms(x.numel() * x.element_size() + 4 * (w.numel() + out.numel()),
                             2 * b * t * (n + 1) * cols)
        plan = apply_ops.apply_plan(b, t, n, cols, x.dtype)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/readout_apply.cu",
                     "replaces": "src/repro/pipeline/experiment.py:336",
                     "replaces_note": "the reference's readout einsum: no TPU kernel",
                     "launches": launches, "path": path,
                     "max_abs_err": max_err(out, ref), "max_rel_err_of_sum_magnitude": rel,
                     "bitwise_vs_plain": bool(torch.equal(out, ref)),
                     "bitwise_share": float((out == ref).float().mean()),
                     **times(lambda: apply_ops.readout_apply(x, w), 20, bound,
                             lambda: torch.baddbmm(w[:, n:], xf, w[:, :n])),
                     "plain_ms": plain_time(lambda: apply_ops.readout_apply_plain(x, w), 5),
                     "bound_ms": bound, "bound_by": by,
                     "library_call": "torch.baddbmm(w[:, N:], x.float(), w[:, :N]), x widened "
                                     "before the timing",
                     "plan": {k: plan[k] for k in ("group", "seg", "passes", "row_groups",
                                                    "threads", "rows_per_block", "grid",
                                                    "smem_bytes")},
                     "shape_btn": [b, t, n], "cols": cols,
                     "dtype": str(x.dtype).removeprefix("torch.")})

    # the streamed evaluation's chunk [64, 256, 900] in bf16 (K1's own
    # states), and the session tick's [4096, 32, 64] f32
    gen = torch.Generator(device=dev).manual_seed(11)
    x16 = scan_ops.dfr_scan(model, j_tr[:, :STREAM_CHUNK].contiguous(), exp.mask,
                            torch.zeros((B_MAIN, cfg.n_nodes), device=dev),
                            out_dtype=torch.bfloat16)
    w16 = torch.randn((B_MAIN, cfg.n_nodes + 1, 1), generator=gen, device=dev) / 30.0
    apply_row("readout_apply", x16, w16, paths["streaming"]["readout_launches_bf16"],
              "bf16 streamed evaluation, one launch an eval chunk")
    xs = scan_ops.dfr_scan(serve["model"], serve["j"][:, :SERVE_CHUNK].contiguous(),
                           serve["mask"], torch.zeros((SERVE_B, SERVE_N), device=dev))
    ws = torch.randn((SERVE_B, SERVE_N + 1, 1), generator=gen, device=dev) / 8.0
    apply_row("readout_apply_serving", xs, ws, serve["launches"]["readout_apply"],
              f"serving, B = {SERVE_B}: one launch a tick ({ticks} ticks)")
    rows[-1]["launches_per_tick"] = rows[-1]["launches"] / ticks
    del x16, w16, xs, ws
    # the block-copy fixture (the subject of the contract checker's
    # SmemBudget) at the contracts phase's in-budget tile: bitwise its plain
    # version, timed beside x.clone(); every byte is read once and written once
    xc = torch.randn(COPY_SHAPE, device=dev)
    out = copy_ops.block_copy(xc, COPY_TILE)
    copy_route = copy_ops.block_copy.last_route
    ref = copy_ops.block_copy_plain(xc, COPY_TILE)
    check(torch.equal(out, ref) and torch.equal(out, xc), "block_copy: not bitwise its plain version")
    check(copy_route == "tma", f"block_copy took the {copy_route} route at the fixture's tile")
    bound, by = bound_ms(2 * xc.numel() * xc.element_size(), 0)
    rows.append({"name": "block_copy", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/block_copy.cu",
                 "replaces": "tests/test_analysis.py:251",
                 "launches": paths["contracts"]["block_copy_launches"],
                 "path": "contracts: the SmemBudget fixture at an in-budget tile",
                 "copy_route": copy_route,
                 "tma_box": list(copy_ops.copy_route(COPY_SHAPE, xc.dtype, COPY_TILE,
                                                     xc.data_ptr())["box"]),
                 "max_abs_err": max_err(out, ref), "bitwise_vs_plain": True,
                 **times(lambda: copy_ops.block_copy(xc, COPY_TILE), 20, bound,
                         lambda: xc.clone()),
                 "plain_ms": plain_time(lambda: copy_ops.block_copy_plain(xc, COPY_TILE), 5),
                 "bound_ms": bound, "bound_by": by, "library_call": "x.clone()",
                 "shape": list(COPY_SHAPE), "tile": list(COPY_TILE),
                 "smem_bytes": copy_ops.copy_plan(COPY_SHAPE, xc.dtype, COPY_TILE)["smem_bytes"]})
    del xc, out, ref
    for row in rows:
        if row["name"].startswith("ridge_gram"):
            check(max(row["error_vs_f32_sum_bound"].values()) <= 1.0,
                  f"{row['name']} outside the f32 sum's error bound")
        # with L2 flushed before each call no kernel can beat its HBM bound
        check(row["bound_share"] <= 1.0,
              f"{row['name']}: bound share {row['bound_share']} of its cold time above 1")
    emit({"kernels": rows})
    g_serve = serve["g"]
    eighs = [{"shape": [bb, f, f], "path": "NARMA10 readout", "ms": eigh_ms}]
    for b_e in (SERVE_B, SERVE_B_SMALL):
        g_e = g_serve[:b_e].contiguous()
        # warm: the serving drains ran this shape's eigh on every refresh
        eighs.append({"shape": list(g_e.shape), "path": f"serving refresh tick, B = {b_e}",
                      "ms": cuda_ms(lambda: torch.linalg.eigh(g_e), reps=1, warmup=0)})
    emit({"phase": "library", "call": "torch.linalg.eigh", "timings": eighs})
    # the SVD readout that ExperimentConfig.from_dfrc gives the Fig. 5/6
    # cells, at its widest feature stacks (torch's default cuSOLVER method)
    svds = [{"shape": list(x.shape), "path": path,
             "ms": cuda_ms(lambda: torch.linalg.svd(x, full_matrices=False), reps=1)}
            for path, x in svd_x.items()]
    emit({"phase": "library", "call": "torch.linalg.svd", "timings": svds})
    emit({"phase": "library", "call": "torch.linalg.svd(driver=...)",
          "timings": svd_driver_timings(svd_x)})


def svd_driver_timings(stacks: dict) -> list[dict]:
    """Each cuSOLVER driver of ``torch.linalg.svd`` on each feature stack
    [B, T, F] (the default driver warmed by the "library" line before):
    the time of one call, the largest gap of its singular values to the
    default driver's over the largest singular value, and its
    reconstruction error ‖U·S·Vᵀ − X‖ / ‖X‖; a driver that fails to
    converge is recorded with its error.  Not used by the port: the
    readout's accuracy under another driver is not measured here."""
    import torch

    out = []
    for path, x in stacks.items():
        s_ref = None
        for driver in (None, "gesvd", "gesvdj", "gesvda"):
            row = {"shape": list(x.shape), "path": path, "driver": driver or "default"}
            out.append(row)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            try:
                u, s, vt = torch.linalg.svd(x, full_matrices=False, driver=driver)
            except torch.linalg.LinAlgError as err:
                row.update(ms=None, error=str(err))
                continue
            end.record()
            end.synchronize()
            if s_ref is None:
                s_ref = s
            row.update(ms=start.elapsed_time(end),
                       recon_rel_err=float(torch.linalg.norm(u * s[..., None, :] @ vt - x)
                                           / torch.linalg.norm(x)),
                       s_gap_to_default_over_s1=float(
                           ((s - s_ref).abs().amax(-1) / s_ref[..., 0]).max()))
            del u, s, vt
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.core import tasks
    except ImportError as err:
        print(f"chip_smoke: the port's package is not beside this script ({err})",
              file=sys.stderr)
        return 2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build(card)
    # the kernel checks, the device map and the contracts time no kernel, and
    # are host-bound: they run side by side in three processes, joined
    # before the first timed phase
    sides = [start_side("phase_device_sweep", card), start_side("phase_side_checks", card)]
    phase_scan_edge_grid(dev)
    _, contracts = join_sides(sides)
    narma, chan = main_inputs(tasks, B_MAIN)
    main = phase_main_path(dev, narma, chan, card)
    phase_stages(dev, narma, main["exp"], card)
    phase_parity(dev, tasks)
    streaming = phase_streaming(dev, narma, card)
    phase_long_stream(dev, tasks, card)
    wdm = phase_wdm(dev, tasks, card)
    phase_session_parity(dev, card)
    phase_session_plain(dev, card)
    serving = phase_serving(dev, card)
    phase_kill_restore(dev, card)
    phase_soak(dev, card)
    accelerator = phase_accelerator(dev, tasks, card)
    cmt = phase_cmt_main(dev, narma, card)
    phase_cmt_calibration(dev, narma, card)
    phase_fast_path(dev, card)
    figures = phase_paper_figures(dev, tasks, card)
    composed = phase_composed(dev, tasks, card)
    lm = phase_lm_serving(dev, card)
    lm_training = phase_lm_training(dev, card)
    parallel = phase_parallel(dev, narma, wdm["chans"], card)
    phase_parallel_serving(dev, card)
    phase_kernels_line(dev, narma, {"main": main, "streaming": streaming, "wdm": wdm,
                                    "serving": serving, "cmt": cmt,
                                    "accelerator": accelerator, "figures": figures,
                                    "composed": composed, "contracts": contracts, "lm": lm,
                                    "lm_training": lm_training, "parallel": parallel})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
