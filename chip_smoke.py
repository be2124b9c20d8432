#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build — the card's name and power limit (nvidia-smi), TF32
   off, the four CUDA sources built with nvcc (in parallel) from
   ``src/repro_torch/kernels/csrc``;
2. kernels vs their plain PyTorch versions on the card — the scan kernel
   for the five device models (f32 and bf16 states, per-lane masks,
   bitwise chunk resume; the CMT cavity at K = 8), then on the edge grid of
   its block layout (N ∈
   {1, 31, 32, 33, 100, 900, the largest N} × B ∈ {1, 33, 64, 65}, K = 1,
   2, 37 in turn (1, 2 above N = 100), both mask modes, every model (the
   CMT cavity up to N = 100, then N = 900 and the largest N at K = 1):
   SiliconMR exact, bf16 states the f32 states rounded, resume at an uneven
   split bitwise;
   MZISine above the chain kernel's node limit, which SiliconMR raises at); the
   Gram kernel on the edges of its triangle
   grid (F at the 64-wide tile's edges and 901, C = 1 and 128, a ragged
   T, f32 and bf16 X, both thread layouts), G symmetric bitwise, a
   non-symmetric G0 through accumulate-into, and accumulate-into over an
   uneven split == one-shot bitwise;
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
   chunk resumed from a carry and on a split from zero, exact), the
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
   chain bound, MZISine, which has no node chain, with its byte bound), K1
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
   within 2e-2 there; wall time and peak memory;
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

21. ``contracts`` — the 19 registered entry points, each run once on the
   card through K1-K3 under its rules (no state tensor, kernel calls per
   chunk, no float64, no silent bf16 upcast, no host sync but the named
   sites, the slab and the Gram folded in place, each call's shared memory
   and row alignment), with each kernel launched once a call, a run under
   ``set_sync_debug_mode("error")`` where an entry allows no sync site,
   and the peak device memory; the seeded violation caught; the
   block-copy fixture under ``SmemBudget`` (in budget it launches, the
   whole-array tile is flagged and refused); a K = 20000 streamed fit at
   N = 900 under a quarter of one [B, K, N] f32 state tensor.  The
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
   against the dense one at Skv 4096.  The kernels line then adds K1 at
   the LM's prefill and decode shapes, and the readout-apply kernel at the
   streamed evaluation's bf16 chunk [64, 256, 900] and the session tick's
   [4096, 32, 64] (within 1e-6 of its plain version, relative to the sum's
   magnitude, bitwise from call to call, beside ``torch.baddbmm``).

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
# mul, and the chain's mul and add; of one MZISine step: u, beta·u,
# alpha·s, two adds, sinf, the square
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


_T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T_START}
    print(json.dumps(obj), flush=True)


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
    MackeyGlass's chain step (its mul and add); ``least_step`` is CHAIN_OPS
    of ``f32_op``."""
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
    heads[3] = heads[0]
    consts = {0: [0.632], 1: [0.632], 2: list(cmt_model().kernel_spec()[1]),
              3: list(MackeyGlass().kernel_spec()[1])}
    last = torch.empty(1, dtype=torch.float32, device=dev)
    cyc = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    for form, name in ((0, "kernel_step"), (1, "f32_op"), (2, "cmt_step"), (3, "mg_step")):
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def reset_counts() -> None:
    """Set every kernel wrapper's launch and call counts to 0."""
    from repro_torch.kernels.block_copy import ops as copy_ops
    from repro_torch.kernels.dfr_scan import ops as scan_ops
    from repro_torch.kernels.readout_apply import ops as apply_ops
    from repro_torch.kernels.ridge_gram import ops as gram_ops

    for wrapper in (scan_ops.dfr_scan, gram_ops.gram_accumulate_batched,
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
    "final_norm"}) as numpy f32 arrays drawn at ``seed``: a matrix leaf
    normal times 1/sqrt(its fan-in), a vector leaf normal times 0.1.  No
    leaf is zero, the reservoir readout and the norm scales included (they
    initialise at zero), so a broken mixer or norm shows in the logits."""
    import math

    import numpy as np

    from repro_torch.models import layers
    from repro_torch.models.model import _block_defs

    rng = np.random.default_rng(seed)

    def draw(defs, lead=()):
        out = {}
        for name, (shape, _axes, _init) in sorted(defs.items()):
            scale = 1.0 / math.sqrt(shape[0]) if len(shape) >= 2 else 0.1
            out[name] = rng.standard_normal((*lead, *shape), dtype=np.float32) * np.float32(scale)
        return out

    return {"embed": draw(layers.embed_defs(cfg)),
            "units": tuple(draw(_block_defs(cfg, blk), (cfg.n_units,)) for blk in cfg.unit),
            "final_norm": draw(layers.norm_defs(cfg))}


def lm_tokens(cfg, shape, seed: int):
    """Token ids of ``shape`` drawn with numpy at ``seed``."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


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
    bitwise; one launch a call.  Returns the error vs the plain version."""
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
    if k > 1:
        cut = k // 3 + 1
        st1, f1 = ops.dfr_scan(model, j[:, :cut], mask, s0, return_final=True)
        st2, f2 = ops.dfr_scan(model, j[:, cut:], mask, f1, return_final=True)
        check(torch.equal(torch.cat([st1, st2], dim=1), out) and torch.equal(f2, fin),
              f"{what}: chunk resume at {cut} is not bitwise")
    return err / scale


def phase_scan_checks(dev) -> None:
    """The scan kernel vs its plain version for every form it inlines: at
    the main width (B = 64, N = 900, K = 32; the CMT form K = CMT_CHECK_K)
    with per-lane masks and bf16 states, then on the edge grid of its block
    layout (``scan_edge_cases``: N at the float4 group's and the warp's
    edges, the largest N, B at the 8-lane block's edges, K = 1, 2, 37 in
    turn; fewer for the CMT form), in both mask modes."""
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
    emit({"phase": "kernel_checks", "kernel": "dfr_scan", "edge_grid": {
              "N": [*SCAN_EDGE_N, "max"], "max_nodes": {"broadcast": ops.max_nodes(False),
                                                        "per_lane": ops.max_nodes(True)},
              "B": SCAN_EDGE_B, "K": SCAN_EDGE_K, "cases": cases,
              "max_err_vs_plain_by_form": grid, "mzi_above_node_limit": above,
              "bf16_is_f32_rounded_bitwise": True,
              "resume_bitwise": True, "seconds": time.perf_counter() - t0}})


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


def profile_calls(fn, n_calls: int, what: str = "calls") -> dict:
    """Device busy time of ``n_calls`` calls of ``fn`` (torch.profiler: the
    union of the kernel and copy intervals on the card) against their host
    wall time, and the kernels by device time; the error if the profiler
    fails here."""
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
        return {what: n_calls, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / 1e3 / wall_ms, "device_events": len(spans),
                "top_device_ms": top}
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


def phase_device_sweep(dev, tasks, card: str) -> None:
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

    from repro_torch.core import generate_states, make_mask
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
CONTRACT_ENTRIES = 19
COPY_SHAPE = (2048, 1024)
COPY_TILE = (32, 256)
CONTRACT_LONG_K = 20000


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
    """Route the LM's reservoir mixer through the scan kernel's plain
    version (on the card's tensors) for the body of the ``with``."""
    from repro_torch.core import layer as mixer

    scan = mixer.dfr_scan
    mixer.dfr_scan = scan_plain
    try:
        yield
    finally:
        mixer.dfr_scan = scan


def profile_decode(cfg, params, served: dict, n_steps: int = LM_PROFILE_STEPS) -> dict:
    """``profile_calls`` over ``n_steps`` more decode steps (the launcher's
    ``decode``) from a served batch's cache (served with that much slack)."""
    from repro_torch.launch import serve

    more = {"ids": [served["ids"][:, -1:]], "logits": [], "cache": served["cache"],
            "decode_step_s": []}
    return profile_calls(lambda: serve.decode(cfg, params, more), n_steps, "decode_steps")


def decode_vs_forward(cfg, params, prompts, served: dict) -> dict:
    """The served logits (prefill's last position, then each decode step)
    against one ``forward`` over the prompt and the served ids: the largest
    gap, and whether it is within the reference's decode bound."""
    import torch

    from repro_torch.models import forward

    toks = torch.cat([prompts, served["ids"][:, :-1]], dim=1)
    full, _ = forward(cfg, params, toks)
    want = full[:, prompts.shape[1] - 1:].float()
    got = served["logits"].float()
    gap = (got - want).abs()
    return {"max_abs_gap": float(gap.max()), "max_abs_logit": float(want.abs().max()),
            "max_gap_over_bound": float((gap / (DECODE_ATOL + DECODE_RTOL * want.abs())).max()),
            "within_reference_bound": bool(torch.allclose(got, want, atol=DECODE_ATOL,
                                                          rtol=DECODE_RTOL))}


def serving_report(cfg, served: dict, b: int) -> dict:
    import numpy as np

    steps = np.asarray(served["decode_step_s"])
    return {"B": b, "prompt": LM_SERVE_PROMPT, "new_tokens": served["ids"].shape[1],
            "dtype": cfg.dtype, "prefill_ms": served["prefill_s"] * 1e3,
            "decode_ms_per_token_p50": float(np.percentile(steps, 50) * 1e3),
            "decode_ms_per_token_p90": float(np.percentile(steps, 90) * 1e3),
            "decode_tokens_per_s": b * len(steps) / float(steps.sum()),
            "prefill_tokens_per_s": b * LM_SERVE_PROMPT / served["prefill_s"]}


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
        attention against the dense one at Skv 4096, chunk 1024."""
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
    n_params = sum(v.numel() for part in (gparams["embed"], *gparams["units"],
                                          gparams["final_norm"]) for v in part.values())
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
    emit({"phase": "lm_serving", "card": card, **out, "seconds": time.perf_counter() - t0})
    return lm_drive


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
    launch it: on chunk 1 of the stream, resumed from the kernel's carry
    after chunk 0 (f32 states and carry; bf16 states the f32 states
    rounded, bitwise, and within half a bf16 ulp of the plain f32 state),
    and on a whole split from a zero state, as the materialized paths
    launch it (NARMA10 [64, 1000, 900], WDM [64, 10000, 100]), its first
    chunk (the plain loop over a whole split took ≈ 270 s of the run).
    ``plain_ms`` is the plain version's time on the chunk.  Beside its
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
        # chunk 1, resumed from the kernel's carry after chunk 0
        _, carry = scan_ops.dfr_scan(model, j[:, :chunk], mask, zero, return_final=True)
        j1 = j[:, chunk:2 * chunk].contiguous()
        out, fin = scan_ops.dfr_scan(model, j1, mask, carry, return_final=True)
        out16 = scan_ops.dfr_scan(model, j1, mask, carry, out_dtype=torch.bfloat16)
        (ref, ref_fin), plain_s = wall(lambda: scan_ops.dfr_scan_plain(model, j1, mask, carry))
        err = max(max_err(out, ref), max_err(fin, ref_fin))
        # rounding an f32 state to bf16 (8 significant bits) moves it by at most
        # 2^-8 of itself
        bf16_excess = float(((out16.float() - ref).abs() - ref.abs() * 2.0 ** -8).max())
        checks.append({"what": "chunk 1 from the carry of chunk 0",
                       "shape_bkn": [b, chunk, n], "max_abs_err": err,
                       "bf16_err_beyond_half_ulp": bf16_excess, "plain_s": plain_s})
        check(err == 0.0, f"{name} vs plain on a resumed chunk: {err}")
        check(bf16_excess <= 2e-6, f"{name} bf16 states vs plain: {bf16_excess} beyond half an ulp")
        check(torch.equal(out16, out.to(torch.bfloat16)),
              f"{name}: bf16 states are not the f32 states rounded")
        del out, out16, ref
        # the whole split from a zero state, as the materialized paths
        # launch it; its first chunk against the plain version
        out = scan_ops.dfr_scan(model, j, mask, zero)[:, :chunk]
        (ref, _), full_s = wall(lambda: scan_ops.dfr_scan_plain(model, j[:, :chunk].contiguous(),
                                                                 mask, zero))
        err_full = max_err(out, ref)
        checks.append({"what": "whole split from zero, its first chunk", "shape_bkn": [b, k, n],
                       "checked_k": chunk, "max_abs_err": err_full, "plain_s": full_s})
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
                     "plain_ms": plain_s * 1e3, "bound_ms": bound, "bound_by": by,
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
        bound."""
        b, k = j.shape
        n = mask.shape[-1]
        zero = torch.zeros((b, n), dtype=torch.float32, device=dev)
        jk = j[:, :check_k].contiguous()
        out = scan_ops.dfr_scan(model, jk, mask, zero)
        (ref, _), plain_s = wall(lambda: scan_ops.dfr_scan_plain(model, jk, mask, zero))
        err = max_err(out, ref)
        check(err <= tol, f"{name} vs plain on the first {check_k} periods: {err} > {tol}")
        bound, by = bound_ms(4 * (b * k + mask.numel() + 2 * b * n + b * k * n), ops * b * k * n)
        t = times(lambda: scan_ops.dfr_scan(model, j, mask, zero), 3, bound)
        ms = t["ms"]
        chain_bound = (None if step_cycles is None
                       else k * n * step_cycles / (clocks["max"] * 1e3))
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
                     "sm_clock_mhz": clocks,
                     "lanes_per_block": scan_ops.scan_layout(b, n, mask.ndim == 2).lanes,
                     "shape_bkn": [b, k, n]})

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
    # MackeyGlass (its chain bound from the MG chain step that chain_cycles
    # measures) and MZISine (no node chain: its byte bound)
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
    phase_scan_checks(dev)
    phase_gram_checks(dev)
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
    phase_device_sweep(dev, tasks, card)
    phase_fast_path(dev, card)
    figures = phase_paper_figures(dev, tasks, card)
    composed = phase_composed(dev, tasks, card)
    contracts = phase_contracts(dev, card)
    lm = phase_lm_serving(dev, card)
    phase_kernels_line(dev, narma, {"main": main, "streaming": streaming, "wdm": wdm,
                                    "serving": serving, "cmt": cmt,
                                    "accelerator": accelerator, "figures": figures,
                                    "composed": composed, "contracts": contracts, "lm": lm})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
