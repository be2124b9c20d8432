"""Training-time model (paper Section V.D, Fig. 7).

Port of ``repro/core/timing.py``: pure Python, the same floats.  The port
keeps its own copy so that it never imports the reference package.

Training time = state-collection time + readout-solve time.

* State collection is physical: each of the T_train input samples occupies one
  feedback-loop period τ, so  T_collect = n_train · τ.
    - 'Silicon MR':      τ = N·θ with θ = 50 ps (on-chip waveguide; 45 ns at
      the paper's NARMA10 point N = 900).
    - 'All Optical (MZI)': τ = 7.56 µs (1.7 km fibre spool [20]).
    - 'Electronic (MG)':  τ = 10 ms (analog Mackey-Glass board [19]).
* The readout solve is host-side linear algebra, identical for all three
  accelerators: pseudo-inverse of the T×(N+1) state matrix,
  flops ≈ 2·T·(N+1)² + 11·(N+1)³ (Golub–Van Loan SVD count), at a host rate
  (default 10 GFLOP/s, a 2021-era workstation).

The paper reports 98× (vs electronic) and 93× (vs photonic) average speedups;
those averages depend on unstated solve-time constants, so the benchmark
(benchmarks/fig7_training_time.py) reports our per-task model outputs next to
the paper's claims rather than asserting equality (DESIGN.md §7).
"""

from __future__ import annotations

import dataclasses

THETA_MR_S = 50e-12
TAU_MZI_S = 7.56e-6
TAU_MG_S = 10e-3


@dataclasses.dataclass(frozen=True)
class TimingModel:
    name: str
    tau_s_fn: str  # "mr" (N-dependent) | fixed float encoded below
    tau_fixed_s: float = 0.0
    host_gflops: float = 10.0

    def tau_s(self, n_nodes: int) -> float:
        if self.tau_s_fn == "mr":
            return n_nodes * THETA_MR_S
        return self.tau_fixed_s

    def collection_time_s(self, n_train: int, n_nodes: int) -> float:
        return n_train * self.tau_s(n_nodes)

    def solve_time_s(self, n_train: int, n_nodes: int) -> float:
        n = n_nodes + 1
        flops = 2.0 * n_train * n**2 + 11.0 * n**3
        return flops / (self.host_gflops * 1e9)

    def training_time_s(self, n_train: int, n_nodes: int) -> float:
        return self.collection_time_s(n_train, n_nodes) + self.solve_time_s(n_train, n_nodes)


TIMING_SILICON_MR = TimingModel(name="Silicon MR", tau_s_fn="mr")
TIMING_MZI = TimingModel(name="All Optical (MZI)", tau_s_fn="fixed", tau_fixed_s=TAU_MZI_S)
TIMING_MG = TimingModel(name="Electronic (MG)", tau_s_fn="fixed", tau_fixed_s=TAU_MG_S)
