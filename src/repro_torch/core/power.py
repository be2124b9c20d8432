"""Power-consumption model (paper Section V.E, Eq. (15), Table 1).

Port of ``repro/core/power.py``: pure Python, the same floats, kept as the
port's own copy.

    P_laser[dBm] = IL_dB + coupling_loss + splitter_loss + dynamic_range + S

The laser must deliver, at the photodetector, its sensitivity S plus every
dB of loss in the path plus the dynamic range used to encode the mask levels.
Electrical laser power divides the optical power by the wall-plug efficiency.
Per-device electrical terms (modulators, filters, amplifier, feedback PD) are
added on top.

The paper quotes totals of 126.48 mW ('Silicon MR') and 549.54 mW
('All Optical (MZI)').  Evaluating Eq. (15) literally with Table 1's numbers
reproduces the Silicon MR total to within a few percent, but overshoots the
MZI total unless the wall-plug division is skipped for the MZI laser; both
readings are reported by benchmarks/table1_power.py and the discrepancy is
noted in EXPERIMENTS.md.  The architectural claim — the MR's 6 dB vs the
MZI's 20 dB masking dynamic range dominating the budget — holds in every
reading.
"""

from __future__ import annotations

import dataclasses


def dbm_to_mw(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0)


@dataclasses.dataclass(frozen=True)
class PowerSpec:
    """Loss/power budget of one accelerator (one Table 1 column)."""

    name: str
    insertion_loss_db: float
    coupling_loss_db: float
    dynamic_range_db: float
    pd_sensitivity_dbm: float = -5.8      # 10 Gb/s receiver [37]
    splitter_loss_db: float = 0.0
    wall_plug_efficiency: float = 0.10    # [35]
    # electrical adders (mW at the operating rate)
    modulator_mw: float = 0.0
    filter_mw: float = 0.0
    amplifier_mw: float = 0.0
    feedback_pd_mw: float = 0.0

    def laser_optical_dbm(self) -> float:
        """Eq. (15)."""
        return (
            self.insertion_loss_db
            + self.coupling_loss_db
            + self.splitter_loss_db
            + self.dynamic_range_db
            + self.pd_sensitivity_dbm
        )

    def laser_optical_mw(self) -> float:
        return dbm_to_mw(self.laser_optical_dbm())

    def laser_electrical_mw(self, *, apply_wall_plug: bool = True) -> float:
        p = self.laser_optical_mw()
        return p / self.wall_plug_efficiency if apply_wall_plug else p

    def total_mw(self, *, apply_wall_plug: bool = True) -> float:
        return (
            self.laser_electrical_mw(apply_wall_plug=apply_wall_plug)
            + self.modulator_mw
            + self.filter_mw
            + self.amplifier_mw
            + self.feedback_pd_mw
        )

    def breakdown_mw(self, *, apply_wall_plug: bool = True) -> dict[str, float]:
        return {
            "laser": self.laser_electrical_mw(apply_wall_plug=apply_wall_plug),
            "modulator": self.modulator_mw,
            "filter": self.filter_mw,
            "amplifier": self.amplifier_mw,
            "feedback_pd": self.feedback_pd_mw,
            "total": self.total_mw(apply_wall_plug=apply_wall_plug),
        }


# Table 1 columns.  Rate-dependent device energies are evaluated at the
# 10 Gb/s output-sampling rate of the PD/receiver chain the paper cites [37]:
#   MR modulator 15 fJ/bit -> 0.15 mW;  MR filter 0.705 pJ/bit -> 7.05 mW.
SILICON_MR = PowerSpec(
    name="Silicon MR",
    insertion_loss_db=8.25,
    coupling_loss_db=2.0,
    splitter_loss_db=0.5,
    dynamic_range_db=6.0,
    modulator_mw=15e-15 * 10e9 * 1e3,
    filter_mw=0.705e-12 * 10e9 * 1e3,
)

ALL_OPTICAL_MZI = PowerSpec(
    name="All Optical (MZI)",
    insertion_loss_db=7.4,
    coupling_loss_db=3.3,
    splitter_loss_db=0.0,
    dynamic_range_db=20.0,
    modulator_mw=100.0,            # MZI modulator [20]
    amplifier_mw=dbm_to_mw(10.0),  # ZHL-32A listed at 10 dBm [20]
    feedback_pd_mw=1.2,            # TTI TIA525 [20]
)

PAPER_TOTALS_MW = {"Silicon MR": 126.48, "All Optical (MZI)": 549.54}
