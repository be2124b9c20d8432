"""The paper's accelerator configs per benchmark task.

Port of the DFRC part of ``repro/configs/__init__.py``: ``dfrc_tasks()``
gives each task's operating point for the three accelerators the paper
compares (Fig. 5 and 6) as the port's ``DFRCConfig``.  The LM architecture
registry of the same reference module is not ported yet.
"""

from __future__ import annotations

from ..core import DFRCConfig, MackeyGlass, MZISine, SiliconMR


def dfrc_tasks() -> dict[str, dict[str, DFRCConfig]]:
    """Operating points per task: N per the paper's sensitivity analysis,
    washout 60 and the five-λ GCV grid everywhere; MackeyGlass takes ±1
    mask levels, channel equalisation quantizes to 4-PAM symbols."""

    def mk(model, n_nodes, **kw):
        lams = (1e-10, 1e-8, 1e-6, 1e-4, 1e-2)
        return DFRCConfig(model=model, n_nodes=n_nodes, washout=60, ridge_l2=lams, **kw)

    return {
        "narma10": {
            "Silicon MR": mk(SiliconMR(), 900),
            "All Optical (MZI)": mk(MZISine(), 400),
            "Electronic (MG)": mk(MackeyGlass(), 900, mask_levels=(-1.0, 1.0)),
        },
        "santa_fe": {
            "Silicon MR": mk(SiliconMR(), 40),
            "All Optical (MZI)": mk(MZISine(), 400),
            "Electronic (MG)": mk(MackeyGlass(), 400, mask_levels=(-1.0, 1.0)),
        },
        "channel_eq": {
            "Silicon MR": mk(SiliconMR(), 30, quantize=True),
            "All Optical (MZI)": mk(MZISine(), 400, quantize=True),
            "Electronic (MG)": mk(MackeyGlass(), 400, mask_levels=(-1.0, 1.0),
                                  quantize=True),
        },
    }


__all__ = ["dfrc_tasks"]
