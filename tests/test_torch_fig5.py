"""The Fig. 5 cells (NARMA10, Santa Fe × the three accelerators): the
JAX package's numbers chip_smoke.py holds the card to, recomputed here.

chip_smoke.py's ``paper_figures`` phase runs every Fig. 5/6 cell of
``dfrc_tasks()`` on the card over 64 task seeds and holds seeds 0..3 to
the JAX package run on the CPU as ``benchmarks/common.fit_and_eval`` runs
it (``ExperimentConfig.from_dfrc``: the ``fast`` path, the SVD readout):
noise off (values and λ picks, ``FIG_REF_OFF``), noise on (``FIG_REF_ON``)
and a float64 ridge at ``FIG_F64_LAM`` on the reference's states
(``FIG_REF_F64``).  Each test here recomputes one cell's constants to
1e-9; tests/test_torch_fig6.py does the Fig. 6 cells.  About 1–3 s a cell
on the JAX side.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dfrc_tasks as jdfrc_tasks
from repro.core import generate_states as jgenerate_states
from repro.core import make_mask as jmake_mask
from repro.core import sample_and_hold as jsample_and_hold
from repro.core import tasks as jtasks
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro_torch.core import tasks

ACCELERATORS = ("Silicon MR", "All Optical (MZI)", "Electronic (MG)")
FIG5_CELLS = [f"{task}/{acc}" for task in ("narma10", "santa_fe") for acc in ACCELERATORS]
SEEDS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch, and the BLAS that numpy and jaxlib's LAPACK call, on one
    thread in this module.  Its SVDs and float64 ridges are large CPU ops,
    and when several test workers run at once their OpenMP and OpenBLAS
    threads spin against each other's: on an 8-core CPU, six processes
    computing one cell's constants at once took 390 s each at the default
    thread counts, 9 s at one (one process alone: 6 s)."""
    import scipy.linalg  # noqa: F401  (loads the OpenBLAS of jaxlib's LAPACK)
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@functools.cache
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@functools.cache
def reference_batch(key: str):
    """Seeds 0..SEEDS-1 of one Fig. 5/6 dataset key, stacked [S, T], from
    the JAX package's generators."""
    task, _, snr = key.partition("@")
    make = {"narma10": lambda s: jtasks.narma10(2000, seed=s),
            "santa_fe": lambda s: jtasks.santa_fe(6000, seed=s),
            "channel_eq": lambda s: jtasks.channel_equalization(
                9000, snr_db=float(snr.removesuffix("dB")), seed=s)}[task]
    ds = [make(s) for s in range(SEEDS)]
    return tuple(np.stack([getattr(d, f) for d in ds])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


def reference_cell(cell: str, *, perturb: float = 0.0, noise_on: bool = True) -> dict:
    """The JAX package on one cell's first seeds: the noise-off metric and
    λ, the noise-on metric (unless ``noise_on`` is False), and the NRMSE of
    a float64 ridge at FIG_F64_LAM on its noise-off states.  ``perturb``
    moves each train input by up to that relative amount (seeded)."""
    cs = chip_smoke()
    key, acc = cell.split("/")
    task = key.split("@")[0]
    metric = "ser" if task == "channel_eq" else "nrmse"
    batch = list(reference_batch(key))
    if perturb:
        rng = np.random.default_rng(0)
        batch[0] = (batch[0] * (1 + rng.uniform(-perturb, perturb, batch[0].shape))
                    ).astype(np.float32)
    on = JConfig.from_dfrc(jdfrc_tasks()[task][acc])
    off = dataclasses.replace(on, state_noise_rel=0.0)
    res_off = JExperiment(off).run(*batch)
    tr, te = jnp.asarray(batch[0], jnp.float32), jnp.asarray(batch[2], jnp.float32)
    lo = jnp.min(tr, axis=1, keepdims=True)
    scale = 1.0 / (jnp.max(tr, axis=1, keepdims=True) - lo + 1e-12)
    mask = jmake_mask(off.n_nodes, levels=off.mask_levels, seed=off.mask_seed)
    st_tr, fin = jgenerate_states(off.model, jsample_and_hold((tr - lo) * scale * off.input_gain),
                                  mask, return_final=True)
    st_te = jgenerate_states(off.model, jsample_and_hold((te - lo) * scale * off.input_gain),
                             mask, s0=fin)
    f64 = cs.ridge64_nrmse(np.array(st_tr), batch[1], np.array(st_te), batch[3],
                           lam=cs.FIG_F64_LAM, washout=off.washout)
    out = {"off": [float(v) for v in getattr(res_off, metric)],
           "lam": [float(v) for v in res_off.lam], "f64": f64}
    if noise_on:
        out["on"] = [float(v) for v in getattr(JExperiment(on).run(*batch), metric)]
    return out


def assert_cell_constants(cell: str) -> None:
    cs = chip_smoke()
    got = reference_cell(cell)
    vals, lams = cs.FIG_REF_OFF[cell]
    assert got["off"] == pytest.approx(list(vals), abs=1e-9)
    assert got["lam"] == pytest.approx(list(lams), rel=1e-6)
    assert got["on"] == pytest.approx(list(cs.FIG_REF_ON[cell]), abs=1e-9)
    assert got["f64"] == pytest.approx(list(cs.FIG_REF_F64[cell]), abs=1e-9)


@pytest.mark.parametrize("cell", FIG5_CELLS)
def test_chip_smoke_fig5_constants_come_from_the_reference(cell):
    assert_cell_constants(cell)


def test_chip_smoke_cells_are_the_benchmarks():
    """The phase runs the cells of benchmarks/fig5_nrmse.py and fig6_ser.py,
    and every cell has its constants."""
    cs = chip_smoke()
    assert cs.FIG_SNRS == (12, 16, 20, 24, 28, 32)
    names = [c[0] for c in cs.fig_cells()]
    assert len(names) == 24 and names[:6] == FIG5_CELLS
    for table in (cs.FIG_REF_OFF, cs.FIG_REF_ON, cs.FIG_REF_F64):
        assert sorted(table) == sorted(names)


def test_narma10_mr_noise_off_is_round_off():
    """Why chip_smoke.py holds NARMA10 on Silicon MR, noise off, by the
    float64 ridge alone: there the reference's own SVD fit (λ = 1e-10 over
    940 rows for 901 features) moves by far more than FIG_NRMSE_TOL when
    its train inputs move by 2e-7 relative, while the float64 ridge at
    FIG_F64_LAM on its states moves by under 1e-5."""
    cs = chip_smoke()
    moved = reference_cell("narma10/Silicon MR", perturb=2e-7, noise_on=False)
    vals, _ = cs.FIG_REF_OFF["narma10/Silicon MR"]
    assert np.max(np.abs(np.asarray(moved["off"]) - vals)) > 100 * cs.FIG_NRMSE_TOL
    f64 = np.asarray(cs.FIG_REF_F64["narma10/Silicon MR"])
    assert np.max(np.abs(np.asarray(moved["f64"]) - f64)) < 1e-5
    assert cs.FIG_PIPELINE_EXEMPT == ("narma10/Silicon MR",)


def test_santa_fe_seeds_is_tasks_santa_fe_bitwise():
    """chip_smoke.py makes the 64 Santa Fe seeds in one batched host loop
    (``tasks.santa_fe_seeds``); at the figures' 6000 samples every seed's
    series equals the JAX package's ``santa_fe`` bitwise."""
    got = tasks.santa_fe_seeds(6000, range(SEEDS))
    for arr, want in zip(got, reference_batch("santa_fe")):
        np.testing.assert_array_equal(arr, want)


def test_figure_reductions_are_the_benchmarks():
    """The comparisons the phase prints are benchmarks/fig5_nrmse.py's
    (1 - MR/MZI, MR/MG) and fig6_ser.py's (1 - MR/MZI on the SNR-mean SER)."""
    cs = chip_smoke()
    vals = {name: 1.0 + 0.01 * i for i, (name, *_) in enumerate(cs.fig_cells())}
    red = cs.figure_reductions(vals, vals)["seed0"]
    assert red["mr_vs_mzi_reduction"]["narma10"] == pytest.approx(
        1 - vals["narma10/Silicon MR"] / vals["narma10/All Optical (MZI)"])
    mean = {acc: np.mean([vals[f"channel_eq@{s}dB/{acc}"] for s in cs.FIG_SNRS])
            for acc in ACCELERATORS}
    assert red["mr_vs_mzi_reduction"]["channel_eq"] == pytest.approx(
        1 - mean["Silicon MR"] / mean["All Optical (MZI)"])
    assert red["narma10_mr_vs_mg_ratio"] == pytest.approx(
        vals["narma10/Silicon MR"] / vals["narma10/Electronic (MG)"])
