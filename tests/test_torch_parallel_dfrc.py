"""The DFRC pipeline's WDM ensembles, shared readout, composed graphs and
``dev_params`` sweeps under a mesh, on gloo ranks on the CPU, against the
port's own one-process run and the JAX package's unsharded run.

One spawn a mesh (``torch_parallel_dfrc_ranks.dfrc_rank``) runs every case
of ``SPECS`` on (2, 1), and the shared readout on (2, 2), where a "model"
axis replicates the work; the one-process runs and the JAX package's run
in a worker thread meanwhile.  What each case holds:

* the mesh run is bitwise the port's one-process run on every rank
  (``nrmse``, ``ser``, ``lam``, ``readout_w``, ``y_pred``): each instance
  runs the same arithmetic on its rank, the sampled noise is drawn at the
  whole batch's shape and cut, and the shared readout folds and solves the
  same gathered features;
* the mesh run is within the tolerance of that path's one-process parity
  test of the JAX package's unsharded run on the same numpy inputs:
  NRMSE within 1e-3 and the same λ (tests/test_torch_wdm.py,
  tests/test_torch_composed.py, tests/test_torch_devices.py; the
  composed WDM, shared and ``dev_params`` cases there compare the NRMSE
  only), and the device map the reference's stable map at 0.8, every cell
  finite.  The sampled-noise case has no JAX counterpart: the port's
  ``torch.Generator`` cannot draw ``jax.random``'s bits;
* the recorded collectives are exact: a per-instance path does one
  all-gather over "data", of its results packed a row an instance, and
  nothing else; the shared readout one all-gather over "data" of a
  chunk's [1, chunk, R·N] features a chunk, in the fit and in the
  evaluation, and nothing else; three channels, which two data ranks do
  not divide, stay whole on every rank and move nothing.
"""

import concurrent.futures
import functools
import math
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_dfrc_ranks import (CHUNK, LANES, N, SPECS, SWEEP_AXES, SWEEP_KW,
                                       SWEEP_SAMPLES, case_inputs, dfrc_rank, run_case)

from repro.core import ReservoirStage as JStage
from repro.core import SiliconMR as JMR
from repro.core import chain as jchain
from repro.core import tasks as jtasks
from repro.devices import CMTSweepParams as JParams
from repro.devices import SweepGrid as JSweepGrid
from repro.devices import calibrated_twin as jcalibrated_twin
from repro.devices import run_device_sweep as jrun_device_sweep
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro.pipeline import WDMExperiment as JWDMExperiment
from repro_torch.core import ReservoirStage, SiliconMR, chain
from repro_torch.devices import CMTSweepParams, calibrated_twin
from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel import sharding
from repro_torch.pipeline import Experiment, ExperimentConfig
from repro_torch.pipeline.experiment import _gen_states

MESHES = {(2, 1): tuple(SPECS), (2, 2): ("wdm_shared",)}
NRMSE_TOL = 1e-3
SWEEP_STABLE = 0.8
NO_REFERENCE = ("wdm_materialized_noise",)
SAME_LAM = ("wdm_materialized", "wdm_streamed", "composed")
RESULTS = ("nrmse", "ser", "lam", "readout_w", "y_pred")


def _reference(name):
    """The JAX package's unsharded run of a case: its NRMSE and λ, or the
    device map's."""
    spec = SPECS[name]
    if spec["kind"] == "sweep":
        res = jrun_device_sweep(jcalibrated_twin(JMR()), JSweepGrid(**SWEEP_AXES),
                                jtasks.narma10(SWEEP_SAMPLES, seed=0), **SWEEP_KW)
        return {"nrmse": np.asarray(res.nrmse),
                "map": res.stable_region(nrmse_max=SWEEP_STABLE)["map"]}
    cfg = {**spec["cfg"], "state_method": "fast", "readout_use_kernel": False}
    model = jcalibrated_twin(JMR(), power_mw=1.0) if spec.get("model") == "cmt" else JMR()
    topology = (jchain(JStage(model=JMR(), n_nodes=12, loops=2, mask_seed=3),
                       JStage(model=JMR(), n_nodes=7, mask_seed=11, link="sin2"))
                if spec.get("topology") else None)
    jcfg = JConfig(model=model, topology=topology, **cfg)
    args = case_inputs(name)
    if spec["kind"] == "experiment":
        lanes = (JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in LANES.items()})
                 if spec.get("lanes") else None)
        res = JExperiment(jcfg).run(*args, dev_params=lanes)
    else:
        res = JWDMExperiment(jcfg, spec["r"], shared_readout=spec["kind"] == "shared").run(*args)
    return {"nrmse": np.asarray(res.nrmse), "lam": np.asarray(res.lam)}


@functools.cache
def _pool():
    return concurrent.futures.ThreadPoolExecutor(max_workers=1)


@functools.cache
def _side_runs():
    """The one-process runs and the references, in a worker thread."""
    def run():
        return ({name: run_case(name) for name in SPECS},
                {name: _reference(name) for name in SPECS if name not in NO_REFERENCE})

    return _pool().submit(run)


@functools.cache
def _ranks(shape):
    """Each case's result on every rank of ``shape``."""
    _side_runs()
    with tempfile.TemporaryDirectory() as store:
        ranks = run_ranks(dfrc_rank, math.prod(shape), store_dir=store,
                          args=(shape, MESHES[shape]), timeout=300)
    return {name: [r[name] for r in ranks] for name in MESHES[shape]}


def _one(name):
    return _side_runs().result()[0][name]


CASES = [(shape, name) for shape, names in MESHES.items() for name in names]
IDS = [f"{name}-{shape[0]}x{shape[1]}" for shape, name in CASES]


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_mesh_run_is_the_one_process_run_bitwise(shape, name):
    one = _one(name)
    for rank, got in enumerate(_ranks(shape)[name]):
        for k in RESULTS:
            if k in one:
                np.testing.assert_array_equal(got[k], one[k], err_msg=f"{name} rank {rank} {k}")


@pytest.mark.parametrize("name", [n for n in SPECS if n not in NO_REFERENCE])
def test_mesh_run_matches_the_reference(name):
    want = _side_runs().result()[1][name]
    for rank, got in enumerate(_ranks((2, 1))[name]):
        if SPECS[name]["kind"] == "sweep":
            assert np.all(np.isfinite(got["nrmse"]))
            stable = got["nrmse"] <= SWEEP_STABLE
            np.testing.assert_array_equal(stable, want["map"])
            np.testing.assert_allclose(got["nrmse"][stable], want["nrmse"][stable],
                                       atol=NRMSE_TOL, rtol=0)
            continue
        np.testing.assert_allclose(got["nrmse"], want["nrmse"], atol=NRMSE_TOL, rtol=0,
                                   err_msg=f"{name} rank {rank}")
        if name in SAME_LAM:
            np.testing.assert_array_equal(got["lam"], want["lam"])


def _result_bytes(name):
    """The f32 bytes of a per-instance case's whole results, as gathered
    (the device map's readouts ride the gather, though its result drops
    them)."""
    one = _one(name)
    if SPECS[name]["kind"] == "sweep":
        lanes = math.prod(one["nrmse"].shape)
        return 4 * lanes * (3 + SWEEP_KW["n_nodes"] + 1)
    return 4 * sum(np.size(one[k]) for k in RESULTS if one[k] is not None)


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_recorded_collectives_are_exact(shape, name):
    spec = SPECS[name]
    if spec["kind"] != "shared":
        want = [{"kind": "all-gather", "bytes": _result_bytes(name), "group": 2,
                 "axis": "data"}]
    elif spec["r"] % shape[0]:
        want = []
    else:
        k_tr, k_te = (a.shape[1] for a in case_inputs(name)[::2])
        want = [{"kind": "all-gather", "bytes": 4 * CHUNK * spec["r"] * N, "group": 2,
                 "axis": "data"}] * (-(-k_tr // CHUNK) + -(-k_te // CHUNK))
    for got in _ranks(shape)[name]:
        assert got["events"] == want


def test_reference_refusals_stay_under_a_mesh():
    """The reference's own checks raise under a mesh as without one:
    ``dev_params`` on the kernel state path and with a composed topology
    (ValueError), and with the WDM workload (NotImplementedError)."""
    args = tuple(a[:1] for a in case_inputs("dev_params_materialized"))
    lanes = CMTSweepParams(detune=0.0, loss_scale=1.0, power=0.0)
    base = dict(model=calibrated_twin(SiliconMR(), power_mw=1.0), n_nodes=N, washout=20,
                state_noise_rel=0.0)
    topology = chain(ReservoirStage(model=SiliconMR(), n_nodes=N, mask_seed=3))
    with sharding.use_mesh(sharding.AbstractMesh((2, 1), ("data", "model"))):
        with pytest.raises(ValueError, match="kernel"):
            Experiment(ExperimentConfig(state_method="kernel", **base), device="cpu").run(
                *args, dev_params=lanes)
        with pytest.raises(ValueError, match="topology"):
            Experiment(ExperimentConfig(topology=topology, stream_chunk_k=16, **base),
                       device="cpu").run(*args, dev_params=lanes)
        with pytest.raises(NotImplementedError, match="WDM"):
            _gen_states(ExperimentConfig(**base), torch.zeros((2, N)), torch.zeros((2, 5)),
                        wdm=True, dev_params=lanes)
