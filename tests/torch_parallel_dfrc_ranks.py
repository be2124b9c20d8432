"""The rank side of tests/test_torch_parallel_dfrc.py: the DFRC pipeline's
cases and a rank that runs them under a mesh, in a module that imports
torch and the port only, so each spawned rank starts without the JAX
package.  The test's own process runs the same cases without a mesh, and
their JAX counterparts, from the same ``SPECS``."""

import numpy as np
import torch

from repro_torch.core import ReservoirStage, SiliconMR, chain, tasks
from repro_torch.devices import CMTSweepParams, SweepGrid, calibrated_twin, run_device_sweep
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding
from repro_torch.pipeline import Experiment, ExperimentConfig, WDMExperiment

N = 16
CHUNK = 64
LAMS = (1e-8, 1e-6, 1e-4)
SWEEP_AXES = dict(detune=(-0.5, 0.5), loss_scale=(1.0,), power=(0.0, 1.0))
SWEEP_KW = dict(n_nodes=N, washout=20, stream_chunk_k=32, ridge_l2=(1e-6, 1e-4))
SWEEP_SAMPLES = 300
LANES = dict(detune=(0.0, 0.75, -0.5, 0.25), loss_scale=(1.0, 1.25, 1.1, 1.0),
             power=(1.0, 0.5, 0.0, 0.75))

# Each case: what runs ("wdm", "shared", "experiment" or "sweep"), its
# ExperimentConfig fields past the model, its model ("mr" or the CMT
# cavity "cmt"), its topology ("graph", a depth-2 chain with a two-loop
# first stage, width 2·12 + 7 = 31), its channels, its NARMA10 (instances,
# length, first seed; the shared readout's one stream repeated on every
# channel), and for "experiment" whether it sweeps ``LANES``.
_FIT = dict(n_nodes=N, washout=40, state_noise_rel=0.0)
_STREAM = dict(stream_chunk_k=CHUNK, state_method="kernel", readout_use_kernel=True)
SPECS = {
    "wdm_materialized": dict(kind="wdm", cfg=dict(_FIT, ridge_l2=(1e-4,)),
                             r=4, data=(4, 400, 0)),
    "wdm_materialized_noise": dict(kind="wdm", cfg=dict(_FIT, ridge_l2=(1e-4,),
                                                        state_noise_rel=0.003),
                                   r=4, data=(4, 400, 0)),
    "wdm_streamed": dict(kind="wdm", cfg=dict(_FIT, ridge_l2=LAMS, state_noise_rel=0.003,
                                              state_noise_mode="diagonal", **_STREAM),
                         r=4, data=(4, 400, 0)),
    "wdm_shared": dict(kind="shared", cfg=dict(_FIT, washout=24, ridge_l2=(1e-4,), **_STREAM),
                       r=4, data=(1, 560, 3)),
    "wdm_shared_r3": dict(kind="shared", cfg=dict(_FIT, washout=24, ridge_l2=(1e-4,),
                                                  **_STREAM),
                          r=3, data=(1, 560, 3)),
    "composed": dict(kind="experiment", topology="graph",
                     cfg=dict(_FIT, washout=10, ridge_l2=(1e-4,), **_STREAM),
                     data=(4, 420, 0)),
    "composed_wdm": dict(kind="wdm", topology="graph",
                         cfg=dict(_FIT, washout=10, ridge_l2=(1e-6, 1e-4),
                                  stream_chunk_k=CHUNK),
                         r=4, data=(4, 420, 4)),
    "dev_params_materialized": dict(kind="experiment", model="cmt", lanes=True,
                                    cfg=dict(_FIT, washout=20, ridge_l2=(1e-4, 1e-2)),
                                    data=(4, 400, 1)),
    "dev_params_streamed": dict(kind="experiment", model="cmt", lanes=True,
                                cfg=dict(_FIT, washout=20, ridge_l2=(1e-4, 1e-2),
                                         stream_chunk_k=16),
                                data=(4, 400, 1)),
    "device_sweep": dict(kind="sweep"),
}


def narma_batch(b, length, seed0):
    """[b, T] NARMA10 splits (numpy), seeds seed0..seed0 + b - 1."""
    ds = [tasks.narma10(length, seed=seed0 + s) for s in range(b)]
    return tuple(np.stack([getattr(d, f) for d in ds])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


def case_inputs(name):
    """The numpy arguments of a case's ``run``: [R, T] drives and [R, T]
    targets, or for the shared readout [R, T] drives and one [T] target."""
    spec = SPECS[name]
    tr, y_tr, te, y_te = narma_batch(*spec["data"])
    if spec["kind"] == "shared":
        r = spec["r"]
        return np.repeat(tr, r, axis=0), y_tr[0], np.repeat(te, r, axis=0), y_te[0]
    return tr, y_tr, te, y_te


def graph():
    return chain(ReservoirStage(model=SiliconMR(), n_nodes=12, loops=2, mask_seed=3),
                 ReservoirStage(model=SiliconMR(), n_nodes=7, mask_seed=11, link="sin2"))


def run_case(name):
    """The case on the CPU (under whatever mesh is active): a dict of its
    numpy results."""
    spec = SPECS[name]
    if spec["kind"] == "sweep":
        res = run_device_sweep(calibrated_twin(SiliconMR()), SweepGrid(**SWEEP_AXES),
                               tasks.narma10(SWEEP_SAMPLES, seed=0), device="cpu", **SWEEP_KW)
        return {"nrmse": res.nrmse, "ser": res.ser, "lam": res.lam}
    model = calibrated_twin(SiliconMR(), power_mw=1.0) if spec.get("model") == "cmt" else \
        SiliconMR()
    cfg = ExperimentConfig(model=model, topology=graph() if spec.get("topology") else None,
                           **spec["cfg"])
    args = case_inputs(name)
    if spec["kind"] == "experiment":
        lanes = (CMTSweepParams(**{k: torch.tensor(v) for k, v in LANES.items()})
                 if spec.get("lanes") else None)
        res = Experiment(cfg, device="cpu").run(*args, dev_params=lanes)
    else:
        res = WDMExperiment(cfg, spec["r"], shared_readout=spec["kind"] == "shared",
                            device="cpu").run(*args)
    return {"nrmse": res.nrmse, "ser": res.ser, "lam": res.lam, "readout_w": res.readout_w,
            "y_pred": res.y_pred}


def dfrc_rank(rank, shape, names):
    """Each case of ``names`` on this rank of a ("data", "model") mesh of
    ``shape``: its results and the collectives it recorded."""
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    out = {}
    for name in names:
        with sharding.use_mesh(mesh), sharding.record_collectives() as events:
            res = run_case(name)
        out[name] = {**res, "events": [dict(e) for e in events]}
    return out
