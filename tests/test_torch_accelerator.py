"""Port parity: the host accelerator API and the paper's cost models
(repro_torch.core.{accelerator,timing,power}, ExperimentConfig.from_dfrc).

The same numpy inputs go through the JAX package and the port on the CPU
(the scan kernel's wrapper takes its plain version).

Tolerances:

* timing and power: the reference's floats, exactly (the same pure
  Python);
* ``DFRCAccelerator`` against the reference's, digitiser noise on (the
  default; both draw it with numpy from ``noise_seed``): NARMA10 NRMSE
  ≤1e-4 (the f32 states agree to ~1e-7 and scale the noise's σ), the
  readout weights ≤1e-3, channel-equalization SER equal;
* the pipeline against the host accelerator on the same task: ≤0.05
  NRMSE (the reference's own bound in tests/test_pipeline.py: another
  noise generator and an f32 vs an f64 solve);
* ``from_dfrc`` and ``dfrc_config_from_reference``: field for field.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DFRCAccelerator as JAccelerator
from repro.core import DFRCConfig as JDFRCConfig
from repro.core import MackeyGlass as JMackeyGlass
from repro.core import MZISine as JMZISine
from repro.core import SiliconMR as JMR
from repro.core import power as jpower
from repro.core import timing as jtiming
from repro.pipeline import ExperimentConfig as JExperimentConfig
from repro_torch.convert import config_from_reference, dfrc_config_from_reference
from repro_torch.core import (DFRCAccelerator, DFRCConfig, MackeyGlass, MZISine, SiliconMR,
                              power, tasks, timing)
from repro_torch.pipeline import Experiment, ExperimentConfig

LAMS = (1e-10, 1e-8, 1e-6, 1e-4, 1e-2)


def test_timing_models_equal_reference_floats():
    for name in ("TIMING_SILICON_MR", "TIMING_MZI", "TIMING_MG"):
        port, ref = getattr(timing, name), getattr(jtiming, name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for n_train in (1, 1000, 6000):
            for n_nodes in (30, 400, 900):
                for fn in ("tau_s", "collection_time_s", "solve_time_s", "training_time_s"):
                    args = (n_nodes,) if fn == "tau_s" else (n_train, n_nodes)
                    assert getattr(port, fn)(*args) == getattr(ref, fn)(*args), (name, fn)
    for const in ("THETA_MR_S", "TAU_MZI_S", "TAU_MG_S"):
        assert getattr(timing, const) == getattr(jtiming, const)


def test_power_specs_equal_reference_floats():
    for name in ("SILICON_MR", "ALL_OPTICAL_MZI"):
        port, ref = getattr(power, name), getattr(jpower, name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for wall_plug in (True, False):
            assert port.total_mw(apply_wall_plug=wall_plug) == \
                ref.total_mw(apply_wall_plug=wall_plug)
            assert port.breakdown_mw(apply_wall_plug=wall_plug) == \
                ref.breakdown_mw(apply_wall_plug=wall_plug)
        assert port.laser_optical_dbm() == ref.laser_optical_dbm()
    assert power.PAPER_TOTALS_MW == jpower.PAPER_TOTALS_MW
    assert power.dbm_to_mw(10.0) == jpower.dbm_to_mw(10.0)


@pytest.fixture(scope="module")
def fitted_pair():
    """The port's accelerator (scan kernel path) and the reference's, both
    fitted on the same NARMA10 series at N = 16."""
    ds = tasks.narma10(1200, seed=0)
    kw = dict(n_nodes=16, washout=60, ridge_l2=LAMS)
    port = DFRCAccelerator(DFRCConfig(model=SiliconMR(), state_method="kernel", **kw),
                           device="cpu").fit(ds.inputs_train, ds.targets_train)
    ref = JAccelerator(JDFRCConfig(model=JMR(), **kw)).fit(ds.inputs_train, ds.targets_train)
    return ds, port, ref


def test_accelerator_fit_predict_matches_reference(fitted_pair):
    ds, port, ref = fitted_pair
    np.testing.assert_allclose(port.readout.w.numpy(), np.asarray(ref.readout.w), atol=1e-3)
    e_port = port.evaluate_nrmse(ds.inputs_test, ds.targets_test)
    e_ref = ref.evaluate_nrmse(ds.inputs_test, ds.targets_test)
    assert abs(e_port - e_ref) <= 1e-4, (e_port, e_ref)
    assert e_port < 0.7


def test_accelerator_carry_continues_the_loop(fitted_pair):
    """``states`` continues from where the reservoir stopped; predict uses
    the carry of the series before, as the physical loop does."""
    ds, port, _ = fitted_pair
    x = np.asarray(ds.inputs_test[:40])
    port._s_carry = None
    a = port.states(x)
    b = port.states(x)                       # continues from a's last row
    c = port.states(x, carry=False)          # from the dark state
    assert torch.equal(a, c) and not torch.equal(a, b)
    assert torch.equal(port._s_carry, b[-1])
    assert isinstance(port.predict(x), np.ndarray)


def test_accelerator_ser_matches_reference():
    ch = tasks.channel_equalization(3000, seed=1)
    kw = dict(n_nodes=16, washout=60, ridge_l2=LAMS, quantize=True)
    port = DFRCAccelerator(DFRCConfig(model=SiliconMR(), state_method="kernel", **kw),
                           device="cpu").fit(ch.inputs_train, ch.targets_train)
    ref = JAccelerator(JDFRCConfig(model=JMR(), **kw)).fit(ch.inputs_train, ch.targets_train)
    y = port.predict(ch.inputs_test)
    assert set(np.unique(y)) <= {-3.0, -1.0, 1.0, 3.0}
    port._s_carry = None
    port.states(ch.inputs_train)
    assert port.evaluate_ser(ch.inputs_test, ch.targets_test) == \
        ref.evaluate_ser(ch.inputs_test, ch.targets_test)


def test_accelerator_pinv_and_errors():
    ds = tasks.narma10(400, seed=2)
    acc = DFRCAccelerator(DFRCConfig(n_nodes=8, washout=20, readout_method="pinv",
                                     state_noise_rel=0.0), device="cpu")
    with pytest.raises(RuntimeError, match="fit"):
        acc.predict(ds.inputs_test)
    ref = JAccelerator(JDFRCConfig(n_nodes=8, washout=20, readout_method="pinv",
                                   state_noise_rel=0.0))
    acc.fit(ds.inputs_train, ds.targets_train)
    ref.fit(ds.inputs_train, ds.targets_train)
    np.testing.assert_allclose(acc.predict(ds.inputs_test), np.asarray(ref.predict(ds.inputs_test)),
                               atol=1e-3)


def test_accelerator_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DFRCAccelerator(DFRCConfig(n_nodes=8))


def test_from_dfrc_field_for_field():
    """The port's from_dfrc of a DFRCConfig equals the reference's from_dfrc
    of the same config, carried across field by field."""
    full = dict(n_nodes=40, mask_levels=[-1.0, 1.0], mask_seed=3, input_gain=0.5,
                normalize_input=False, washout=7, ridge_l2=1e-3, state_noise_rel=0.0,
                noise_seed=4, state_method="kernel", quantize=True)
    for model, jmodel, kw in ((SiliconMR(), JMR(), {}), (MZISine(), JMZISine(), full),
                              (MackeyGlass(), JMackeyGlass(), dict(ridge_l2=LAMS))):
        port = ExperimentConfig.from_dfrc(DFRCConfig(model=model, **kw))
        ref = config_from_reference(JExperimentConfig.from_dfrc(JDFRCConfig(model=jmodel, **kw)))
        assert port == ref
        assert isinstance(port.ridge_l2, tuple) and isinstance(port.mask_levels, tuple)


def test_dfrc_config_from_reference():
    ref = JDFRCConfig(model=JMR(beta_tpa=0.25), n_nodes=30, ridge_l2=LAMS, washout=60,
                      quantize=True, state_method="kernel", noise_seed=9)
    port = dfrc_config_from_reference(ref)
    assert port == DFRCConfig(model=SiliconMR(beta_tpa=0.25), n_nodes=30, ridge_l2=LAMS,
                              washout=60, quantize=True, state_method="kernel", noise_seed=9)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    with pytest.raises(TypeError, match="DFRCConfig"):
        dfrc_config_from_reference(JExperimentConfig())


def test_matches_host_accelerator():
    """Pipeline ≈ host DFRCAccelerator on the same task (the counterpart of
    tests/test_pipeline.py::test_matches_host_accelerator)."""
    ds = tasks.narma10(1200, seed=0)
    host_cfg = DFRCConfig(model=SiliconMR(), n_nodes=200, washout=60, ridge_l2=LAMS)
    host = DFRCAccelerator(host_cfg, device="cpu").fit(ds.inputs_train, ds.targets_train)
    err_host = host.evaluate_nrmse(ds.inputs_test, ds.targets_test)
    res = Experiment(ExperimentConfig.from_dfrc(host_cfg), device="cpu").run_dataset(ds)
    assert abs(float(res.nrmse[0]) - err_host) < 0.05, (res.nrmse, err_host)
