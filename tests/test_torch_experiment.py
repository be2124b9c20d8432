"""Port parity: Experiment.run, the paper's claims path (repro_torch.pipeline).

Noise off (``state_noise_rel=0``), the port and the JAX pipeline see the
same f32 inputs and must agree to 1e-3 in NRMSE and SER at N = 32, B = 4.
The readout uses one well-conditioned λ (1e-4), as the reference's own
method-parity test does: with noise off and λ down to 1e-10, the GCV fit
of a 33-feature reservoir on 140 samples is ill-posed and f32 round-off in
either framework moves the answer by O(1).

Noise on, the port draws its digitiser noise from a torch.Generator and
cannot reproduce jax.random's bits.  The band is set from the reference's
own spread: over noise_seed 0..7 the JAX NRMSE of each NARMA10 instance
below moves by up to 0.006 and the chan-eq SER by up to 0.01 (measured on
CPU at these settings); the bands (0.02 NRMSE, 0.025 SER) are about twice
to three times that.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.core import SiliconMR as JMR
from repro.core import tasks as jtasks
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro_torch.core import SiliconMR, tasks
from repro_torch.pipeline import Experiment, ExperimentConfig

LAMS = (1e-10, 1e-8, 1e-6, 1e-4, 1e-2)


def _stack(datasets):
    return tuple(np.stack([getattr(d, f) for d in datasets])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


@pytest.fixture(scope="module")
def narma_small():
    return _stack([tasks.narma10(360, seed=s) for s in range(4)])


@pytest.fixture(scope="module")
def chan_small():
    return _stack([tasks.channel_equalization(3000, snr_db=28.0, seed=s) for s in range(4)])


@pytest.fixture(scope="module")
def jax_runs(narma_small, chan_small):
    """Reference results, one per (task, readout), noise off."""
    out = {}
    for use_kernel in (False, True):
        cfg = JConfig(model=JMR(), n_nodes=32, washout=40, ridge_l2=(1e-4,),
                      state_noise_rel=0.0, readout_use_kernel=use_kernel)
        out[("narma", use_kernel)] = JExperiment(cfg).run(*narma_small)
    cfg = JConfig(model=JMR(), n_nodes=32, washout=60, ridge_l2=(1e-4,), state_noise_rel=0.0,
                  quantize=True)
    out[("chan", False)] = JExperiment(cfg).run(*chan_small)
    return out


@pytest.mark.parametrize("method,use_kernel", [("ref", False), ("fast", False),
                                               ("kernel", False), ("kernel", True)])
def test_narma10_noise_off_matches_reference(narma_small, jax_runs, method, use_kernel):
    cfg = ExperimentConfig(model=SiliconMR(), n_nodes=32, washout=40, ridge_l2=(1e-4,),
                           state_noise_rel=0.0, state_method=method,
                           readout_use_kernel=use_kernel)
    got = Experiment(cfg, device="cpu").run(*narma_small)
    want = jax_runs[("narma", use_kernel)]
    assert got.y_pred.shape == want.y_pred.shape == (4, 180)
    assert got.readout_w.shape == want.readout_w.shape == (4, 33)
    assert np.max(np.abs(got.nrmse - want.nrmse)) <= 1e-3
    assert np.max(np.abs(got.ser - want.ser)) <= 1e-3
    np.testing.assert_array_equal(got.lam, want.lam)


def test_channel_eq_noise_off_matches_reference(chan_small, jax_runs):
    cfg = ExperimentConfig(model=SiliconMR(), n_nodes=32, washout=60, ridge_l2=(1e-4,),
                           state_noise_rel=0.0, quantize=True, state_method="fast")
    got = Experiment(cfg, device="cpu").run(*chan_small)
    want = jax_runs[("chan", False)]
    assert set(np.unique(got.y_pred)) <= {-3.0, -1.0, 1.0, 3.0}
    assert np.max(np.abs(got.ser - want.ser)) <= 1e-3
    assert np.max(np.abs(got.nrmse - want.nrmse)) <= 1e-3


@pytest.mark.parametrize("use_kernel", [False, True], ids=["svd", "gram"])
def test_noise_on_within_band_of_reference(use_kernel):
    narma = _stack([tasks.narma10(1200, seed=s) for s in range(4)])
    kw = dict(n_nodes=48, washout=60, ridge_l2=LAMS, readout_use_kernel=use_kernel)
    got = Experiment(ExperimentConfig(model=SiliconMR(), **kw), device="cpu").run(*narma)
    want = JExperiment(JConfig(model=JMR(), **kw)).run(*narma)
    assert np.all(np.abs(got.nrmse - want.nrmse) <= 0.02), (got.nrmse, want.nrmse)
    assert np.all(got.nrmse < 0.72)


def test_channel_eq_noise_on_ser_within_band_of_reference():
    chan = _stack([jtasks.channel_equalization(3000, snr_db=28.0, seed=s) for s in range(4)])
    kw = dict(n_nodes=48, washout=60, ridge_l2=LAMS, quantize=True)
    got = Experiment(ExperimentConfig(model=SiliconMR(), **kw), device="cpu").run(*chan)
    want = JExperiment(JConfig(model=JMR(), **kw)).run(*chan)
    assert np.all(np.abs(got.ser - want.ser) <= 0.025), (got.ser, want.ser)
    assert np.all(got.ser < 0.16)


def test_multichannel_targets_and_metrics_only(narma_small):
    ds = [tasks.memory_capacity(300, max_delay=3, seed=s) for s in range(2)]
    batch = _stack(ds)
    cfg = ExperimentConfig(model=SiliconMR(), n_nodes=16, washout=20, ridge_l2=(1e-4,),
                           state_noise_rel=0.0)
    got = Experiment(cfg, device="cpu").run(*batch)
    want = JExperiment(JConfig(model=JMR(), n_nodes=16, washout=20, ridge_l2=(1e-4,),
                               state_noise_rel=0.0)).run(*batch)
    assert got.y_pred.shape == want.y_pred.shape == (2, 150, 3)
    assert got.readout_w.shape == (2, 17, 3)
    assert np.max(np.abs(got.nrmse - want.nrmse)) <= 1e-3
    quiet = Experiment(dataclasses.replace(cfg, collect_y_pred=False, n_nodes=8),
                       device="cpu").run(*narma_small)
    assert quiet.y_pred is None and quiet.batch == 4
    one = Experiment(dataclasses.replace(cfg, n_nodes=8), device="cpu").run_dataset(
        tasks.narma10(200, seed=1))
    assert one.batch == 1 and one.y_pred.shape == (1, 100)


def test_config_raises_for_unported_and_invalid_settings(monkeypatch):
    # the streaming fields are ported: the reference's validation errors
    with pytest.raises(ValueError, match="state_noise_mode='diagonal'"):
        ExperimentConfig(stream_chunk_k=64)            # sampled noise (0.003) + streaming
    with pytest.raises(ValueError, match="set stream_chunk_k"):
        ExperimentConfig(stream_state_dtype="bfloat16")
    for ok in (dict(stream_chunk_k=64, state_noise_mode="diagonal"),
               dict(stream_chunk_k=64, state_noise_rel=0.0, stream_state_dtype="bfloat16")):
        for cls in (ExperimentConfig, JConfig):
            cls(**ok)
    with pytest.raises(TypeError, match="topology must be"):
        ExperimentConfig(topology=object())
    with pytest.raises(ValueError, match="state_noise_mode"):
        ExperimentConfig(state_noise_mode="exact")
    with pytest.raises(ValueError, match="stream_state_dtype"):
        ExperimentConfig(stream_state_dtype="float16")
    with pytest.raises(ValueError, match="diagonal"):
        ExperimentConfig(state_noise_mode="diagonal")
    assert ExperimentConfig(ridge_l2=1e-3).ridge_l2 == (1e-3,)
    assert ExperimentConfig(ridge_l2=[1e-3, 1e-2]).ridge_l2 == (1e-3, 1e-2)
    exp = Experiment(ExperimentConfig(n_nodes=8), device="cpu")
    with pytest.raises(TypeError, match="swept device parameters"):
        exp.run(np.zeros(10), np.zeros(10), np.zeros(10), np.zeros(10), dev_params={})
    with pytest.raises(ValueError, match="inconsistent"):
        exp.run(np.zeros((2, 10)), np.zeros((2, 10)), np.zeros((3, 10)), np.zeros((3, 10)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        Experiment(ExperimentConfig(n_nodes=8))


def test_gram_vs_svd_readout_gap_is_the_references_own():
    """Between the Gram (eigh) and the SVD readout the NRMSE moves by more
    than 1e-3 on some of these eight seeds — in the JAX package as in the
    port (the Gram squares cond(X)).  So chip_smoke.py holds that pair to
    the reference's 5e-3 (tests/test_pipeline.py) and the states paths to
    1e-3."""
    batch = _stack([tasks.narma10(360, seed=s) for s in range(8)])
    kw = dict(n_nodes=32, washout=40, ridge_l2=(1e-4,), state_noise_rel=0.0)
    gaps = {}
    for name, exp_cls, cfg_cls, model in (("jax", JExperiment, JConfig, JMR()),
                                          ("port", Experiment, ExperimentConfig, SiliconMR())):
        extra = {} if name == "jax" else {"device": "cpu"}
        res = [exp_cls(cfg_cls(model=model, readout_use_kernel=k, **kw), **extra).run(*batch)
               for k in (False, True)]
        gaps[name] = np.abs(res[1].nrmse - res[0].nrmse)
    assert gaps["jax"].max() > 1e-3 and gaps["port"].max() > 1e-3, gaps
    assert gaps["jax"].max() <= 5e-3 and gaps["port"].max() <= 5e-3, gaps
    np.testing.assert_allclose(gaps["port"], gaps["jax"], atol=1e-3)


@pytest.fixture(scope="module")
def chan_paper_states():
    """Chan-eq at the paper's Silicon MR point (configs: N = 30, 9000
    symbols at 24 dB, washout 60) for 8 seeds: the JAX package's states
    (fit split after washout, test split) and the targets, as numpy."""
    from repro.core import generate_states as jgen
    from repro.core import make_mask as jmask
    from repro.core import sample_and_hold as jhold

    tr, ytr, te, yte = _stack([jtasks.channel_equalization(9000, seed=s) for s in range(8)])
    lo = tr.min(axis=1, keepdims=True)
    scale = 1.0 / (tr.max(axis=1, keepdims=True) - lo + 1e-12)
    mask = jmask(30, seed=1)
    st_tr, fin = jgen(JMR(), jhold(np.float32((tr - lo) * scale)), mask, method="fast",
                      return_final=True)
    st_te = jgen(JMR(), jhold(np.float32((te - lo) * scale)), mask, s0=fin, method="fast")
    return np.asarray(st_tr)[:, 60:], np.float32(ytr[:, 60:]), np.asarray(st_te), yte


@pytest.mark.parametrize("noise", [0.0, 0.003], ids=["noise_off", "noise_on"])
def test_chan_eq_paper_point_readouts_match_reference(chan_paper_states, noise):
    """At the paper's chan-eq point (N = 30, the λ grid) the Gram/eigh
    readout misses the SER band (< 0.16 each, mean < 0.13) in the JAX
    package, and the port's Gram op + eigh solve gives the same SERs; the
    SVD readout meets the band in both.  So the miss is the reference's
    f32 eigh-of-G algorithm (cond(X) squared), not the port's Gram or solve.

    Both packages fit the same f32 states; with noise on, the same numpy
    draw of the digitiser noise is added for both.  Per instance the SERs
    must agree to 0.005 (15 of the 3000 test symbols).  The reference's own
    spread is about a third of that: fitting its Gram from an XLA matmul
    instead of its Pallas kernel (another f32 summation order) moves the
    SER of these seeds by up to 0.0017 (measured on CPU), because the GCV
    scores of neighbouring λ nearly tie and the pick flips.
    """
    import jax.numpy as jnp

    from repro.pipeline import ridge as jridge
    from repro_torch.pipeline import fit_ridge_batched

    st_fit, y_fit, st_te, y_te = chan_paper_states
    if noise:
        rng = np.random.default_rng(7)
        sigma = noise * st_fit.std(axis=(1, 2), keepdims=True)
        st_fit = np.float32(st_fit + sigma * rng.standard_normal(st_fit.shape))
    symbols = np.array([-3.0, -1.0, 1.0, 3.0])

    def ser(w):
        y = np.einsum("btn,bn->bt", st_te, w[:, :-1, 0]) + w[:, -1:, 0]
        near = np.argmin(np.abs(y[..., None] - symbols), axis=-1)
        return np.mean(symbols[near] != y_te, axis=1)

    sers = {}
    for use_kernel in (False, True):
        w_jax, _ = jridge.fit_ridge_batched(jnp.asarray(st_fit), jnp.asarray(y_fit),
                                            lambdas=LAMS, use_kernel=use_kernel)
        w_port, _ = fit_ridge_batched(torch.tensor(st_fit), torch.tensor(y_fit),
                                      lambdas=LAMS, use_kernel=use_kernel, device="cpu")
        sers[use_kernel] = ser(np.asarray(w_jax)), ser(w_port.numpy())
    for use_kernel, (s_jax, s_port) in sers.items():
        assert np.all(np.abs(s_port - s_jax) <= 0.005), (use_kernel, s_jax, s_port)
    for s in sers[False]:      # SVD readout: the band is met
        assert np.all(s < 0.16) and s.mean() < 0.13, s
    for s in sers[True]:       # Gram/eigh readout: missed, in both packages
        assert s.mean() >= 0.13, s


@pytest.mark.parametrize("use_kernel", [False, True], ids=["svd", "gram"])
def test_record_stages_times_every_stage_of_one_run(narma_small, use_kernel):
    from repro_torch.pipeline import record_stages

    cfg = ExperimentConfig(model=SiliconMR(), n_nodes=8, washout=40, ridge_l2=LAMS,
                           state_method="kernel", readout_use_kernel=use_kernel)
    exp = Experiment(cfg, device="cpu")
    plain = exp.run(*narma_small)
    t0 = time.perf_counter()
    with record_stages() as seconds:
        timed = exp.run(*narma_small)
        with pytest.raises(RuntimeError, match="already active"):
            with record_stages():
                pass
    wall = time.perf_counter() - t0
    expected = {"input_layer", "states_train", "states_test", "noise", "bias", "solve",
                "evaluation", "pack"} | ({"gram"} if use_kernel else set())
    assert set(seconds) == expected
    assert all(s >= 0.0 for s in seconds.values()) and sum(seconds.values()) <= wall
    np.testing.assert_array_equal(timed.nrmse, plain.nrmse)
    with record_stages() as after:
        pass
    assert after == {}
