"""Port parity: carrying reference models, configs and readouts across
(repro_torch.convert).

A readout fitted by the JAX pipeline, carried across as numpy, must give
the port's predictions on the port's states of the same inputs: the states
agree to 1e-6 (SiliconMR), so the predictions agree to 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MZISine as JMZI
from repro.core import MackeyGlass as JMG
from repro.core import SiliconMR as JMR
from repro.core import SiliconMRLiteral as JLit
from repro.core import generate_states as jgenerate_states
from repro.core import make_mask as jmake_mask
from repro.core import tasks as jtasks
from repro.devices import CMTSweepParams as JSweepParams
from repro.devices import calibrated_twin as jcalibrated_twin
from repro.pipeline import Experiment as JExperiment
from repro.pipeline import ExperimentConfig as JConfig
from repro.pipeline import apply_readout as japply_readout
from repro.pipeline import fit_ridge_batched as jfit_ridge_batched
from repro_torch import convert
from repro_torch.core import MackeyGlass, MZISine, SiliconMR, SiliconMRLiteral, generate_states
from repro_torch.devices import CMTSweepParams, calibrated_twin
from repro_torch.pipeline import Experiment, apply_readout


@pytest.mark.parametrize("ref,port", [
    (JMR(gamma=0.8, beta_tpa=0.3), SiliconMR(gamma=0.8, beta_tpa=0.3)),
    (JLit(gamma=0.5), SiliconMRLiteral(gamma=0.5)),
    (JMG(eta=0.6), MackeyGlass(eta=0.6)),
    (JMZI(phi=0.2), MZISine(phi=0.2))])
def test_model_from_reference(ref, port):
    assert convert.model_from_reference(ref) == port


def test_model_from_reference_carries_the_cmt_cavity():
    """A reference MRCavityCMT converts (the devices package registers the
    port's class) and ticks as the reference's to 1e-6."""
    ref = jcalibrated_twin(JMR(), power_mw=1.0, detune=0.4, n_substeps=3)
    port = convert.model_from_reference(ref)
    assert port == calibrated_twin(SiliconMR(), power_mw=1.0, detune=0.4, n_substeps=3)
    rng = np.random.default_rng(5)
    u, s_tau, s_pn = (rng.uniform(0, 1, (64,)).astype(np.float32) for _ in range(3))
    got = port.node_update(*(torch.as_tensor(a) for a in (u, s_tau, s_pn)))
    want = ref.node_update(*(jnp.asarray(a) for a in (u, s_tau, s_pn)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_dev_params_from_reference():
    ref = JSweepParams(detune=jnp.asarray([0.0, 0.5], jnp.float32), loss_scale=1.25,
                       power=np.asarray([1.0, 2.0]))
    port = convert.dev_params_from_reference(ref, device="cpu")
    assert isinstance(port, CMTSweepParams)
    for a, b in zip(port, ref):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b, np.float32))
    with pytest.raises(TypeError, match="lacks"):
        convert.dev_params_from_reference((1.0,), device="cpu")


def test_model_from_reference_rejects_unported_models():
    @dataclasses.dataclass(frozen=True)
    class UnportedCavity:
        q: float = 1.0

    with pytest.raises(TypeError, match="no port"):
        convert.model_from_reference(UnportedCavity())


def test_config_from_reference_carries_every_field():
    ref = JConfig(model=JMG(), n_nodes=40, mask_levels=(-1.0, 1.0), mask_seed=3,
                  input_gain=0.7, washout=12, ridge_l2=(1e-4, 1e-2), state_noise_rel=0.0,
                  noise_seed=5, state_method="kernel", readout_use_kernel=True, quantize=True,
                  collect_y_pred=False, kernel_block_s=2, readout_block_t=64)
    port = convert.config_from_reference(ref)
    for f in dataclasses.fields(ref):
        if f.name != "model":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.model == MackeyGlass()
    with pytest.raises(TypeError):
        convert.config_from_reference(JMR())


def test_config_from_reference_carries_streaming_configs():
    """A streaming reference config (chunk, bf16 chunks, diagonal noise)
    carries across and runs the same in the port: diagonal noise is
    deterministic, so the NRMSE agrees within the bf16 drift bound (0.06)
    and the f32 form within 1e-3."""
    batch = [np.stack([getattr(jtasks.narma10(400, seed=s), f) for s in range(2)])
             for f in ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    kw = dict(model=JMR(), n_nodes=16, washout=30, ridge_l2=(1e-4,), stream_chunk_k=48,
              state_noise_mode="diagonal", state_noise_rel=0.003, state_method="fast")
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 0.06)):
        ref = JConfig(stream_state_dtype=dtype, **kw)
        port = convert.config_from_reference(ref)
        for f in dataclasses.fields(ref):
            if f.name != "model":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
        got = Experiment(port, device="cpu").run(*batch)
        want = JExperiment(ref).run(*batch)
        assert np.max(np.abs(got.nrmse - want.nrmse)) <= tol, (dtype, got.nrmse, want.nrmse)


def test_reference_config_runs_the_same_in_the_port():
    batch = [np.stack([getattr(jtasks.narma10(300, seed=s), f) for s in range(2)])
             for f in ("inputs_train", "targets_train", "inputs_test", "targets_test")]
    ref = JConfig(model=JMR(), n_nodes=24, washout=30, ridge_l2=(1e-4,), state_noise_rel=0.0)
    want = JExperiment(ref).run(*batch)
    got = Experiment(convert.config_from_reference(ref), device="cpu").run(*batch)
    assert np.max(np.abs(got.nrmse - want.nrmse)) <= 1e-3


def test_jax_fitted_readout_carried_across():
    rng = np.random.default_rng(0)
    j = rng.uniform(0, 1, (3, 120)).astype(np.float32)
    y = rng.standard_normal((3, 120)).astype(np.float32)
    jmask = jmake_mask(20, seed=2)
    mask = convert.mask_from_numpy(np.asarray(jmask))
    jst = jgenerate_states(JMR(), jnp.asarray(j), jmask, method="ref")
    w_j, _ = jfit_ridge_batched(jst, jnp.asarray(y), lambdas=(1e-4,))
    want = np.asarray(japply_readout(jst, w_j))
    w = convert.readout_from_numpy(np.asarray(w_j))
    st = generate_states(SiliconMR(), j, mask, method="kernel", device="cpu")
    got = apply_readout(st, w)
    assert w.shape == (3, 21, 1) and tuple(got.shape) == want.shape == (3, 120)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_lm_cache_and_encoder_carried_across(arch):
    """A reference prefill's cache (Mamba's conv window and h, mLSTM's
    (conv, C, n, m), sLSTM's (c, n, m, h), cross-attention's context k, v)
    and a reference params tree with its encoder subtree, carried into the
    port: the port's decode steps from that cache give the reference's
    logits within 1e-5 (f32, smoke size)."""
    import importlib.util
    import pathlib

    import jax

    from repro.configs import smoke_config as jsmoke_config
    from repro.models import decode_step as jdecode_step
    from repro.models import prefill as jprefill
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode_step

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_convert", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, jcfg = smoke_config(arch), jsmoke_config(arch)
    params = cs.lm_numpy_params(cfg, 5)
    assert ("encoder" in params) == bool(cfg.n_encoder_layers)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.lm_params_from_reference(params, device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    ctx = (jnp.asarray(rng.standard_normal((2, cfg.n_context_tokens, cfg.d_model),
                                           dtype=np.float32))
           if cfg.n_context_tokens else None)
    _, jc = jprefill(jcfg, jp, jnp.asarray(toks[:, :6], jnp.int32), max_len=10, context=ctx)
    tc = convert.lm_cache_from_reference(cfg, jc, device="cpu")
    assert tc["pos"] == 6
    for i in range(6, 9):
        step = jnp.asarray(toks[:, i:i + 1], jnp.int32)
        jl, jc = jdecode_step(jcfg, jp, jc, step)
        tl, tc = decode_step(cfg, tp, tc, torch.as_tensor(toks[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
