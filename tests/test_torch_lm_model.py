"""The port's LM serving path (``repro_torch.models``, ``runtime.steps``,
``launch.serve``, ``configs``) against the JAX package's, on the same
numpy weights (``chip_smoke.lm_numpy_params``: every leaf non-zero, the
reservoir readout too) carried across by ``convert.lm_params_from_reference``.

Every arch of ``configs.ARCHS`` serves; the cross-attention families get
a stub context (f32, as the launcher draws it).

Tolerances, f32: logits to 1e-5 against the reference (the port agrees to
≈ 1e-6 on O(1) logits, 6e-6 on jamba's: sums in another order); caches
to 1e-5, the recurrent states also to STATE_RTOL of their value; the
port's decode against its own forward at the reference's 2e-4 / 2e-3
(tests/test_models.py:73).  bf16 (reservoir_lm's own serving dtype):
logits to BF16_LOGIT_TOL = 2^-4 against the reference run in bf16.  The
logits (|z| < 3 here) are f32 products of bf16 hidden states that the two
round apart; over the five dense smoke archs × seeds 0-2 the gaps came to
2^-7 … 2^-5 (one to two ulps of a bf16 value in [2, 4)), and the bound is
twice the largest.  It catches what is larger than bf16 rounding; the port
run in f32 is within 0.023 of the reference's bf16 logits here, so the
bf16 test also checks the caches' dtype.  Where the reference's own bf16
logits lie further from its f32 ones (``bf16_logit_tol``), the bound is
twice that spread.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import runnable_cells as jrunnable_cells
from repro.configs import smoke_config as jsmoke_config
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import lm_loss as jlm_loss
from repro.models import prefill as jprefill
from repro.runtime import steps as jsteps
from repro_torch import configs, convert
from repro_torch.models import decode_step, forward, init_params, lm_loss, prefill
from repro_torch.runtime import steps

SERVED = ["reservoir_lm", "granite-8b", "gemma-7b", "qwen3-32b", "starcoder2-3b",
          "jamba-v0.1-52b", "xlstm-1.3b", "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
          "llama-3.2-vision-11b", "seamless-m4t-medium"]
LOGIT_TOL = 1e-5
# Recurrent states (Mamba's h, the mLSTM / sLSTM states, their conv windows)
# are sums over the whole prefix, read from a residual stream that grows
# with depth (|x| up to ≈ 9 at smoke size): they take a relative part too,
# twice the largest seen over the new archs (≈ 2e-6 of the buffer's value).
STATE_RTOL = 4e-6
BF16_LOGIT_TOL = 2 ** -4
DECODE_ATOL, DECODE_RTOL = 2e-4, 2e-3


@functools.cache
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_lm", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def numpy_params(cfg, seed: int = 0) -> dict:
    return chip_smoke().lm_numpy_params(cfg, seed)


def _setup(arch, seed=0):
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    p = numpy_params(cfg, seed)
    return cfg, jcfg, jax.tree.map(jnp.asarray, p), convert.lm_params_from_reference(p, device="cpu")


def _close(t, j, tol=LOGIT_TOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=rtol)


def _context(cfg, b=2, seed=2):
    """The stub context [B, n_context_tokens, d_model] (f32, as the
    launcher draws it) for a cross-attention family, else None."""
    return chip_smoke().lm_context(cfg, b, seed)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_decode_match_reference(arch):
    cfg, jcfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    ctx = _context(cfg)
    jl, jaux = jforward(jcfg, jp, jnp.asarray(toks, jnp.int32), context=_j(ctx))
    tl, aux = forward(cfg, tp, torch.as_tensor(toks), context=_t(ctx))
    assert tl.shape == (2, 10, cfg.vocab_size) and tl.dtype == torch.float32
    if cfg.n_experts:
        assert float(jaux) > 0 and abs(float(aux) - float(jaux)) < 1e-5
    else:
        assert float(aux) == float(jaux) == 0.0
    _close(tl, jl)
    jpl, jc = jprefill(jcfg, jp, jnp.asarray(toks[:, :7], jnp.int32), max_len=12,
                      context=_j(ctx))
    tpl, tc = prefill(cfg, tp, torch.as_tensor(toks[:, :7]), max_len=12, context=_t(ctx))
    _close(tpl, jpl)
    assert tc["pos"] == 7
    for i in range(7, 10):
        jd, jc = jdecode_step(jcfg, jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        td, tc = decode_step(cfg, tp, tc, torch.as_tensor(toks[:, i:i + 1]))
        _close(td, jd)
    assert tc["pos"] == 10
    # the port's cache holds the reference's, buffer for buffer
    for blk, tu, ju in zip(cfg.unit, tc["units"], jc["units"], strict=True):
        rtol = STATE_RTOL if blk.mixer in ("mamba", "mlstm", "slstm") else 0.0
        for tb, jb in zip(tu, ju, strict=True):
            assert tb.shape == jb.shape and str(tb.dtype).removeprefix("torch.") == str(jb.dtype)
            _close(tb, jb, rtol=rtol)


def bf16_logit_tol(jl16, jl32) -> float:
    """BF16_LOGIT_TOL, or twice the reference's own bf16-vs-f32 spread on
    the same tokens where that is larger.  At smoke size two archs carry
    their bf16 rounding far into the logits in the reference itself
    (jamba-v0.1-52b's MoE routing and xlstm-1.3b's gated recurrences: their
    f32 logits move by 0.60 and 0.062 under one 2^-9 relative nudge of the
    embeddings, and the reference's bf16 is 0.743 and 0.253 from its f32);
    their blocks are held in bf16 one by one in tests/test_torch_lm_moe.py
    and tests/test_torch_lm_ssm.py.  For the other archs the spread is
    below 0.03, and the bound stays BF16_LOGIT_TOL."""
    spread = float(np.abs(np.asarray(jl16, np.float32) - np.asarray(jl32, np.float32)).max())
    return max(BF16_LOGIT_TOL, 2 * spread)


@pytest.mark.parametrize("arch", SERVED)
def test_bf16_forward_prefill_decode_match_reference(arch):
    cfg, jcfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    ctx = _context(cfg)
    jl32, _ = jforward(jcfg, jp, jnp.asarray(toks, jnp.int32), context=_j(ctx))
    cfg, jcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (cfg, jcfg))
    jl, _ = jforward(jcfg, jp, jnp.asarray(toks, jnp.int32), context=_j(ctx))
    tol = bf16_logit_tol(jl, jl32)

    def close(t, j):
        _close(t.float(), np.asarray(j, dtype=np.float32), tol)

    tl, _ = forward(cfg, tp, torch.as_tensor(toks), context=_t(ctx))
    close(tl, jl)
    jpl, jc = jprefill(jcfg, jp, jnp.asarray(toks[:, :7], jnp.int32), max_len=12,
                      context=_j(ctx))
    tpl, tc = prefill(cfg, tp, torch.as_tensor(toks[:, :7]), max_len=12, context=_t(ctx))
    close(tpl, jpl)
    for i in range(7, 10):
        jd, jc = jdecode_step(jcfg, jp, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32))
        td, tc = decode_step(cfg, tp, tc, torch.as_tensor(toks[:, i:i + 1]))
        close(td, jd)
    # each cache buffer keeps the reference's dtype: k, v in the model's
    # (a cross-attention's in its context's), recurrent states f32
    for tu, ju in zip(tc["units"], jc["units"], strict=True):
        for tb, jb in zip(tu, ju, strict=True):
            assert str(tb.dtype).removeprefix("torch.") == str(jb.dtype)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_matches_forward_in_the_port(arch):
    cfg, _, _, tp = _setup(arch, seed=2)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10)))
    ctx = _t(_context(cfg, seed=4))
    full, _ = forward(cfg, tp, toks, context=ctx)
    _, cache = prefill(cfg, tp, toks[:, :9], max_len=10, context=ctx)
    step, _ = decode_step(cfg, tp, cache, toks[:, 9:])
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               atol=DECODE_ATOL, rtol=DECODE_RTOL)


def test_serve_steps_match_reference():
    cfg, jcfg, jp, tp = _setup("reservoir_lm", seed=4)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 6))
    jl, jc = jsteps.serve_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len=8)
    tl, tc = steps.serve_prefill(cfg, tp, torch.as_tensor(toks), max_len=8)
    assert tl.shape == (3, cfg.vocab_size)
    _close(tl, jl)
    nxt = np.argmax(np.asarray(jl), -1)[:, None]
    jl2, _ = jsteps.serve_decode(jcfg, jp, jc, jnp.asarray(nxt, jnp.int32))
    tl2, tc2 = steps.serve_decode(cfg, tp, tc, torch.as_tensor(nxt))
    _close(tl2, jl2)
    assert tc2["pos"] == 7


def test_kv_write_past_max_len_raises():
    """The reference clamps the write of a step past its cache; the port raises."""
    cfg, _, _, tp = _setup("granite-8b")
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 5)))
    _, cache = prefill(cfg, tp, toks[:, :4], max_len=4)
    with pytest.raises(ValueError, match="cannot take 1 more at position 4"):
        decode_step(cfg, tp, cache, toks[:, 4:])


def test_init_params_layout_matches_reference():
    from repro.models import init_params as jinit_params

    for arch in SERVED:
        cfg = configs.smoke_config(arch)
        tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        jshapes = jax.eval_shape(lambda c=jsmoke_config(arch): jinit_params(c, jax.random.PRNGKey(0)))
        flat_j = {jax.tree_util.keystr(k): v.shape
                  for k, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
        flat_t = {jax.tree_util.keystr(k): tuple(v.shape)
                  for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert flat_t == flat_j, arch
        units = tp["units"][0]
        if arch == "reservoir_lm":
            assert not units["mixer/readout"].any()             # zero-initialised, as the reference
        assert all(v.dtype == torch.float32 for v in jax.tree.leaves(tp))


def test_callable_inits_match_reference():
    """The defs tables' callable inits (Mamba's S4D-real a_log and its
    dt_bias, mLSTM's open forget-gate bias) and the zero cross-attention
    gate give the reference's values, stacked over the units (a_log to the
    last ulp of two libraries' f32 log)."""
    from repro.models import init_params as jinit_params

    for arch, keys in (("jamba-v0.1-52b", ("mixer/a_log", "mixer/dt_bias")),
                       ("xlstm-1.3b", ("mixer/b_f",)),
                       ("llama-3.2-vision-11b", ("mixer/gate",))):
        cfg = configs.smoke_config(arch)
        tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        jparams = jinit_params(jsmoke_config(arch), jax.random.PRNGKey(0))
        pos = next(i for i, blk in enumerate(cfg.unit)
                   if blk.mixer in ("mamba", "mlstm", "cross_attn"))
        for key in keys:
            np.testing.assert_allclose(tp["units"][pos][key].numpy(),
                                       np.asarray(jparams["units"][pos][key]), rtol=2e-7,
                                       atol=0, err_msg=key)


def test_configs_match_reference():
    assert configs.list_archs() == jlist_archs()
    assert configs.list_archs(include_extras=True) == jlist_archs(include_extras=True)
    for arch in configs.ARCHS:
        for port, ref in ((configs.get_config(arch), jget_config(arch)),
                          (configs.smoke_config(arch), jsmoke_config(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert port.n_units == ref.n_units and port.param_count() == ref.param_count()
        assert configs.runnable_cells(arch) == jrunnable_cells(arch)


def test_lm_loss_matches_reference():
    cfg, jcfg = configs.smoke_config("granite-8b"), jsmoke_config("granite-8b")
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, cfg.vocab_size), dtype=np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 5))
    mask = (rng.uniform(size=(2, 5)) > 0.3).astype(np.float32)
    jloss, jm = jlm_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels), mask=jnp.asarray(mask))
    tloss, tm = lm_loss(cfg, torch.as_tensor(logits), torch.as_tensor(labels),
                        mask=torch.as_tensor(mask))
    assert abs(float(tloss) - float(jloss)) < 1e-5
    for k in ("ce", "z_loss", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) < 1e-5, k


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--arch", "reservoir_lm", "--requests", "2",
                      "--prompt-len", "8", "--new-tokens", "4"])
    assert out.shape == (2, 4)
    line = capsys.readouterr().out
    assert "arch=reservoir_lm" in line and "device=cpu" in line and "tok/s" in line


@pytest.mark.parametrize("arch", SERVED[5:])
def test_serve_launcher_serves_every_arch_on_cpu(arch):
    """The launcher's CLI on the reference launcher's reduced config of each
    arch ported after the dense ones (the stub context drawn after the
    prompts for the cross-attention families): greedy ids of the right
    shape, each step's logits finite."""
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                      "--prompt-len", "6", "--new-tokens", "3"])
    assert out.shape == (2, 3)
    cfg = serve.reduced_config(configs.get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ctx = _t(_context(cfg))
    served = serve.generate(cfg, params, torch.zeros((2, 6), dtype=torch.int64), 3, context=ctx)
    assert served["logits"].shape == (2, 3, cfg.vocab_size)
    assert bool(torch.isfinite(served["logits"]).all())


def test_serve_launcher_logits_match_reference_greedy_loop():
    """The port's greedy loop (``launch.serve.generate``) on the reference
    launcher's reduced config and params (its readout made non-zero),
    against the reference's serve_prefill/serve_decode loop: logits within
    LOGIT_TOL; greedy ids equal wherever the top-2 gap exceeds it."""
    from repro.launch.serve import reduced_config as jreduced_config
    from repro.models import init_params as jinit_params
    from repro_torch.launch import serve

    jcfg = jreduced_config(jget_config("reservoir_lm"))
    cfg = serve.reduced_config(configs.get_config("reservoir_lm"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    unit = dict(params["units"][0])
    unit["mixer/readout"] = rng.standard_normal(unit["mixer/readout"].shape,
                                                dtype=np.float32) * np.float32(0.05)
    params = {**params, "units": (unit,)}
    jp = jax.tree.map(jnp.asarray, params)
    prompts = rng.integers(0, cfg.vocab_size, (2, 12))
    new = 6
    served = serve.generate(cfg, convert.lm_params_from_reference(params, device="cpu"),
                            torch.as_tensor(prompts), new)
    ids, logits = served["ids"], served["logits"]
    assert len(served["decode_step_s"]) == new - 1 and served["cache"]["pos"] == 12 + new - 1
    jl, cache = jsteps.serve_prefill(jcfg, jp, jnp.asarray(prompts, jnp.int32), max_len=12 + new)
    ref_logits = [np.asarray(jl)]
    tok = ids[:, :1].numpy()             # feed the port's own ids to both
    for i in range(1, new):
        jl, cache = jsteps.serve_decode(jcfg, jp, cache, jnp.asarray(tok, jnp.int32))
        ref_logits.append(np.asarray(jl))
        tok = ids[:, i:i + 1].numpy()
    ref = np.stack(ref_logits, axis=1)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGIT_TOL, rtol=0)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > LOGIT_TOL
    assert decided.mean() > 0.5
    assert (ids.numpy() == ref.argmax(-1))[decided].all()


def test_full_width_reservoir_lm_constants():
    """What the lm_serving phase holds the card to: reservoir_lm at full
    width in f32 (12 layers, d 768, N 256, R 3, vocab 32000), B = 2, S = 16,
    on chip_smoke's numpy weights.  The JAX package's logit summary equals
    the pasted constants; the port on the CPU is within the card's
    tolerance of them."""
    cs = chip_smoke()
    cfg = dataclasses.replace(configs.get_config("reservoir_lm"), dtype="float32")
    jcfg = dataclasses.replace(jget_config("reservoir_lm"), dtype="float32")
    p = cs.lm_numpy_params(cfg, cs.LM_SEED)
    toks = cs.lm_tokens(cfg, cs.LM_CHECK_SHAPE, cs.LM_TOKENS_SEED)
    jl, _ = jforward(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(toks, jnp.int32))
    ref = cs.lm_logit_summary(np.asarray(jl))
    assert cs.summary_gap(ref, cs.LM_REF_SUMMARY) < 1e-6
    tl, _ = forward(cfg, convert.lm_params_from_reference(p, device="cpu"), torch.as_tensor(toks))
    assert cs.summary_gap(cs.lm_logit_summary(tl.numpy()), cs.LM_REF_SUMMARY) < cs.LM_SUMMARY_TOL


@pytest.mark.parametrize("arch", SERVED[5:])
def test_smoke_summary_constants(arch):
    """What the lm_serving phase holds each arch's smoke config to on the
    card (``LM_SMOKE_SUMMARY``): the JAX package's f32 logit summary on
    chip_smoke's numpy weights, tokens and context equals the pasted
    constants (9 significant digits), and the port on the CPU is within the
    card's tolerance of them."""
    cs = chip_smoke()
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    p = cs.lm_numpy_params(cfg, cs.LM_SEED)
    toks = cs.lm_tokens(cfg, cs.LM_CHECK_SHAPE, cs.LM_TOKENS_SEED)
    ctx = cs.lm_context(cfg, cs.LM_CHECK_SHAPE[0], cs.LM_CONTEXT_SEED)
    jl, _ = jforward(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(toks, jnp.int32),
                     context=_j(ctx))
    want = cs.LM_SMOKE_SUMMARY[arch]
    assert cs.summary_gap(cs.lm_logit_summary(np.asarray(jl)), want) < 1e-6
    tl, _ = forward(cfg, convert.lm_params_from_reference(p, device="cpu"),
                    torch.as_tensor(toks), context=_t(ctx))
    assert cs.summary_gap(cs.lm_logit_summary(tl.numpy()), want) < cs.LM_SUMMARY_TOL
