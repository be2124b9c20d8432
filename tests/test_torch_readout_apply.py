"""The readout-apply op (``repro_torch.kernels.readout_apply``): the fitted
readout on a chunk of bf16 or f32 states, without an f32 copy of the
features.

On the CPU the wrapper runs its plain version, ``with_bias(x).to(f32) @ w``
(the product as the streamed evaluation and the session computed it
before), so the streamed and session results here are bitwise those of the
widened matmul; the CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).  The contract checker sees the
op as one kernel call, so ``NoSilentUpcast`` now holds in the streamed
evaluation of a bf16 run with no stage exempt.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import NoSilentUpcast, Program, count_kernel_calls
from repro_torch.analysis.registry import ENTRY_POINTS
from repro_torch.analysis.rules import check_rules
from repro_torch.core import SiliconMR, make_mask
from repro_torch.kernels.readout_apply import ops, readout_apply, readout_apply_plain
from repro_torch.pipeline import Experiment, ExperimentConfig, with_bias
from repro_torch.pipeline import experiment as experiment_mod
from repro_torch.pipeline import session as session_mod
from repro_torch.pipeline.experiment import _eval_streaming
from repro_torch.pipeline.stages import stage

CPU = torch.device("cpu")


def _xw(b, t, n, c, dtype, seed, w_batch=None):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (b, t, n)), dtype=torch.float32).to(dtype)
    w = torch.as_tensor(rng.standard_normal((w_batch or b, n + 1, c)), dtype=torch.float32)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bnc", [(3, 17, 1), (2, 40, 5), (1, 900, 1)])
def test_plain_is_the_widened_matmul_within_f32_of_exact(dtype, bnc):
    b, n, c = bnc
    x, w = _xw(b, 7, n, c, dtype, seed=n)
    y = readout_apply(x, w)
    assert y.dtype == torch.float32 and y.shape == (b, 7, c)
    assert torch.equal(y, with_bias(x).to(torch.float32) @ w)
    exact = with_bias(x).double() @ w.double()
    scale = with_bias(x).double().abs() @ w.double().abs()
    assert float(((y.double() - exact).abs() / scale).max()) < 1e-6


def test_one_readout_broadcasts_over_the_batch():
    """The WDM shared readout hands in w [1, N + 1, C]."""
    x, w = _xw(4, 5, 12, 2, torch.bfloat16, seed=1, w_batch=1)
    y = readout_apply(x, w)
    assert torch.equal(y, torch.cat([readout_apply(x[i:i + 1], w) for i in range(4)]))


def test_bad_arguments_raise():
    x, w = _xw(2, 3, 8, 1, torch.float32, seed=2)
    with pytest.raises(ValueError, match="N \\+ 1"):
        readout_apply(x, w[:, :-1])
    with pytest.raises(ValueError, match="neither 1 nor"):
        readout_apply(x, torch.cat([w, w]))
    with pytest.raises(ValueError, match="x \\[B, T, N\\]"):
        readout_apply(x[0], w)


def test_counts_a_call_on_either_route_and_launches_only_on_the_card():
    x, w = _xw(2, 3, 8, 1, torch.float32, seed=3)
    calls, launches = ops.readout_apply.calls, ops.readout_apply.launches
    readout_apply(x, w)
    assert ops.readout_apply.calls == calls + 1 and ops.readout_apply.launches == launches
    readout_apply(x[:, :0], w)                      # nothing to apply: no call
    assert ops.readout_apply.calls == calls + 1
    assert readout_apply_plain(x, w).shape == (2, 3, 1)


def _bf16_config(**kw):
    kw = {"readout_use_kernel": True, **kw}
    return ExperimentConfig(model=SiliconMR(), n_nodes=16, washout=16, ridge_l2=(1e-6, 1e-4),
                            state_noise_rel=0.0, stream_chunk_k=32, state_method="kernel",
                            stream_state_dtype="bfloat16", **kw)


def test_streamed_bf16_and_session_results_unchanged(monkeypatch):
    """A streamed bf16 run and a session's predictions through the op equal,
    bitwise, the same runs with the widened matmul they used before."""
    rng = np.random.default_rng(4)
    data = tuple(rng.uniform(0, 1, (3, t)).astype(np.float32) for t in (96, 96, 64, 64))
    exp = Experiment(_bf16_config(), device=CPU)
    new = exp.run(*data)

    def widened(x, w):
        return with_bias(x).to(torch.float32) @ w

    monkeypatch.setattr(experiment_mod, "readout_apply", widened)
    old = exp.run(*data)
    assert np.array_equal(new.nrmse, old.nrmse) and np.array_equal(new.y_pred, old.y_pred)
    states = torch.as_tensor(rng.uniform(0, 1, (4, 32, 16)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((4, 17, 1)), dtype=torch.float32)
    cfg = session_mod.SessionConfig(model=SiliconMR(), n_nodes=16, use_kernel=True)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(session_mod._predict(cfg, states.to(dt), w), widened(states.to(dt), w))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_the_kernel_flags_pick_the_readout_apply_route(use_kernel):
    """``readout_use_kernel`` (a streamed evaluation) and the session's
    ``use_kernel`` (its prediction) take the op, one call a chunk; without
    them the plain widened matmul runs and no call is made, so the plain
    witnesses of the kernel paths stay plain throughout."""
    rng = np.random.default_rng(9)
    data = tuple(rng.uniform(0, 1, (3, t)).astype(np.float32) for t in (96, 96, 64, 64))
    calls = ops.readout_apply.calls
    Experiment(_bf16_config(readout_use_kernel=use_kernel), device=CPU).run(*data)
    assert ops.readout_apply.calls - calls == (2 if use_kernel else 0)   # 64 test periods / 32
    cfg = session_mod.SessionConfig(model=SiliconMR(), n_nodes=16, use_kernel=use_kernel)
    states = torch.as_tensor(rng.uniform(0, 1, (2, 32, 16)), dtype=torch.bfloat16)
    w = torch.as_tensor(rng.standard_normal((2, 17, 1)), dtype=torch.float32)
    calls = ops.readout_apply.calls
    y = session_mod._predict(cfg, states, w)
    assert ops.readout_apply.calls - calls == int(use_kernel)
    assert torch.equal(y, readout_apply_plain(states, w))


def _eval_program(apply):
    """``_eval_streaming`` over 3 bf16 state chunks [2, 32, 16], its readout
    applied by ``apply``."""
    b, n, chunk = 2, 16, 32
    cfg = _bf16_config()
    mask = make_mask(n, seed=1)
    w = torch.as_tensor(np.random.default_rng(5).standard_normal((b, n + 1, 1)),
                        dtype=torch.float32)
    j = torch.as_tensor(np.random.default_rng(6).uniform(0, 1, (b, 3 * chunk)),
                        dtype=torch.float32)

    def states_fn(j_c, s):
        return j_c.to(torch.bfloat16)[..., None] * mask.to(torch.bfloat16), s

    def fn(jj, yy):
        old = experiment_mod.readout_apply
        experiment_mod.readout_apply = apply
        try:
            with stage("stream_eval", CPU):
                return _eval_streaming(cfg, states_fn, jj, yy[..., None], w, None)
        finally:
            experiment_mod.readout_apply = old

    return Program(fn, (j, j.clone()), name="stream_eval_bf16"), NoSilentUpcast(
        chunk, b * chunk * n)


def test_no_silent_upcast_holds_in_the_streamed_evaluation():
    """Through the op, a bf16 evaluation makes no f32 block at chunk scale
    (one kernel call a chunk); with the widened matmul it did, in the
    ``stream_eval`` stage, which the rule used to exempt."""
    prog, rule = _eval_program(readout_apply)
    assert not rule.check(prog) and prog.error is None
    assert count_kernel_calls(prog.trace) == {"readout_apply": 3}
    widened, rule = _eval_program(lambda x, w: with_bias(x).to(torch.float32) @ w)
    viols = rule.check(widened)
    assert viols and viols[0].path[0] == "stream_eval" and viols[0].dtype == "float32"


def test_device_sweep_bf16_holds_every_rule_without_an_exemption():
    program, rules = ENTRY_POINTS["device_sweep_bf16"].build(CPU)
    upcast = [r for r in rules if isinstance(r, NoSilentUpcast)]
    assert len(upcast) == 1 and not hasattr(upcast[0], "exempt_stages")
    assert check_rules(program, rules) == []
    assert program.error is None
    assert count_kernel_calls(program.trace)["readout_apply"] == 2   # an eval chunk each
