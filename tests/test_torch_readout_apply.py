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


# ---------------------------------------------------------------------------
# the kernel's launch plan, simulated: every element read exactly once
# ---------------------------------------------------------------------------


def _simulate_reads(plan, b, t, n, itemsize, base_addr):
    """Replay the kernel's loops (readout_apply.cu) over the plan: how often
    each x[b, t, f] is read, and the (pass, f) of every w row read."""
    elems, group, seg, passes = plan["elems"], plan["group"], plan["seg"], plan["passes"]
    per_group = plan["threads"] // group
    head_tail = (elems + 2) // 4                     # kHeadTail
    reads = np.zeros((b, t, n), dtype=np.int64)
    # block, thread and row group -> (instance, row): each row taken by
    # exactly one group of `group` lanes, at one slot of its block
    blk = np.arange(plan["grid"])[:, None, None]
    tid = np.arange(plan["threads"])[None, :, None]
    rg = np.arange(plan["row_groups"])[None, None, :]
    bb = np.broadcast_to(blk // plan["blocks_per_b"], (plan["grid"], plan["threads"],
                                                         plan["row_groups"]))
    slot = rg * per_group + tid // group
    tt = (blk % plan["blocks_per_b"]) * plan["rows_per_block"] + slot
    assert (slot < plan["rows_per_block"]).all()
    live = tt < t
    rows_seen = np.zeros((b, t), dtype=np.int64)
    np.add.at(rows_seen, (bb[live], tt[live]), 1)
    assert (rows_seen == group).all()
    used = set()

    def one_row(addr):
        """A row's reads by its group's lanes, and the w rows each pass reads."""
        row_reads = np.zeros(n, dtype=np.int64)
        head, body, tail = ops.row_split(n, itemsize, addr)
        assert head < elems and tail < elems and head + body * elems + tail == n
        tail0 = head + body * elems
        for lane in range(group):
            f_head = lane + group * np.arange(head_tail)
            f_tail = tail0 + f_head
            np.add.at(row_reads, f_head[f_head < head], 1)
            np.add.at(row_reads, f_tail[f_tail < n], 1)
            used.update((0, int(f)) for f in f_head[f_head < head])
            used.update((passes - 1, int(f)) for f in f_tail[f_tail < n])
            for p in range(passes):
                j = np.arange(lane, min(seg, body - p * seg), group)    # chunks of the pass
                f = (head + (p * seg + j)[:, None] * elems + np.arange(elems)[None, :]).ravel()
                np.add.at(row_reads, f, 1)
                used.update((p, int(v)) for v in f)
        return row_reads

    # a row's split depends only on its start's offset from a 16-byte boundary
    patterns = {}
    for b_i in range(b):
        for t_i in range(t):
            addr = base_addr + (b_i * t + t_i) * n * itemsize
            if addr % 16 not in patterns:
                patterns[addr % 16] = one_row(addr)
            reads[b_i, t_i] = patterns[addr % 16]
    return reads, used


_PLAN_NS = (1, 7, 63, 64, 65, 900, 901)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", _PLAN_NS)
def test_apply_plan_reads_every_element_once_at_any_alignment(n, dtype):
    """For the card tests' shapes (T ∈ {1, 3, 256}, C ∈ {1, 3, 5}) and row
    starts at every alignment the dtype allows, the plan's blocks, row
    groups, passes and chunks read each x[b, t, f] exactly once (head,
    16-byte body, tail), every w row a pass reads lies in the slice it
    stages (pass 0 holds the head, the last pass the tail and the bias
    row), and the block's shared memory holds its rows' chunks."""
    item = dtype.itemsize
    for t in (1, 3, 256):
        for c in (1, 3, 5):
            plan = ops.apply_plan(2, t, n, c, dtype)
            assert plan["group"] in (4, 8, 16) and plan["row_groups"] in (1, 2, 4)
            assert plan["seg"] % plan["group"] == 0
            assert plan["seg"] <= ops.LANE_CHUNKS * plan["group"]
            assert plan["col_block"] == (1 if c == 1 else 4)
            assert plan["rows_per_block"] * plan["seg"] * 16 <= max(
                ops.ROWS_BUDGET, plan["threads"] // plan["group"] * plan["seg"] * 16)
            assert plan["smem_bytes"] == ops.smem_bytes(item, plan["seg"],
                                                        plan["rows_per_block"],
                                                        plan["col_block"])
            step = plan["seg"] * plan["elems"]
            for base in sorted({0, item, 8, 16 - item}):
                reads, used = _simulate_reads(plan, 2, t, n, item, base)
                assert (reads == 1).all(), (t, c, base)
                for p, f in used | {(plan["passes"] - 1, n)}:     # the bias row last
                    rel = f - p * step
                    assert 0 <= rel < min((plan["seg"] + 1) * plan["elems"], n + 1 - p * step)
                    assert rel // plan["elems"] <= plan["seg"]


def test_apply_plan_at_the_main_path_shapes():
    """The layouts the kernel's design names: 16 lanes a row, four chunks a
    lane a pass, two passes, 16 rows in a block of 256 threads at the bf16
    evaluation chunk; 8 lanes a row, two chunks a lane, an instance's 32
    rows in a block of 128 threads at the serving tick."""
    bf = ops.apply_plan(64, 256, 900, 1, torch.bfloat16)
    assert (bf["group"], bf["seg"], bf["passes"], bf["rows_per_block"]) == (16, 64, 2, 16)
    assert (bf["threads"], bf["grid"]) == (256, 64 * 16)
    f32 = ops.apply_plan(4096, 32, 64, 1, torch.float32)
    assert (f32["group"], f32["seg"], f32["passes"], f32["rows_per_block"]) == (8, 16, 1, 32)
    assert (f32["threads"], f32["grid"]) == (128, 4096)
    # bf16 rows of N = 900 alternate between two alignments: 0 and 8 bytes off
    assert [ops.row_split(900, 2, r * 1800) for r in range(2)] == [(0, 112, 4), (4, 112, 0)]
