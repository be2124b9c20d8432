"""The port's program-contract checker (``repro_torch.analysis``) on the CPU.

Mirrors tests/test_analysis.py layer by layer: the tracer (stage
provenance, a kernel call as one op), the rule engine (each rule flags a
deliberately violating mini-program with its provenance and passes the
clean twin; ``SmemBudget`` on the ``block_copy`` fixture's plan), the
registry (every entry the port registers holds its rules here, and the
reference's entry of the same name holds each of its rules), and the CLI
gate.  The card half of the gate is ``tests/test_torch_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import (InPlaceHonored, MaxKernelCalls, NoDtypeAbove, NoHostSync,
                                  NoSilentUpcast, NoStateTensor, Program, SmemBudget,
                                  count_kernel_calls, state_tensor_bytes, state_tensor_records,
                                  trace_program)
from repro_torch.core import SiliconMR, make_mask
from repro_torch.kernels.block_copy import ops as copy_ops
from repro_torch.kernels.dfr_scan import ops as scan_ops
from repro_torch.kernels.ridge_gram import ops as gram_ops
from repro_torch.pipeline.stages import current_path, record_stages, stage

CPU = torch.device("cpu")

# ---------------------------------------------------------------------------
# tracer: provenance, kernel calls
# ---------------------------------------------------------------------------


def test_trace_files_ops_under_the_open_stage_marks():
    """The stage stack is kept whether or not record_stages is on, and
    every op's outputs carry it."""
    def prog(x):
        with stage("outer", CPU):
            y = x * 2.0
            with stage("inner", CPU):
                z = y @ y.T
        return z.sum()

    assert current_path() == ()
    tr = trace_program(prog, torch.ones((4, 4)))
    paths = {r.op: r.path for r in tr.records}
    assert paths["mul"] == ("outer",) and paths["mm"] == ("outer", "inner")
    assert paths["sum"] == ()
    assert tr.result == 256.0
    with record_stages() as seconds:
        tr2 = trace_program(prog, torch.ones((4, 4)))
    assert {r.op: r.path for r in tr2.records} == paths and set(seconds) == {"outer", "inner"}


def test_kernel_call_is_one_op_on_either_route():
    """A K1 call on the CPU runs its plain version (hundreds of ops), but
    the trace records one call with its plan and only its outputs, under
    the kernel's name; calls are counted, launches are not."""
    b, k, n = 2, 16, 8
    j, s0 = torch.rand((b, k)), torch.zeros((b, n))
    mask = make_mask(n, seed=0)
    before = (scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls)
    tr = trace_program(lambda jj: scan_ops.dfr_scan(SiliconMR(), jj, mask, s0,
                                                    return_final=True), j)
    assert (scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls) == (before[0], before[1] + 1)
    assert count_kernel_calls(tr) == {"dfr_scan": 1}
    (call,) = tr.kernel_calls
    assert call.plan == scan_ops.scan_plan(SiliconMR(), b, n, False)
    assert {r.op for r in tr.records} == {"dfr_scan"}
    assert sorted(r.shape for r in tr.records) == [(b, n), (b, k, n)]


def test_state_tensor_benign_template_exempts_axis_collision():
    """A [B, F, F] Gram with F == the chunk length is exempt once declared
    benign, while a true [B, t, 8] state tensor is still flagged."""
    b, t, f = 2, 64, 64

    def prog(x):
        gram = x.mT @ x
        state = torch.cumsum(x[..., :8], dim=1)
        return gram.sum() + state.sum()

    tr = trace_program(prog, torch.ones((b, t, f)))
    floor = b * t * 8
    assert state_tensor_bytes(tr, t, floor) >= b * f * f * 4
    recs = state_tensor_records(tr, t, floor, benign_shapes=((b, f, f),))
    assert recs and all(sorted(r.shape) != sorted((b, f, f)) for r in recs)
    assert any(r.shape == (b, t, 8) for r in recs)
    tr_g = trace_program(lambda x: (x.mT @ x).sum(),
                         torch.ones((b, t, f)))
    assert state_tensor_bytes(tr_g, t, floor, benign_shapes=((b, f, f),)) == 0


# ---------------------------------------------------------------------------
# rule engine: each rule flags its violation, with provenance
# ---------------------------------------------------------------------------


def test_rule_no_state_tensor_flags_a_materialized_stage_output():
    b, n, t = 2, 16, 50

    def bad(x):
        with stage("states", CPU):
            ys = torch.stack([torch.tanh(x[i][:, None] + torch.zeros((b, n)))
                              for i in range(t)])
        return ys.sum()

    def good(x):
        s = torch.zeros((b, n))
        with stage("states", CPU):
            for i in range(t):
                s = torch.tanh(s + x[i][:, None])
        return s.sum()

    rule = NoStateTensor(t, b * t * n)
    viols = rule.check(Program(bad, (torch.ones((t, b)),)))
    assert viols and any(v.shape == (t, b, n) and v.path == ("states", "stack")
                         for v in viols)
    assert not rule.check(Program(good, (torch.ones((t, b)),)))


def test_rule_max_kernel_calls_counts_per_chunk():
    mask = make_mask(8, seed=0)
    s0 = torch.zeros((2, 8))

    def chunks(j):
        s = s0
        for c in range(3):
            with stage("chunk", CPU):
                _, s = scan_ops.dfr_scan(SiliconMR(), j[:, 4 * c:4 * c + 4], mask, s,
                                         return_final=True)
        return s

    prog = Program(chunks, (torch.rand((2, 12)),))
    assert not MaxKernelCalls((1, 3)).check(prog)
    assert MaxKernelCalls((1, 3)).limit == 3 and "1x3 = 3" in MaxKernelCalls((1, 3)).describe()
    (viol,) = MaxKernelCalls((1, 2)).check(prog)
    assert "3 kernel calls > limit 2" in viol.message and "dfr_scan x3" in viol.message
    assert viol.path == ("chunk",)
    assert MaxKernelCalls(0).check(prog)


def test_rule_no_dtype_above_catches_f64_and_complex128():
    def prog(x):
        with stage("solve", CPU):
            return x * torch.tensor(2.0, dtype=torch.float64) + 1.0

    viols = NoDtypeAbove("float32").check(Program(prog, (torch.ones(4),)))
    assert viols and all(v.dtype == "float64" for v in viols)
    assert all(v.path[0] == "solve" for v in viols)
    cviols = NoDtypeAbove("float32").check(
        Program(lambda x: torch.fft.fft(x.double()), (torch.ones(4),)))
    assert any(v.dtype == "complex128" for v in cviols)
    assert not NoDtypeAbove("float32").check(
        Program(lambda x: torch.fft.fft(x) * 2.0, (torch.ones(4),)))
    assert not NoDtypeAbove("float32").check(
        Program(lambda x: (x * 2.0).to(torch.int64), (torch.ones(4),)))


def test_rule_no_host_sync_with_provenance():
    def prog(x):
        with stage("stream_fit", CPU):
            with stage("stream_fold", CPU):
                scale = float(x.sum())          # reads a value back to the host
        return x * scale

    viols = NoHostSync().check(Program(prog, (torch.ones(4),)))
    assert viols and viols[0].path == ("stream_fit", "stream_fold", "_local_scalar_dense")
    assert not NoHostSync(allow=("_local_scalar_dense",)).check(Program(prog, (torch.ones(4),)))
    viols = NoHostSync().check(Program(lambda x: torch.nonzero(x > 0), (torch.ones(4),)))
    assert viols and "nonzero" in viols[0].message
    assert not NoHostSync().check(Program(lambda x: torch.where(x > 0, x, 0.0),
                                          (torch.ones(4),)))


def test_rule_in_place_honored_detects_a_copy():
    g0, c0 = torch.zeros((2, 5, 5)), torch.zeros((2, 5, 1))
    x, y = torch.rand((2, 8, 5)), torch.rand((2, 8, 1))

    def fold_in_place(slab, xx, yy):
        return gram_ops.gram_accumulate_batched_into(slab[0], slab[1], xx, yy)

    def fold_copy(slab, xx, yy):
        return gram_ops.gram_accumulate_batched_into(slab[0].clone(), slab[1].clone(), xx, yy)

    rule = InPlaceHonored(min_into_calls=1)
    assert not rule.check(Program(fold_in_place, ((g0, c0), x, y), inplace_argnums=(0,)))
    viols = rule.check(Program(fold_copy, ((g0.clone(), c0.clone()), x, y),
                               inplace_argnums=(0,)))
    assert any("not in place" in v.message for v in viols)
    assert any("0 accumulate-into Gram calls" in v.message for v in viols)

    # without in-place arguments: every fold must go into one running G/c
    def running(xx, yy):
        g, c = torch.zeros((2, 5, 5)), torch.zeros((2, 5, 1))
        for t0 in (0, 4):
            g, c = gram_ops.gram_accumulate_batched_into(g, c, xx[:, t0:t0 + 4],
                                                         yy[:, t0:t0 + 4])
        return g, c

    def reallocating(xx, yy):
        g, c = torch.zeros((2, 5, 5)), torch.zeros((2, 5, 1))
        for t0 in (0, 4):
            g, c = gram_ops.gram_accumulate_batched_into(g.clone(), c.clone(),
                                                         xx[:, t0:t0 + 4], yy[:, t0:t0 + 4])
        return g, c

    assert not InPlaceHonored(min_into_calls=2).check(Program(running, (x, y)))
    assert InPlaceHonored(min_into_calls=2).check(Program(reallocating, (x, y)))


def test_rule_no_silent_upcast():
    b, chunk, n = 2, 32, 16

    def bad(x):
        with stage("stream_fold", CPU):
            return (x.to(torch.float32) * 2.0).sum()

    def good(x):
        return (x * 2.0)[:, :, :1].to(torch.float32).sum()

    arr = torch.ones((b, chunk, n), dtype=torch.bfloat16)
    rule = NoSilentUpcast(chunk, b * chunk * n)
    viols = rule.check(Program(bad, (arr,)))
    assert viols and viols[0].dtype == "float32" and viols[0].path[0] == "stream_fold"
    assert not rule.check(Program(good, (arr,)))


def _copy_program(shape, dtype, tile):
    """The block-copy fixture kernel on a ``shape`` array, ``tile`` a block."""
    return Program(lambda x: copy_ops.block_copy(x, tile), (torch.zeros(shape, dtype=dtype),))


def test_rule_smem_budget_overflow():
    # one 8 MiB f32 tile: above the 227 KB of shared memory a block may use;
    # the plain version copies it all the same, the card would refuse it
    prog = _copy_program((2048, 1024), torch.float32, (2048, 1024))
    viols = SmemBudget().check(prog)
    assert viols and "shared memory" in viols[0].message
    assert viols[0].path == ("block_copy",)
    assert not SmemBudget(limit_bytes=64 * 2 ** 20).check(prog)
    assert not SmemBudget().check(_copy_program((2048, 1024), torch.float32, (32, 256)))


def test_rule_smem_alignment_multi_tile():
    """A multi-tile block whose row is not whole 16-byte chunks (8 bytes of
    bf16) cannot be staged by 16-byte copies; 16-byte rows, f32 at the same
    geometry and a single-tile block are fine."""
    bad = _copy_program((32, 256), torch.bfloat16, (16, 4))
    viols = SmemBudget().check(bad)
    assert viols and "16-byte" in viols[0].message
    assert not SmemBudget().check(_copy_program((32, 256), torch.bfloat16, (16, 8)))
    assert not SmemBudget().check(_copy_program((32, 256), torch.float32, (16, 4)))
    assert not SmemBudget().check(_copy_program((3, 5), torch.bfloat16, (3, 5)))
    assert not SmemBudget(check_alignment=False).check(bad)


def test_rule_smem_budget_reads_the_scan_plan_on_the_cpu():
    """K1 above its node limit runs on the CPU (its plain version) but is
    flagged: its carry rows would not fit a block's shared memory."""
    n = scan_ops.max_nodes(False) + 8
    mask = make_mask(n, seed=0)
    prog = Program(lambda j: scan_ops.dfr_scan(SiliconMR(), j, mask, torch.zeros((1, n))),
                   (torch.rand((1, 2)),))
    viols = SmemBudget().check(prog)
    assert prog.error is None and viols and "dfr_scan" in viols[0].message
    with pytest.raises(ValueError, match="exceeds its limit"):
        scan_ops.scan_layout(1, n, False)


@pytest.mark.parametrize("shape,dtype,tile", [((37, 101), torch.float32, (8, 33)),
                                              ((32, 256), torch.bfloat16, (16, 8))])
def test_block_copy_plain_copies_tile_by_tile(shape, dtype, tile):
    x = torch.randn(shape).to(dtype)
    before = (copy_ops.block_copy.launches, copy_ops.block_copy.calls)
    out = copy_ops.block_copy(x, tile)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert (copy_ops.block_copy.launches, copy_ops.block_copy.calls) == (before[0],
                                                                         before[1] + 1)
    assert copy_ops.copy_plan(shape, dtype, tile)["smem_bytes"] == tile[0] * tile[1] * (
        x.element_size())
    with pytest.raises(ValueError, match="2-D"):
        copy_ops.block_copy(x[0], tile)


# ---------------------------------------------------------------------------
# registry: the port's entries against the reference's
# ---------------------------------------------------------------------------


def _port_names():
    from repro_torch.analysis.registry import entry_point_names
    return entry_point_names()


def test_registry_names_are_the_references_but_the_lm_step():
    """Every reference entry has its port, the LM train step included."""
    from repro.analysis.registry import entry_point_names as ref_names
    assert len(_port_names()) == 20
    assert set(ref_names()) - set(_port_names()) == set()
    assert set(_port_names()) == set(ref_names())


@pytest.mark.parametrize("name", _port_names())
def test_registry_entry_holds_its_rules_in_both_packages(name):
    """The port's entry runs on the CPU and holds every rule; the
    reference's entry of the same name holds each of its rules, evaluated
    one at a time, except VmemBudget: under jax 0.9.0 the reference's
    VmemBudget dies at src/repro/analysis/rules.py:385 (int(block_shape[-1])
    receives a Blocked object), so the reference's own gate cannot evaluate
    an entry that carries it."""
    from repro.analysis.registry import ENTRY_POINTS as REF
    from repro.analysis.rules import VmemBudget
    from repro_torch.analysis.registry import ENTRY_POINTS

    program, rules = ENTRY_POINTS[name].build(CPU)
    for rule in rules:
        assert not rule.check(program), (rule.describe(), rule.check(program))
    assert program.error is None, program.error
    ref_program, ref_rules = REF[name].build()
    for rule in ref_rules:
        if isinstance(rule, VmemBudget):
            continue
        assert not rule.check(ref_program), (rule.describe(), rule.check(ref_program))


def test_seeded_violation_is_flagged_by_both():
    from repro.analysis.registry import seeded_violation_entry as ref_seeded
    from repro_torch.analysis.registry import _B, _N, _T_TR, seeded_violation_entry

    program, rules = seeded_violation_entry().build(CPU)
    viols = [v for r in rules for v in r.check(program)]
    assert viols and all(v.rule == "NoStateTensor" for v in viols)
    assert any(sorted(v.shape) == sorted((_B, _T_TR, _N)) and v.path[0] == "states_train"
               for v in viols)
    ref_program, ref_rules = ref_seeded().build()
    ref_viols = [v for r in ref_rules for v in r.check(ref_program)]
    assert any(sorted(v.shape) == sorted((_B, _T_TR, _N)) for v in ref_viols)


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------


def test_cli_entry_point_ok_and_report(tmp_path):
    from repro_torch.analysis.cli import main
    out = tmp_path / "report.json"
    assert main(["--device", "cpu", "--entry-point", "session_step_kernel",
                 "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["n_violations"] == 0
    assert report["device"] == "cpu" and report["torch_version"] == torch.__version__
    (entry,) = report["entry_points"]
    assert entry["name"] == "session_step_kernel" and entry["rules"]
    assert entry["kernel_calls"] == {"dfr_scan": 1, "ridge_gram_into": 1, "readout_apply": 1}


def test_cli_seeded_violation_exits_nonzero(tmp_path):
    from repro_torch.analysis.cli import main
    out = tmp_path / "report.json"
    assert main(["--device", "cpu", "--seed-violation", "--entry-point", "seeded_violation",
                 "--out", str(out)]) == 1
    report = json.loads(out.read_text())
    assert not report["ok"]
    (entry,) = report["entry_points"]
    viols = [v for r in entry["rules"] for v in r["violations"]]
    assert viols and all(v["rule"] == "NoStateTensor" for v in viols)
    assert all(v["path"][0] == "states_train" for v in viols)


def test_cli_reports_a_broken_entry_without_crashing(tmp_path, monkeypatch):
    from repro_torch.analysis import cli, registry

    def broken(device):
        raise RuntimeError("does not build")

    monkeypatch.setitem(registry.ENTRY_POINTS, "session_step",
                        registry.EntryPoint("session_step", "broken", broken))
    report = cli.run(["session_step"], device="cpu")
    (entry,) = report["entry_points"]
    assert not entry["ok"] and "does not build" in entry["error"]


def test_cli_unknown_entry_point_rejected_and_list(capsys):
    from repro_torch.analysis.cli import main
    with pytest.raises(KeyError, match="bogus"):
        main(["--device", "cpu", "--entry-point", "bogus", "--out", "/dev/null"])
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == _port_names()


def test_cli_defaults_to_cuda_and_raises_without_it():
    from repro_torch.analysis.cli import run
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        run(["session_step"])


def test_pipeline_introspect_shim_reexports():
    from repro_torch.analysis import tracer
    from repro_torch.pipeline import introspect
    for name in ("trace_program", "intermediate_shapes", "max_intermediate_bytes",
                 "state_tensor_bytes", "count_kernel_calls"):
        assert getattr(introspect, name) is getattr(tracer, name)
    assert np.isclose(introspect.max_intermediate_bytes(
        introspect.trace_program(lambda x: x * 2.0, torch.ones(8))), 32)
