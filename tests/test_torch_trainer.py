"""The port's training driver and launcher (``repro_torch.runtime.trainer``,
``repro_torch.launch.train``) on the CPU, mirroring the JAX package's
tests/test_training.py: restart from the newest checkpoint, retry of a
step that raises, the straggler watchdog, and the launcher's CLI trained,
resumed and refused where it needs a mesh."""

import re

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.data import DataConfig
from repro_torch.launch import train
from repro_torch.runtime.trainer import (StragglerWatchdog, TrainLoopConfig, host_metrics,
                                         run_training)


def test_run_training_restart_and_retry(tmp_path):
    """The driver retries a step that raises a RuntimeError from the state
    it had, and a second run restores the last checkpoint and runs only the
    steps past it (tests/test_training.py:80)."""
    calls = {"n": 0, "fail_at": 3}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == calls["fail_at"]:
            raise RuntimeError("simulated preemption")
        assert batch["tokens"].shape == (2, 4)
        return {"step": state["step"] + 1, "w": state["w"] + 1.0}, {"loss": torch.tensor(1.0)}

    def init_fn():
        return {"step": torch.tensor(0), "w": torch.tensor(0.0)}

    data_cfg = DataConfig(vocab_size=8, seq_len=4, global_batch=2)
    loop = TrainLoopConfig(total_steps=6, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                           max_step_retries=2, log_every=0)
    state, history, _ = run_training(step_fn=step_fn, init_state_fn=init_fn,
                                     data_cfg=data_cfg, loop_cfg=loop, device="cpu")
    assert int(state["step"]) == 6 and float(state["w"]) == 6.0
    assert len(history) == 6 and calls["n"] == 7
    assert [h["step"] for h in history] == list(range(6))
    assert all(isinstance(h["loss"], float) for h in history)

    calls["fail_at"] = -1
    loop2 = TrainLoopConfig(total_steps=8, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                            log_every=0)
    state2, history2, _ = run_training(step_fn=step_fn, init_state_fn=init_fn,
                                       data_cfg=data_cfg, loop_cfg=loop2, device="cpu")
    assert isinstance(state2["w"], torch.Tensor)
    assert int(state2["step"]) == 8 and float(state2["w"]) == 8.0
    assert [h["step"] for h in history2] == [6, 7]


def test_run_training_surfaces_a_step_that_keeps_failing(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("persistent fault")

    loop = TrainLoopConfig(total_steps=2, checkpoint_dir=str(tmp_path), max_step_retries=1,
                           log_every=0)
    with pytest.raises(RuntimeError, match="persistent"):
        run_training(step_fn=step_fn, init_state_fn=lambda: {"w": torch.zeros(())},
                     data_cfg=DataConfig(vocab_size=8, seq_len=4, global_batch=2),
                     loop_cfg=loop)


def test_straggler_watchdog():
    w = StragglerWatchdog(factor=3.0)
    seen = []
    for i in range(10):
        w.observe(i, 0.1)
    w.observe(10, 1.0, on_straggler=lambda *a: seen.append(a))
    assert w.flagged and w.flagged[-1][0] == 10
    assert seen and seen[0][0] == 10
    w.observe(11, 0.2)
    assert len(w.flagged) == 1


def test_host_metrics_reads_every_metric_at_once():
    got = host_metrics({"loss": torch.tensor(2.5), "lr": torch.tensor(1e-3), "n": 3})
    assert got == {"loss": 2.5, "lr": pytest.approx(1e-3), "n": 3.0}
    assert all(isinstance(v, float) for v in got.values())


TINY = ["--device", "cpu", "--batch", "4", "--seq", "16", "--d-model", "64", "--layers", "1",
        "--vocab", "128", "--microbatches", "2"]


def test_launcher_trains_resumes_and_prints_the_references_line(tmp_path, capsys):
    argv = TINY + ["--checkpoint-dir", str(tmp_path)]
    hist = train.main(argv + ["--steps", "4"])
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["tokens"] == 64 for h in hist)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"arch=reservoir_lm steps=4 loss \d+\.\d{4} -> \d+\.\d{4} stragglers=0",
                        line), line
    resumed = train.main(argv + ["--steps", "6"])
    assert [h["step"] for h in resumed] == [4, 5]


def test_launcher_reduced_config_is_the_references():
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config

    args = train.argparse.Namespace(no_reduce=False, layers=2, d_model=128, vocab=256, seq=32,
                                    microbatches=2)
    for arch in ("reservoir_lm", "jamba-v0.1-52b", "qwen3-moe-30b-a3b"):
        got = train.reduced_config(get_config(arch), args)
        want = jtrain.reduced_config(jget_config(arch), args)
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                      "vocab_size", "n_experts", "top_k", "reservoir_nodes", "microbatches",
                      "dtype", "remat"):
            assert getattr(got, field) == getattr(want, field), (arch, field)
    args.no_reduce = True
    assert train.reduced_config(get_config("reservoir_lm"), args) == get_config("reservoir_lm")


def test_launcher_refuses_the_production_mesh_and_a_missing_card(tmp_path):
    """``--production-mesh`` needs 256 ranks: on one process it raises
    before it starts a process group (tests/test_torch_parallel.py runs it
    on two ranks)."""
    with pytest.raises(ValueError, match="needs 256 ranks; WORLD_SIZE is 1"):
        train.main(TINY + ["--production-mesh", "--checkpoint-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--steps", "1", "--checkpoint-dir", str(tmp_path)])
