"""The port's distribution code on several gloo ranks on the CPU: shards,
the compressed pod reduction, GPipe, expert parallelism, elastic
checkpoints, the Experiment and the Gram over a mesh, and the multi-rank
launcher.

Each multi-rank case spawns its ranks with ``launch.mesh.run_ranks`` (a
``file://`` store under ``tmp_path``, one intra-op thread a rank, a 120 s
limit on the run, so a hang fails the test).  The ranks get numpy inputs
and hand back numpy results; the JAX package's side runs here, in the
test's process.  Tolerances:

* shard then gather is the identity, bitwise;
* ``compressed_psum`` within 1e-6 of the reference's under
  ``jax.vmap(axis_name="pod")``, gradient and error state: the same int8
  codes and scales, summed in another order;
* ``pipeline_apply`` within 1e-5 of the sequential fold, the reference's
  own bar (tests/test_parallel_multidev.py);
* the expert-parallel MoE block (a train plan's: this rank's experts'
  block) within 1e-6 (f32 round-off of O(1) values: the k slots summed in
  another order) of the dense route, output and gradients (the experts'
  for the rank's block), and within the MoE tests' 2e-6 of the
  reference;
* checkpoints re-laid out bitwise;
* ``Experiment`` over two ranks within 1e-4 NRMSE of one process, the
  reference's own tolerance for its sharded run.
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import moe as jmoe
from repro.optim import compression as jcompression
from repro_torch.configs import smoke_config
from repro_torch.core import SiliconMR, tasks
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import moe
from repro_torch.optim import compression
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import pipeline, sharding
from repro_torch.parallel.sharding import P

MOE_ARCH = "qwen3-moe-30b-a3b"


def _run(fn, world, tmp_path, *args):
    return run_ranks(fn, world, store_dir=str(tmp_path), args=args, timeout=120)


def _cpu_mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, device_type="cpu")


# ---------------------------------------------------------------------------
# shard / gather
# ---------------------------------------------------------------------------

SPECS = [P(("data", "model")), P(("model", "data")), P("data", "model"),
         P(None, ("data", "model")), P(None, None, "model"), P()]


def _shard_gather_rank(rank):
    mesh = _cpu_mesh((2, 2))
    full = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    out = []
    for spec in SPECS:
        local = sharding.shard(full, spec, mesh)
        out.append((local, sharding.gather(local, spec, mesh),
                    sharding.coordinate(mesh, "data"), sharding.coordinate(mesh, "model")))
    return out


def test_shard_then_gather_is_the_identity_on_a_2x2_world(tmp_path):
    full = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    for rank, got in enumerate(_run(_shard_gather_rank, 4, tmp_path)):
        for spec, (local, back, d, m) in zip(SPECS, got):
            np.testing.assert_array_equal(back, full)
            # a multi-axis entry is cut row-major in the entry's order
            if spec == P(("data", "model")):
                np.testing.assert_array_equal(local, full[2 * (2 * d + m):][:2])
            if spec == P(("model", "data")):
                np.testing.assert_array_equal(local, full[2 * (2 * m + d):][:2])
            if spec == P("data", "model"):
                np.testing.assert_array_equal(local, full[4 * d:4 * d + 4, 2 * m:2 * m + 2])
            if spec == P():
                np.testing.assert_array_equal(local, full)
        assert (d, m) == divmod(rank, 2)


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


def _compressed_rank(rank, g, err, tree):
    mesh = _cpu_mesh((4,), ("pod",))
    with sharding.use_mesh(mesh), sharding.record_collectives() as events:
        g_hat, new_err = compression.compressed_psum(torch.as_tensor(g[rank]),
                                                     torch.as_tensor(err[rank]), "pod")
        tg, te = compression.tree_compressed_psum(
            {k: torch.as_tensor(v[rank]) for k, v in tree.items()},
            {k: torch.zeros(v.shape[1:]) for k, v in tree.items()}, "pod")
    return g_hat, new_err, tg, te, [(e["kind"], e["bytes"]) for e in events[:2]]


def test_compressed_psum_matches_the_reference_over_four_ranks(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 64, 37), dtype=np.float32)
    err = (1e-3 * rng.standard_normal((4, 64, 37))).astype(np.float32)
    tree = {"b": rng.standard_normal((4, 300), dtype=np.float32),
            "a": rng.standard_normal((4, 5, 7), dtype=np.float32)}
    j_g, j_err = jax.vmap(lambda a, b: jcompression.compressed_psum(a, b, "pod"),
                          axis_name="pod")(jnp.asarray(g), jnp.asarray(err))
    jt_g, jt_err = jax.vmap(lambda t, e: jcompression.tree_compressed_psum(t, e, "pod"),
                            axis_name="pod")(jax.tree.map(jnp.asarray, tree),
                                             jax.tree.map(jnp.zeros_like, tree))
    for rank, (g_hat, new_err, tg, te, events) in enumerate(_run(
            _compressed_rank, 4, tmp_path, g, err, tree)):
        np.testing.assert_allclose(g_hat, np.asarray(j_g[rank]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(new_err, np.asarray(j_err[rank]), atol=1e-6, rtol=0)
        for k in tree:
            np.testing.assert_allclose(tg[k], np.asarray(jt_g[k][rank]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(te[k], np.asarray(jt_err[k][rank]), atol=1e-6, rtol=0)
        # the int8 codes are what crosses: one byte an element, a block of 256 a scale
        blocks = -(-64 * 37 // 256)
        assert events == [("all-gather", 4 * blocks * 256), ("all-gather", 4 * blocks * 4)]
    exact = g.mean(0)
    assert np.linalg.norm(g_hat - exact) / np.linalg.norm(exact) < 0.02


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def _pipeline_rank(rank, w, x):
    mesh = pipeline.make_stage_mesh(4, device_type="cpu")
    with sharding.record_collectives() as events:
        out = pipeline.pipeline_apply(_stage_fn, {"w": torch.as_tensor(w[rank])},
                                      torch.as_tensor(x), mesh=mesh)
    return out, [e["kind"] for e in events]


def test_pipeline_apply_matches_the_sequential_fold_over_four_ranks(tmp_path):
    s, m, d = 4, 6, 16
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((s, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((m, 3, d), dtype=np.float32)
    ref = jnp.asarray(x)
    for i in range(s):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    for rank, (out, kinds) in enumerate(_run(_pipeline_rank, 4, tmp_path, w, x)):
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)
        # T = M + S - 1 ticks, a send on every stage but the last
        assert kinds.count("collective-permute") == (m + s - 1 if rank < s - 1 else 0)
        assert kinds[-1] == "broadcast"


def test_make_stage_mesh_puts_the_stages_on_the_cards_by_default():
    # as launch.mesh.make_mesh: an entry point runs on the card unless the
    # caller asks for the CPU, and nothing falls back to it
    default = inspect.signature(pipeline.make_stage_mesh).parameters["device_type"].default
    assert default == "cuda"
    assert default == inspect.signature(make_mesh).parameters["device_type"].default


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(shape[-2]))
            for name, (shape, _axes, _init) in sorted(moe.moe_defs(cfg).items())}


def _moe_grads(cfg, p, x, r, plan=None):
    """y, aux and the gradients of sum(y · r) + aux w.r.t. x and each param."""
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_(True)
    y, aux = moe.apply_moe(cfg, tp, tx, plan=plan)
    names = sorted(tp)
    grads = torch.autograd.grad((y * torch.as_tensor(r)).sum() + aux, [tx] + [tp[k] for k in names])
    return y.detach(), float(aux.detach()), dict(zip(["x"] + names, grads))


def _moe_rank(rank, p, x, r):
    """The block on this rank of a train plan over (1, 2): the router whole
    (as the plan gathers it), the experts this rank's E/2 block; and
    whether a zero3 plan, whose rows "model" cuts, keeps any "model"
    block."""
    cfg = smoke_config(MOE_ARCH)
    mesh = _cpu_mesh((1, 2))
    plan = sharding.Plan(cfg, mesh, train=True, rows=x.shape[0])
    e_loc = cfg.n_experts // plan.tp
    own = slice(plan.tp_rank * e_loc, (plan.tp_rank + 1) * e_loc)
    local = {k: v if k == "router" else v[own] for k, v in p.items()}
    with sharding.record_collectives() as events:
        out = _moe_grads(cfg, local, x, r, plan)
    zero3 = sharding.Plan(dataclasses.replace(cfg, strategy="zero3"), mesh, train=True,
                          rows=x.shape[0] * 2)
    keeps = any(e for use in zero3.uses["units"][0].values() for e in use)
    return out, [e["kind"] for e in events], (zero3.tp, keeps)


def test_expert_parallel_block_matches_the_dense_route_and_the_reference(tmp_path):
    cfg, jcfg = smoke_config(MOE_ARCH), jsmoke_config(MOE_ARCH)
    # the plan keeps the experts' "model" block where "model" divides E, else none
    for tp, expert in ((2, "model"), (3, None)):
        mesh = sharding.AbstractMesh((1, tp), ("data", "model"))
        uses = sharding.use_pspecs(cfg, mesh)["units"][0]
        assert uses["mlp/wi_gate"][1] == uses["mlp/wo"][1] == expert
        assert not any(uses["mlp/router"])
    p = _moe_params(cfg, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 12, cfg.d_model), dtype=np.float32)
    r = rng.standard_normal((3, 12, cfg.d_model), dtype=np.float32)
    y_dense, aux_dense, g_dense = _moe_grads(cfg, p, x, r)
    jy, jaux = jmoe.apply_moe(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    e_loc = cfg.n_experts // 2
    for rank, ((y, aux, grads), kinds, zero3) in enumerate(_run(_moe_rank, 2, tmp_path,
                                                                 p, x, r)):
        np.testing.assert_allclose(y, y_dense.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(y, np.asarray(jy), atol=2e-6, rtol=0)
        assert abs(aux - aux_dense) < 1e-7 and abs(aux - float(jaux)) < 1e-6
        for k, g in grads.items():
            want = g_dense[k].numpy()
            scale = float(np.abs(want).max())
            if k not in ("x", "router"):                     # this rank's experts' block
                want = want[rank * e_loc:(rank + 1) * e_loc]
            np.testing.assert_allclose(g, want, atol=1e-6 * scale, rtol=0, err_msg=k)
        # forward: one token-sized all-reduce (g); backward: the gradients of
        # the dispatched tokens and of the combine weights (f); the experts'
        # weights keep their blocks' gradients
        assert kinds == ["all-reduce"] * 3
        assert zero3 == (1, False)


# ---------------------------------------------------------------------------
# elastic checkpoints
# ---------------------------------------------------------------------------


def _ckpt_cfg():
    return dataclasses.replace(smoke_config("reservoir_lm"), n_layers=2)


def _ckpt_state(cfg):
    from repro_torch.runtime.steps import init_train_state

    state = init_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    for leaf in tree_leaves(state["opt"]):
        leaf.normal_(generator=torch.Generator().manual_seed(leaf.numel()))
    state["step"].fill_(7)
    return state


def _ckpt_rank(rank, directory, shape, save):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.runtime.steps import state_pspecs

    cfg = _ckpt_cfg()
    mesh = _cpu_mesh(shape)
    specs = state_pspecs(cfg, mesh)
    local = sharding.tree_shard(_ckpt_state(cfg), specs, mesh)
    store = CheckpointStore(directory)
    if save:
        store.save(7, local, sharding=(mesh, specs))
        return sorted(os.listdir(directory))
    template = sharding.tree_shard(_ckpt_state(dataclasses.replace(cfg)), specs, mesh)
    for leaf in tree_leaves(template):
        leaf.zero_()
    step, restored = store.restore(template, sharding=(mesh, specs))
    same_shapes = all(a.shape == b.shape for a, b in zip(tree_leaves(restored),
                                                         tree_leaves(local)))
    return step, same_shapes, sharding.tree_gather(restored, specs, mesh)


def test_checkpoint_saved_on_2x2_restores_bitwise_onto_1x4_and_unsharded(tmp_path):
    from repro_torch.checkpoint import CheckpointStore

    d = tmp_path / "ckpt"
    saved = _run(_ckpt_rank, 4, tmp_path, str(d), (2, 2), True)
    assert saved[0] == ["step_0000000007"]
    full = _ckpt_state(_ckpt_cfg())
    want = [t.numpy() for t in tree_leaves(full)]
    for step, same_shapes, gathered in _run(_ckpt_rank, 4, tmp_path, str(d), (1, 4), False):
        assert step == 7 and same_shapes
        for a, b in zip(tree_leaves(gathered), want, strict=True):
            np.testing.assert_array_equal(a, b)
    step, plain = CheckpointStore(d).restore(full, device="cpu")
    assert step == 7
    for a, b in zip(tree_leaves(plain), want, strict=True):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# Experiment and the Gram over a mesh
# ---------------------------------------------------------------------------


def _narma(b=4, length=360):
    ds = [tasks.narma10(length, seed=s) for s in range(b)]
    return tuple(np.stack([getattr(d, f) for d in ds])
                 for f in ("inputs_train", "targets_train", "inputs_test", "targets_test"))


def _exp_cfg(streamed):
    from repro_torch.pipeline import ExperimentConfig

    kw = dict(stream_chunk_k=64, state_noise_mode="diagonal") if streamed else {}
    return ExperimentConfig(model=SiliconMR(), n_nodes=16, washout=40,
                            ridge_l2=(1e-6, 1e-4), **kw)


def _experiment_rank(rank, batch, streamed):
    from repro_torch.pipeline import Experiment

    mesh = _cpu_mesh((2, 1))
    with sharding.use_mesh(mesh), sharding.record_collectives() as events:
        res = Experiment(_exp_cfg(streamed), device="cpu").run(*batch)
    return res.nrmse, res.lam, res.readout_w, sorted({e["kind"] for e in events})


@pytest.mark.parametrize("streamed", [False, True], ids=["materialized", "streamed"])
def test_experiment_over_two_ranks_equals_one_process(tmp_path, streamed):
    """Sampled digitiser noise on (materialized): the noise is drawn at the
    whole batch's shape and cut, so the ranks draw what one process draws."""
    from repro_torch.pipeline import Experiment

    batch = _narma()
    one = Experiment(_exp_cfg(streamed), device="cpu").run(*batch)
    assert np.all(one.nrmse < 1.0)
    for nrmse, lam, w, kinds in _run(_experiment_rank, 2, tmp_path, batch, streamed):
        np.testing.assert_allclose(nrmse, one.nrmse, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(lam, one.lam)
        np.testing.assert_allclose(w, one.readout_w, atol=1e-3 * np.abs(one.readout_w).max())
        assert kinds == ["all-gather"]


def _gram_rank(rank, x, y):
    from repro_torch.pipeline import ridge

    with sharding.use_mesh(_cpu_mesh((2, 1))):
        return ridge.gram(torch.as_tensor(x), torch.as_tensor(y))


def test_gram_splits_the_samples_over_the_data_ranks(tmp_path):
    from repro_torch.kernels.ridge_gram.ref import gram_ref

    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 9), dtype=np.float32)
    y = rng.standard_normal((64, 2), dtype=np.float32)
    g, c = gram_ref(torch.as_tensor(x), torch.as_tensor(y))
    for gg, cc in _run(_gram_rank, 2, tmp_path, x, y):
        np.testing.assert_allclose(gg, g.numpy(), atol=1e-5 * float(g.abs().max()))
        np.testing.assert_allclose(cc, c.numpy(), atol=1e-5 * float(c.abs().max()))


def test_experiment_under_a_mesh_refuses_what_it_does_not_split():
    """WDM ensembles split over a mesh's ranks
    (tests/test_torch_parallel_dfrc.py); a shape-only mesh holds no rank to
    split them over, and the run refuses it rather than run whole."""
    from repro_torch.pipeline import WDMExperiment

    mesh = sharding.AbstractMesh((2, 1), ("data", "model"))
    with sharding.use_mesh(mesh), pytest.raises(TypeError, match="DeviceMesh"):
        WDMExperiment(_exp_cfg(False), n_channels=2, device="cpu").run(*_narma(2, 200))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--batch", "4", "--seq", "16", "--d-model", "64",
              "--layers", "1", "--vocab", "128", "--checkpoint-every", "2"]


def _launch_rank(rank, directory, steps):
    from repro_torch.launch import train

    os.environ.update(RANK=str(rank), WORLD_SIZE="2")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(TRAIN_ARGS + ["--steps", "1", "--checkpoint-dir", directory + "x",
                                 "--production-mesh"])
    hist = train.main(TRAIN_ARGS + ["--steps", str(steps), "--checkpoint-dir", directory])
    return [h["loss"] for h in hist]


def test_launcher_trains_on_two_ranks_and_resumes_on_one(tmp_path, capsys):
    from repro_torch.launch import train

    d = str(tmp_path / "ckpt")
    losses = _run(_launch_rank, 2, tmp_path, d, 3)
    assert losses[0] == losses[1]
    # one process trains the same steps (the debug mesh (1, 2) splits no rows)
    one = train.main(TRAIN_ARGS + ["--steps", "3", "--checkpoint-dir",
                                   str(tmp_path / "one")])
    np.testing.assert_allclose(losses[0], [h["loss"] for h in one], atol=1e-5, rtol=0)
    # and resumes the two ranks' checkpoint, saved once, gathered
    resumed = train.main(TRAIN_ARGS + ["--steps", "4", "--checkpoint-dir", d])
    assert [h["step"] for h in resumed] == [3]
    assert "steps=1" in capsys.readouterr().out.strip().splitlines()[-1]
