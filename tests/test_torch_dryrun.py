"""The port's dry run and cost calibration (``launch/dryrun.py``,
``launch/calibrate.py``) on one rank of a fake 16 × 16 process group, on
``meta`` tensors.

* The ring formulas equal the reference's ``collective_bytes`` on one HLO
  line a kind (exact: the same arithmetic).
* A reduced config's train step holds, on its rank, exactly the shard
  bytes the reference's specs imply for the state (params and both f32
  moments, each leaf over the product of its spec's axes), beside the
  global batch the step is handed; its output is the same shards and the
  metrics; its gradients come back by reduce-scatter beside the
  all-gathers and all-reduces.
* The serving cells (prefill_32k, decode_32k, and long_500k for a
  subquadratic arch) hold, on their rank, exactly the bytes the
  reference's ``param_pspecs`` and ``cache_pspecs`` imply for the params
  and the decode cache, beside the rank's rows of the tokens (and
  context); a decode cell all-reduces over "model".
* Eager counting under-counts nothing, so the calibration variants'
  solved total equals the direct count (exact up to float rounding of the
  sums: 1e-12 relative).
* K1 and K1ᵀ run on ``meta`` through their operators' fake shapes.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro.parallel import sharding as jsharding
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.core import SiliconMR
from repro_torch.kernels.dfr_scan import ops as scan_ops
from repro_torch.launch import calibrate, dryrun
from repro_torch.models.model import meta_params
from repro_torch.optim.adamw import tree_leaves_with_path
from repro_torch.parallel import sharding

_HLO = {
    "all-reduce": "%a = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %x), "
                  "replica_groups={{0,1,2,3}}, to_apply=%add",
    "all-gather": "%b = bf16[32,256]{1,0} all-gather(bf16[2,256]{1,0} %y), "
                  "replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}",
    "reduce-scatter": "%c = f32[16]{0} reduce-scatter(f32[64]{0} %z), "
                      "replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add",
    "all-to-all": "%d = s32[8,8]{1,0} all-to-all(s32[8,8]{1,0} %w), "
                  "replica_groups={{0,1}}, dimensions={0}",
    "collective-permute": "%e = f32[3,5]{1,0} collective-permute(f32[3,5]{1,0} %v), "
                          "source_target_pairs={{0,1},{1,0}}",
}
_EVENTS = {"all-reduce": (64 * 128 * 4, 4), "all-gather": (32 * 256 * 2, 16),
           "reduce-scatter": (16 * 4, 4), "all-to-all": (8 * 8 * 4, 2),
           "collective-permute": (3 * 5 * 4, 2)}


@pytest.mark.parametrize("kind", list(_HLO))
def test_ring_formulas_equal_the_references(kind):
    want = jdryrun.collective_bytes(_HLO[kind] + "\n")
    r, n = _EVENTS[kind]
    got = dryrun.collective_bytes([{"kind": kind, "bytes": r, "group": n}])
    assert got[kind] == want[kind] and got["total"] == want["total"]
    assert got["counts"] == want["counts"] == {kind: 1}


def test_ring_formulas_sum_every_kind_and_refuse_an_unknown_one():
    text = "\n".join(_HLO.values()) + "\n"
    events = [{"kind": k, "bytes": r, "group": n} for k, (r, n) in _EVENTS.items()]
    assert dryrun.collective_bytes(events)["total"] == jdryrun.collective_bytes(text)["total"]
    assert dryrun.collective_bytes([{"kind": "broadcast", "bytes": 8, "group": 4}])[
        "broadcast"] == 6.0
    with pytest.raises(ValueError, match="unknown"):
        dryrun.collective_bytes([{"kind": "gossip", "bytes": 1, "group": 2}])


def _reduced(arch, get):
    return dataclasses.replace(get(arch), n_layers=2 * len(get(arch).unit), microbatches=2)


def _shard_bytes(jcfg, mesh) -> int:
    """Per-rank bytes of params + m + v under the reference's specs."""
    specs = jsharding.param_pspecs(jcfg, mesh)
    shapes = jdryrun.jax.eval_shape(
        lambda: __import__("repro.models", fromlist=["init_params"]).init_params(
            jcfg, jdryrun.jax.random.PRNGKey(0)))
    leaves = jdryrun.jax.tree_util.tree_leaves(shapes)
    spec_leaves = jdryrun.jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jdryrun.jax.sharding.PartitionSpec))
    total = 0
    for sh, sp in zip(leaves, spec_leaves, strict=True):
        n = 1
        for entry in sp:
            for a in (entry if isinstance(entry, tuple) else ((entry,) if entry else ())):
                n *= mesh.shape[a]
        total += 3 * 4 * int(np.prod(sh.shape)) // n
    return total


@pytest.mark.parametrize("arch", ["reservoir_lm", "qwen3-moe-30b-a3b", "seamless-m4t-medium"])
def test_dry_run_holds_the_shard_bytes_the_references_specs_imply(arch):
    cfg, jcfg = _reduced(arch, get_config), _reduced(arch, jget_config)
    rec = dryrun.measure(cfg, "train_4k", "pod")
    info = SHAPES["train_4k"]
    batch = 2 * info["batch"] * info["seq"] * 4
    if cfg.n_context_tokens:
        batch += info["batch"] * cfg.n_context_tokens * cfg.d_context * 4
    state = _shard_bytes(jcfg, abstract_mesh((16, 16), ("data", "model"))) + 4
    assert rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] == state + batch
    assert rec["memory"]["output_bytes"] == state + 7 * 4      # the step's 7 f32 metrics
    assert rec["memory"]["temp_bytes"] is None
    assert rec["flops"] > 0 and rec["collectives"]["total"] > 0
    assert set(rec["collectives"]["counts"]) == {"all-gather", "all-reduce", "reduce-scatter"}


def _spec_blocks(spec, mesh) -> int:
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else ((entry,) if entry else ())):
            n *= mesh.shape[a]
    return n


def _local_bytes(shapes, specs, mesh) -> int:
    """Per-rank bytes of a tree of shapes under a spec tree."""
    jax = jdryrun.jax
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return sum(int(np.prod(sh.shape)) * sh.dtype.itemsize // _spec_blocks(sp, mesh)
               for sh, sp in zip(leaves, spec_leaves, strict=True))


@pytest.mark.parametrize("arch,shape", [("granite-8b", "prefill_32k"),
                                        ("granite-8b", "decode_32k"),
                                        ("qwen3-moe-30b-a3b", "decode_32k"),
                                        ("seamless-m4t-medium", "prefill_32k"),
                                        ("jamba-v0.1-52b", "long_500k")])
def test_serving_cells_hold_the_shard_bytes_the_references_specs_imply(arch, shape):
    jax = jdryrun.jax
    from repro.models import init_cache as jinit_cache
    from repro.models import init_params as jinit_params

    cfg, jcfg = _reduced(arch, get_config), _reduced(arch, jget_config)
    rec = dryrun.measure(cfg, shape, "pod")
    mesh = abstract_mesh((16, 16), ("data", "model"))
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]
    rows = b // 16 if b % 16 == 0 else b
    params = _local_bytes(jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0))),
                          jsharding.param_pspecs(jcfg, mesh), mesh)
    want = params + rows * (1 if info["kind"] == "decode" else s) * 4
    if info["kind"] == "prefill" and cfg.n_context_tokens:
        want += rows * cfg.n_context_tokens * (cfg.d_context or cfg.d_model) * 4
    if info["kind"] == "decode":
        cache = jax.eval_shape(lambda: jinit_cache(jcfg, b, s,
                                                   context_len=jcfg.n_context_tokens))
        want += _local_bytes(cache["units"], jsharding.cache_pspecs(jcfg, mesh, cache)["units"],
                             mesh)
        assert rec["collective_axes"]["all-reduce"].get("model", 0) > 0
    assert rec["memory"]["argument_bytes"] == want
    assert rec["flops"] > 0 and rec["memory"]["output_bytes"] > 0


def _calib_cfg(arch):
    sc = smoke_config(arch)
    return dataclasses.replace(
        sc, d_model=256, d_context=0, vocab_size=512, n_heads=16,
        n_kv_heads=16 if sc.n_kv_heads == sc.n_heads else 8, d_ff=512 if sc.d_ff else 0,
        moe_d_ff=256 if sc.n_experts else 0, n_experts=16 if sc.n_experts else 0,
        microbatches=2, n_layers=3 * len(sc.unit), max_seq_len=32768)


@pytest.mark.parametrize("arch,shape", [("reservoir_lm", "train_4k"),
                                        ("qwen3-moe-30b-a3b", "train_4k"),
                                        ("seamless-m4t-medium", "train_4k"),
                                        ("qwen3-moe-30b-a3b", "prefill_32k"),
                                        ("seamless-m4t-medium", "decode_32k")])
def test_calibrated_total_equals_the_direct_count(arch, shape):
    cfg = _calib_cfg(arch)
    kind = SHAPES[shape]["kind"]
    b_mb = SHAPES[shape]["batch"] // cfg.microbatches if kind == "train" else None

    def measured(units, microbatches, enc_layers, batch_scale):
        v = calibrate._variant(cfg, units=units, microbatches=microbatches,
                               enc_layers=enc_layers)
        return calibrate._measure(v, shape, "pod",
                                  batch=None if b_mb is None else batch_scale * b_mb)

    rec = calibrate.solve(cfg, kind, measured)
    direct = dryrun.measure(cfg, shape, "pod")
    assert rec["total"]["flops"] == pytest.approx(direct["flops"], rel=1e-12)
    assert rec["total"]["coll"] == pytest.approx(direct["collectives"]["total"], rel=1e-12)
    assert rec["unit"]["flops"] > 0


def test_cli_writes_a_cell_and_reads_it_back(tmp_path, capsys):
    argv = ["--arch", "reservoir_lm", "--shape", "decode_32k", "--out-dir", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "reservoir_lm__decode_32k__pod.json").read_text())
    assert rec["n_devices"] == 256 and rec["memory"]["temp_bytes"] is None
    assert "ok flops=" in capsys.readouterr().out
    assert dryrun.run_cell("reservoir_lm", "decode_32k", "pod", out_dir=tmp_path) == rec


def test_scan_kernels_run_on_meta_through_their_operators():
    j = torch.empty(6, 10, device="meta")
    mask = torch.empty(16, device="meta")
    s0 = torch.empty(6, 16, device="meta")
    calls, launches = scan_ops.dfr_scan.calls, scan_ops.dfr_scan.launches
    states, fin = scan_ops.dfr_scan(SiliconMR(), j, mask, s0, return_final=True,
                                    out_dtype=torch.bfloat16)
    assert (states.shape, states.dtype, states.device.type) == ((6, 10, 16), torch.bfloat16,
                                                                "meta")
    assert (fin.shape, fin.dtype) == ((6, 16), torch.float32)
    assert scan_ops.dfr_scan.calls == calls + 1 and scan_ops.dfr_scan.launches == launches
    dj, ds0 = scan_ops.dfr_scan_grad(SiliconMR(), j, mask, s0, states.float(),
                                     states.float(), fin)
    assert (dj.shape, ds0.shape, dj.dtype) == ((6, 10), (6, 16), torch.float32)
    # the operators have kernels on the card only: a CPU tensor takes the plain route
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.dfr_scan(torch.zeros(2, 3), torch.zeros(4), torch.zeros(2, 4),
                                       0, [1.0], False)


def _train_flops(cfg, specs, mesh_shape=None):
    """FlopCounterMode's count of one train step on ``meta`` tensors: on one
    process, or on rank 0 of a fake group of ``mesh_shape``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import train_step

    if mesh_shape is None:
        with FlopCounterMode(display=False) as fc:
            train_step(cfg, AdamWConfig(), dryrun._meta_state(cfg), specs)
        return fc.get_total_flops()
    with dryrun.fake_world(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
        fn, args = dryrun.build_step(cfg, "train_4k", mesh, specs=specs)
        with FlopCounterMode(display=False) as fc:
            fn(*args)
        return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["reservoir_lm", "granite-8b"])
def test_a_train_cells_flops_a_rank_exclude_the_work_tensor_parallelism_moves(arch):
    """A train step's counted FLOPs on a rank of (1, 2) at smoke size are at
    most half of one process's tensor-parallel products plus the whole of
    the rest.  The tensor-parallel products come from the leaf shapes: each
    leaf the plan keeps as its "model" block (``use_pspecs``) takes part in
    one product a token, forward and the backward's two, 6·T·numel FLOPs
    (the embedding as the tied logits' table, or the untied head; its
    lookup counts none)."""
    cfg = dataclasses.replace(smoke_config(arch), microbatches=2)
    tokens = (4, 16)
    specs = {"tokens": torch.empty(tokens, dtype=torch.int32, device="meta"),
             "labels": torch.empty(tokens, dtype=torch.int32, device="meta")}
    one = _train_flops(cfg, specs)
    rank = _train_flops(cfg, specs, (1, 2))
    uses = sharding.use_pspecs(cfg, sharding.AbstractMesh((1, 2), ("data", "model")))
    t = tokens[0] * tokens[1]
    tp = sum(6 * t * leaf.numel() for (path, leaf), use in
             zip(tree_leaves_with_path(meta_params(cfg)), sharding.spec_leaves(uses),
                 strict=True)
             if any(use) and (cfg.tie_embeddings or path != "['embed']['embedding']"))
    assert tp > 0 and rank < one
    assert rank <= one - tp / 2, (rank, one, tp)
