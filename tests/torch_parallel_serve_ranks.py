"""The rank side of tests/test_torch_parallel_serve.py: a module that
imports torch and the port only, so each spawned rank starts without the
JAX package."""

import os

import torch

from repro_torch import configs, convert
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding
from repro_torch.runtime import steps


def _refuse(*_args, **_kw):
    raise AssertionError("the serving route gathered the whole param tree")


def serve_rank(rank, shape, cases, prompt, decodes, max_len):
    """Each case (arch, batch, numpy params, tokens, context) served on this
    rank of a ("data", "model") mesh of ``shape``: its param blocks, its
    rows, a prefill of ``prompt`` tokens then ``decodes`` decode steps,
    ``sharding.tree_gather`` refusing while it serves.  Returns a case its
    logits, the greedy ids of every row, the cache's block shapes, the
    cache gathered whole, the attention caches' sequence entries and the
    bytes the last decode step all-gathered."""
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    out = []
    for arch, batch, host, toks, ctx in cases:
        cfg = configs.smoke_config(arch)
        full = convert.lm_params_from_reference(host, device="cpu")
        local = sharding.tree_shard(full, sharding.param_pspecs(cfg, mesh), mesh)
        del full
        rows = sharding.serve_rows(torch.as_tensor(toks), mesh)
        rctx = None if ctx is None else sharding.serve_rows(torch.as_tensor(ctx), mesh)
        whole, sharding.tree_gather = sharding.tree_gather, _refuse
        try:
            with torch.no_grad(), sharding.use_mesh(mesh):
                logit, cache = steps.serve_prefill(cfg, local, rows[:, :prompt], rctx,
                                                   max_len=max_len, batch=batch)
                logits = [logit]
                shapes = [tuple(t.shape) for entry in cache["units"] for t in entry]
                for i in range(prompt, prompt + decodes):
                    with sharding.record_collectives() as events:
                        logit, cache = steps.serve_decode(cfg, local, cache, rows[:, i:i + 1])
                    logits.append(logit)
        finally:
            sharding.tree_gather = whole
        ids = torch.stack([lg.argmax(-1) for lg in logits], dim=1)
        full_ids = sharding.gather(ids, sharding.P(sharding.serve_batch_entry(mesh, batch)),
                                   mesh)
        out.append({"logits": logits, "ids": full_ids, "shapes": shapes,
                    "cache": sharding.tree_gather(cache["units"], cache["specs"]["units"],
                                                  mesh),
                    "seq_entries": [spec[0][2] for blk, spec in
                                    zip(cfg.unit, cache["specs"]["units"], strict=True)
                                    if blk.mixer in ("attn", "cross_attn")],
                    "gathered_bytes": sum(e["bytes"] for e in events
                                          if e["kind"] == "all-gather")})
    return out


def launch_rank(rank, argv):
    """``launch.serve.main(argv)`` on rank ``rank`` of two."""
    from repro_torch.launch import serve

    os.environ.update(RANK=str(rank), WORLD_SIZE="2")
    return serve.main(argv)
