"""Serving launcher: batched greedy prefill + decode of an LM.

Port of ``repro/launch/serve.py``: a batch of random prompts is prefilled
once, then decoded token by token with the batch's cache updated in place
(the reference donates it between steps).  Weights are drawn from a
``torch.Generator`` seeded with ``--seed``; the prompts from numpy's, and
for a cross-attention family (VLM, encoder-decoder) the stub context
[B, n_context_tokens, d_model] after them, as the reference's launcher
draws it (its frontends are stubs).  Every arch in ``configs.ARCHS``
serves.

One process serves on one card (or the CPU).  Launched on several ranks
(``torchrun``'s environment) it serves as the reference's launcher does,
on the debug mesh (1, WORLD_SIZE) ("data", "model"), or with
``--production-mesh`` on the 16 × 16 pod mesh (``launch.mesh.launch_mesh``:
NCCL for ranks on cards, gloo on the CPU or with ``--backend gloo``).  Every
rank draws the params and the prompts from the seed, keeps its blocks of
the params (``param_pspecs``) and its rows of the prompts
(``sharding.serve_rows``), and serves them tensor-parallel on its cache
blocks (``runtime.steps.serve_prefill`` under the mesh).  The greedy ids
are gathered over the batch axes, every rank's checked identical, and
rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --requests 8 --new-tokens 32            # on cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch jamba-v0.1-52b
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --device cpu --arch granite-8b
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params
from ..parallel import sharding
from ..runtime.steps import serve_decode, serve_prefill
from .mesh import launch_mesh


def reduced_config(cfg, d_model=128, layers=2, vocab=512):
    return dataclasses.replace(
        cfg,
        n_layers=layers * len(cfg.unit),
        d_model=d_model,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads != cfg.n_heads else 4,
        head_dim=32,
        d_ff=d_model * 4 if cfg.d_ff else 0,
        vocab_size=vocab,
        max_seq_len=4096,
        n_experts=min(8, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        moe_d_ff=d_model if cfg.n_experts else 0,
        n_encoder_layers=min(2, cfg.n_encoder_layers),
        n_context_tokens=8 if cfg.n_context_tokens else 0,
        d_context=0,
        reservoir_nodes=32,
        dtype="float32",
        remat="none",
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start(cfg, params, prompts: torch.Tensor, new_tokens: int, *, slack: int = 0,
          context: torch.Tensor | None = None, batch: int | None = None) -> dict:
    """Prefill ``prompts`` [B, P] (with ``context`` [B, T, d] for a
    cross-attention family) into a cache with room for ``new_tokens`` (and
    ``slack`` more decode steps) and take the first greedy token.  Under a
    mesh, ``params`` and ``prompts`` are this rank's blocks and rows of a
    global batch of ``batch`` rows (``serve_prefill``).

    Returns the served batch: ``ids`` and ``logits`` (a list of [B, 1] and
    [B, V] tensors, one a token), the ``cache``, ``prefill_s`` and
    ``decode_step_s`` (host wall, each ending in a device synchronise).
    """
    dev = prompts.device
    max_len = prompts.shape[1] + new_tokens + slack
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = serve_prefill(cfg, params, prompts, context, max_len=max_len, batch=batch)
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    return {"ids": [tok], "logits": [logits], "cache": cache,
            "prefill_s": time.perf_counter() - t0, "decode_step_s": []}


def decode(cfg, params, served: dict) -> None:
    """One greedy decode step of a served batch (``start``), in place.  No
    step reads a value back to the host."""
    tok = served["ids"][-1]
    _sync(tok.device)
    t0 = time.perf_counter()
    logits, served["cache"] = serve_decode(cfg, params, served["cache"], tok)
    served["ids"].append(torch.argmax(logits, dim=-1)[:, None])
    served["logits"].append(logits)
    _sync(tok.device)
    served["decode_step_s"].append(time.perf_counter() - t0)


def generate(cfg, params, prompts: torch.Tensor, new_tokens: int, *, slack: int = 0,
             context: torch.Tensor | None = None, batch: int | None = None) -> dict:
    """Greedy serving of ``prompts`` [B, P] (and ``context``): one prefill,
    then ``new_tokens - 1`` decode steps.  The served batch of ``start``,
    with ``ids`` [B, new_tokens] and ``logits`` [B, new_tokens, V] joined."""
    served = start(cfg, params, prompts, new_tokens, slack=slack, context=context, batch=batch)
    for _ in range(new_tokens - 1):
        decode(cfg, params, served)
    return joined(served)


def joined(served: dict) -> dict:
    """A served batch with its ``ids`` and ``logits`` joined over tokens."""
    return {**served, "ids": torch.cat(served["ids"], dim=1),
            "logits": torch.stack(served["logits"], dim=1)}


def gathered_ids(ids: torch.Tensor, batch: int, mesh) -> torch.Tensor:
    """The greedy ids [B, T] of every row, from each rank's rows ``ids``,
    checked identical on every rank of ``mesh`` (an elementwise max and min
    over every axis); raises RuntimeError where they differ."""
    full = sharding.gather(ids, sharding.P(sharding.serve_batch_entry(mesh, batch)), mesh)
    axes = tuple(sharding.axis_sizes(mesh))
    hi = sharding.all_reduce(full.clone(), axes, mesh, op="max")
    lo = sharding.all_reduce(-full, axes, mesh, op="max").neg_()
    if not (torch.equal(hi, full) and torch.equal(lo, full)):
        raise RuntimeError("the ranks' greedy ids differ")
    return full


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a GPU)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of a multi-rank launch "
                         "(default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16 x 16 pod mesh: needs WORLD_SIZE 256")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    mesh, dev, own_group = launch_mesh(dev, backend=args.backend,
                                       production=args.production_mesh)
    rank = 0 if mesh is None else dist.get_rank()
    try:
        rng = np.random.default_rng(args.seed)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
        b = args.requests
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, args.prompt_len)),
                                  dtype=torch.int64, device=dev)
        context = None
        if cfg.n_context_tokens:
            context = torch.as_tensor(
                rng.standard_normal((b, cfg.n_context_tokens, cfg.d_model)),
                dtype=torch.float32, device=dev)
        if mesh is None:
            served = generate(cfg, params, prompts, args.new_tokens, context=context)
            ids = served["ids"]
        else:
            params = sharding.tree_shard(params, sharding.param_pspecs(cfg, mesh), mesh)
            rows = sharding.serve_rows(prompts, mesh)
            context = None if context is None else sharding.serve_rows(context, mesh)
            with sharding.use_mesh(mesh):
                served = generate(cfg, params, rows, args.new_tokens, context=context, batch=b)
            ids = gathered_ids(served["ids"], b, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()
    out = ids.cpu().numpy()
    decode_s = sum(served["decode_step_s"])
    tps = b * (args.new_tokens - 1) / max(decode_s, 1e-9)
    if rank == 0:
        ranks = 1 if mesh is None else mesh.size()
        print(f"arch={cfg.name} device={dev} ranks={ranks} batch={b} "
              f"prefill={served['prefill_s']*1e3:.1f}ms decode={decode_s*1e3:.1f}ms "
              f"({tps:.1f} tok/s) sample={out[0, :12].tolist()}")
    return out


if __name__ == "__main__":
    main()
