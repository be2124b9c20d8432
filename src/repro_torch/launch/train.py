"""Training launcher: mesh + sharded state + the fault-tolerant driver.

Port of ``repro/launch/train.py``.  One process runs a training job on one
card (or the CPU).  Launched on several ranks (``torchrun``'s environment:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
it trains on the debug mesh, (1, WORLD_SIZE) ("data", "model"), or with
``--production-mesh`` on the 16 × 16 pod mesh, which needs exactly 256
ranks (``launch.mesh.make_mesh`` raises otherwise).  On the debug mesh
every rank is on "model": each sees every row, and the step runs
Megatron tensor-parallel over them (each rank its block of the attention
heads, the MLP columns and rows, Mamba's channels, the MoE experts and
the vocab), gathering each unit's remaining leaves as it runs.  The
backend is NCCL for ranks on cards, gloo on the CPU or with ``--backend
gloo``.  Every rank draws the params from a ``torch.Generator`` seeded
with ``--seed`` and keeps its shard of them
(``runtime.steps.state_pspecs``); the batches come from the synthetic
token stream of ``data.pipeline`` (numpy, deterministic in (seed, step)),
the global batch on every rank, copied to its device each step (the step
cuts the rank's rows).  Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch reservoir_lm \\
      --steps 200 --batch 8 --seq 256 --d-model 256 --layers 4          # on cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 \\
      --batch 2 --seq 16 --d-model 64 --layers 1 --vocab 128
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --device cpu --steps 4 --batch 4 --seq 16 --d-model 64 --layers 1 --vocab 128

``--no-reduce`` trains the arch's own config (reservoir_lm: 12 layers,
d 768, bf16 activations over f32 params, 4 microbatches, remat "full").
The last line printed is the reference's:
``arch=... steps=... loss a -> b stragglers=n``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging

import torch
import torch.distributed as dist

from ..configs import get_config
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..optim import AdamWConfig
from ..parallel import sharding
from ..runtime.steps import init_train_state, state_pspecs, train_step
from ..runtime.trainer import TrainLoopConfig, run_training
from .mesh import launch_mesh


def reduced_config(cfg, args):
    if args.no_reduce:
        return cfg
    return dataclasses.replace(
        cfg,
        n_layers=args.layers * len(cfg.unit),
        d_model=args.d_model,
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128),
        head_dim=64,
        d_ff=args.d_model * 4 if cfg.d_ff else 0,
        vocab_size=args.vocab,
        max_seq_len=args.seq,
        n_experts=min(8, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        moe_d_ff=args.d_model if cfg.n_experts else 0,
        n_encoder_layers=min(2, cfg.n_encoder_layers),
        n_context_tokens=0,
        reservoir_nodes=min(128, cfg.reservoir_nodes),
        microbatches=args.microbatches,
        dtype="float32",
        remat="none",
    )


def batch_to_device(batch: dict, dev: torch.device) -> dict:
    """A host batch (numpy arrays) as tensors on ``dev``: through pinned
    memory on a card, so the copy does not wait for the device."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if dev.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="reservoir_lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints/train")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of a multi-rank launch "
                         "(default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--no-reduce", action="store_true",
                    help="use the full assigned config (cluster scale)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16 x 16 pod mesh: needs WORLD_SIZE 256")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch), args)
    if cfg.n_context_tokens:
        raise NotImplementedError(f"{cfg.name} trains on a context: the synthetic token "
                                  "stream has none")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 5),
                          total_steps=args.steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)

    mesh, dev, own_group = launch_mesh(dev, backend=args.backend,
                                       production=args.production_mesh)
    rank = 0 if mesh is None else dist.get_rank()
    try:
        history, flagged = _train(cfg, opt_cfg, data_cfg, args, dev, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()

    first = [h["loss"] for h in history[:5]]
    last = [h["loss"] for h in history[-5:]]
    if rank == 0:
        print(f"arch={cfg.name} steps={len(history)} "
              f"loss {sum(first)/len(first):.4f} -> {sum(last)/len(last):.4f} "
              f"stragglers={flagged}")
    return history


def _train(cfg, opt_cfg, data_cfg, args, dev, mesh):
    """The training loop on ``dev``, sharded over ``mesh`` when one is given:
    (history, stragglers flagged)."""
    specs = None if mesh is None else state_pspecs(cfg, mesh)

    def step_fn(state, batch):
        with sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            return train_step(cfg, opt_cfg, state, batch_to_device(batch, dev))

    def init_fn():
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                                 device=dev)
        return state if mesh is None else sharding.tree_shard(state, specs, mesh)

    state, history, watchdog = run_training(
        step_fn=step_fn,
        init_state_fn=init_fn,
        data_cfg=data_cfg,
        loop_cfg=TrainLoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
        ),
        device=dev,
        state_sharding=None if mesh is None else (mesh, specs),
    )
    return history, len(watchdog.flagged)


if __name__ == "__main__":
    main()
