"""Serving launcher: batched greedy prefill + decode of an LM.

Port of ``repro/launch/serve.py``: a batch of random prompts is prefilled
once, then decoded token by token with the batch's cache updated in place
(the reference donates it between steps).  One card, no mesh
(``launch/mesh.py`` has no counterpart here).  Weights are drawn from a
``torch.Generator`` seeded with ``--seed``; the prompts from numpy's, and
for a cross-attention family (VLM, encoder-decoder) the stub context
[B, n_context_tokens, d_model] after them, as the reference's launcher
draws it (its frontends are stubs).  Every arch in ``configs.ARCHS``
serves.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --requests 8 --new-tokens 32            # on cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch jamba-v0.1-52b
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params
from ..runtime.steps import serve_decode, serve_prefill


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
          context: torch.Tensor | None = None) -> dict:
    """Prefill ``prompts`` [B, P] (with ``context`` [B, T, d] for a
    cross-attention family) into a cache with room for ``new_tokens`` (and
    ``slack`` more decode steps) and take the first greedy token.

    Returns the served batch: ``ids`` and ``logits`` (a list of [B, 1] and
    [B, V] tensors, one a token), the ``cache``, ``prefill_s`` and
    ``decode_step_s`` (host wall, each ending in a device synchronise).
    """
    dev = prompts.device
    max_len = prompts.shape[1] + new_tokens + slack
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = serve_prefill(cfg, params, prompts, context, max_len=max_len)
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
             context: torch.Tensor | None = None) -> dict:
    """Greedy serving of ``prompts`` [B, P] (and ``context``): one prefill,
    then ``new_tokens - 1`` decode steps.  The served batch of ``start``,
    with ``ids`` [B, new_tokens] and ``logits`` [B, new_tokens, V] joined."""
    served = start(cfg, params, prompts, new_tokens, slack=slack, context=context)
    for _ in range(new_tokens - 1):
        decode(cfg, params, served)
    return joined(served)


def joined(served: dict) -> dict:
    """A served batch with its ``ids`` and ``logits`` joined over tokens."""
    return {**served, "ids": torch.cat(served["ids"], dim=1),
            "logits": torch.stack(served["logits"], dim=1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch))
    rng = np.random.default_rng(args.seed)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    b = args.requests
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, args.prompt_len)),
                              dtype=torch.int64, device=dev)
    context = None
    if cfg.n_context_tokens:
        context = torch.as_tensor(
            rng.standard_normal((b, cfg.n_context_tokens, cfg.d_model)), dtype=torch.float32,
            device=dev)
    served = generate(cfg, params, prompts, args.new_tokens, context=context)
    out = served["ids"].cpu().numpy()
    decode_s = sum(served["decode_step_s"])
    tps = b * (args.new_tokens - 1) / max(decode_s, 1e-9)
    print(f"arch={cfg.name} device={dev} batch={b} prefill={served['prefill_s']*1e3:.1f}ms "
          f"decode={decode_s*1e3:.1f}ms ({tps:.1f} tok/s) "
          f"sample={out[0, :12].tolist()}")
    return out


if __name__ == "__main__":
    main()
