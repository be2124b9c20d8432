"""The rank side of tests/test_torch_parallel_xlstm.py: a module that
imports torch and the port only, so each spawned rank starts without the
JAX package."""

import dataclasses

import torch

from repro_torch import configs, convert
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.models import xlstm
from repro_torch.parallel import sharding

AXES = ("data", "model")
APPLY = {"mlstm": xlstm.apply_mlstm, "slstm": xlstm.apply_slstm}


def case_config(overrides: dict):
    """The xlstm-1.3b smoke config with ``overrides`` (a dict)."""
    return dataclasses.replace(configs.smoke_config("xlstm-1.3b"), **overrides)


def block_positions(cfg) -> dict:
    """{mixer kind: its first unit position}."""
    out = {}
    for pos, blk in enumerate(cfg.unit):
        out.setdefault(blk.mixer, pos)
    return out


def _mixer(plan, leaves, pos):
    """Unit position ``pos``'s mixer leaves of unit 0 as the block uses
    them (``Plan.leaves``), and the collectives those gathers ran."""
    with sharding.record_collectives() as events:
        p = plan.leaves(leaves, ("units", pos), index=0)
    return lm._split(p, "mixer"), [dict(e) for e in events]


def xlstm_rank(rank, shape, cases, prompt, decodes):
    """Each case (config overrides, numpy params, inputs x [B, S, d],
    cotangent r [B, prompt, d]) on this rank of a ("data", "model") mesh of
    ``shape``, for its mLSTM and its sLSTM block (unit 0):

    * served: a prefill of ``prompt`` positions of x from a cache of
      ``init_cache(plan=...)``'s blocks, then ``decodes`` one-position
      steps; the outputs (this rank's rows), the final cache blocks, the
      collectives of the leaves' gathers and of the last decode step;
    * one train-plan step of the block over x's first ``prompt`` positions:
      the gradients of sum(y · r) for this rank's rows of x and for its
      blocks of the mixer's leaves (each summed over the axes that cut the
      rows and that its spec does not name, as the train step's
      ``_reduce_replicated`` sums them)."""
    mesh = make_mesh(shape, AXES, device_type="cpu")
    out = []
    for overrides, host, xs, rs in cases:
        cfg = case_config(overrides)
        local = sharding.tree_shard(convert.lm_params_from_reference(host, device="cpu"),
                                    sharding.param_pspecs(cfg, mesh), mesh)
        batch = xs.shape[0]
        plan = sharding.Plan(cfg, mesh)
        x = sharding.serve_rows(torch.as_tensor(xs), mesh)
        cache = lm.init_cache(cfg, batch, prompt + decodes, device="cpu", plan=plan)
        tplan = sharding.Plan(cfg, mesh, train=True, rows=batch)
        rows = sharding.P(tplan.row_axes)
        res = {}
        for kind, pos in block_positions(cfg).items():
            fn = APPLY[kind]
            p, leaf_events = _mixer(plan, local["units"][pos], pos)
            with torch.no_grad():
                y, c = fn(cfg, p, x[:, :prompt], cache=tuple(t[0] for t in cache["units"][pos]),
                          plan=plan)
                ys = [y]
                for i in range(prompt, prompt + decodes):
                    with sharding.record_collectives() as events:
                        y, c = fn(cfg, p, x[:, i:i + 1], cache=c, plan=plan)
                    ys.append(y)
            # gradients
            leaves = {k: v.clone().requires_grad_(True) for k, v in local["units"][pos].items()}
            xg = sharding.shard(torch.as_tensor(xs[:, :prompt]), rows, mesh).requires_grad_(True)
            tp, _ = _mixer(tplan, leaves, pos)
            y_t, _ = fn(cfg, tp, xg, plan=tplan)
            names = sorted(k for k in leaves if k.startswith("mixer/"))
            r = sharding.shard(torch.as_tensor(rs), rows, mesh)
            grads = torch.autograd.grad((y_t * r).sum(), [xg] + [leaves[k] for k in names])
            with torch.no_grad():
                for k, g in zip(names, grads[1:], strict=True):
                    named = {a for e in tplan.pspecs["units"][pos][k]
                             for a in sharding.entry_axes(e)}
                    tplan.reduce(g, tuple(a for a in tplan.row_axes if a not in named))
            res[kind] = {"outputs": ys, "cache": c, "leaf_events": leaf_events,
                         "decode_events": [dict(e) for e in events],
                         "grads": {"x": grads[0],
                                   **{k[len("mixer/"):]: g[0]
                                      for k, g in zip(names, grads[1:], strict=True)}},
                         "labels": sharding.use_labels(cfg, mesh)["units"][pos]}
        out.append(res)
    return out
