"""The rank side of tests/test_torch_parallel_pipeline.py: reservoir_lm
pipelined by ``parallel.pipeline.pipeline_apply`` over the ranks of a
("stage",) mesh, with ``chip_smoke.py``'s stage function, in a module that
imports torch and the port only, so each spawned rank starts without the
JAX package.  The test's own process runs the same microbatches through
the JAX package's forward and the port's one-process fold."""

import dataclasses
import functools
import importlib.util
import pathlib

import torch

from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.kernels.dfr_scan import ops as scan_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import pipeline, sharding

N_LAYERS = 4
MICRO = (3, 2, 16)        # M microbatches of mb rows of S tokens
STAGES = (2, 4)
SEED = 0
WORLD = 4


def config():
    """reservoir_lm's smoke config (f32) at N_LAYERS units."""
    return dataclasses.replace(smoke_config("reservoir_lm"), n_layers=N_LAYERS)


@functools.cache
def chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_pipeline", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def inputs():
    """(numpy params in the JAX package's layout, tokens [M, mb, S])."""
    cs, cfg = chip_smoke(), config()
    return cs.lm_numpy_params(cfg, SEED), cs.lm_tokens(cfg, MICRO, SEED + 1)


def stage_mesh(n_stages: int):
    """The ("stage",) mesh of ``n_stages`` ranks this rank is on: the whole
    world's (``make_stage_mesh``), or the "stage" row of a
    ("data", "stage") mesh over the world."""
    if n_stages == WORLD:
        return pipeline.make_stage_mesh(n_stages, device_type="cpu")
    return make_mesh((WORLD // n_stages, n_stages), ("data", "stage"), device_type="cpu")["stage"]


def pipeline_rank(rank):
    """For each S of STAGES: this rank's stage, its outputs [M, mb, S, d]
    and logits [M, mb, S, V] after ``pipeline_apply`` on ``inputs()``
    (drawn here: a spawn's arguments over the pipe's buffer would start
    the ranks one by one), K1's (launches, calls) in the call and its
    collectives as (kind, bytes, axis)."""
    cs, cfg = chip_smoke(), config()
    host, tokens = inputs()
    params = convert.lm_params_from_reference(host, device="cpu")
    out = {}
    with torch.no_grad():
        x = cs.pipe_embed(cfg, params, torch.as_tensor(tokens))
        for n_stages in STAGES:
            mesh = stage_mesh(n_stages)
            stage = sharding.coordinate(mesh, "stage")
            units = cs.pipe_stage_params(params, stage, n_stages)
            scan_ops.dfr_scan.launches = scan_ops.dfr_scan.calls = 0
            with sharding.record_collectives() as events:
                h = pipeline.pipeline_apply(cs.pipe_stage_fn(cfg), units, x, mesh=mesh)
            out[n_stages] = {"stage": stage, "h": h, "logits": cs.pipe_head(cfg, params, h),
                             "k1": (scan_ops.dfr_scan.launches, scan_ops.dfr_scan.calls),
                             "events": [(e["kind"], e["bytes"], e["axis"]) for e in events]}
    return out
