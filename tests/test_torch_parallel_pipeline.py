"""reservoir_lm pipelined by ``parallel.pipeline.pipeline_apply`` over
gloo ranks on the CPU, against the JAX package's forward and the port's
one-process fold of the same microbatches.

One spawn of four ranks (``torch_parallel_pipeline_ranks.pipeline_rank``)
runs reservoir_lm's smoke config at 4 units over S = 4 stages (the whole
world's ("stage",) mesh) and over S = 2 (the "stage" rows of a (2, 2)
("data", "stage") mesh, two pipelines side by side), M = 3 microbatches
of 2 × 16 tokens, each stage holding its U / S units; the JAX package's
forward and the port's fold run in a worker thread meanwhile.  What each
case holds, on every rank:

* the logits within 2e-5 of the JAX package's ``forward`` on the same
  tokens (PERF.md's f32 LM bar; the reference's own bar is "pipeline ==
  sequential fold");
* the outputs and logits within 1e-6 of the port's one-process fold over
  the same microbatches (``chip_smoke.pipe_fold``: the same ops at the
  same shapes; only the thread count of the CPU's sums differs);
* K1 called (M + S − 1) × the stage's units times: every stage computes on
  every tick, warm-up and drain included, as in the reference; on the CPU
  the wrapper takes its plain version and launches nothing;
* the collectives exact: a stage but the last sends M + S − 1 permutes of
  one microbatch's activations over "stage", and every rank gets all M
  outputs in one broadcast over "stage".
"""

import concurrent.futures
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_pipeline_ranks import (MICRO, N_LAYERS, STAGES, WORLD, chip_smoke, config,
                                           inputs, pipeline_rank)

from repro.configs import smoke_config as jsmoke_config
from repro.models import forward as jforward
from repro_torch import convert
from repro_torch.launch.mesh import run_ranks

REF_TOL = 2e-5
FOLD_TOL = 1e-6


@functools.cache
def _inputs():
    return inputs()


@functools.cache
def _pool():
    return concurrent.futures.ThreadPoolExecutor(max_workers=1)


@functools.cache
def _side():
    """(the JAX package's logits [M, mb, S, V], the port's one-process fold
    (outputs, logits)), in a worker thread."""
    def run():
        host, toks = _inputs()
        m, mb, s = toks.shape
        jcfg = dataclasses.replace(jsmoke_config("reservoir_lm"), n_layers=N_LAYERS)
        jl, _ = jforward(jcfg, jax.tree.map(jnp.asarray, host),
                         jnp.asarray(toks.reshape(m * mb, s), jnp.int32))
        cs, cfg = chip_smoke(), config()
        params = convert.lm_params_from_reference(host, device="cpu")
        with torch.no_grad():
            h = cs.pipe_fold(cfg, params, cs.pipe_embed(cfg, params, torch.as_tensor(toks)))
            logits = cs.pipe_head(cfg, params, h)
        return np.asarray(jl).reshape(m, mb, s, -1), (h.numpy(), logits.numpy())

    return _pool().submit(run)


@functools.cache
def _ranks():
    """Each S's results on every rank."""
    _side()
    with tempfile.TemporaryDirectory() as store:
        ranks = run_ranks(pipeline_rank, WORLD, store_dir=store, timeout=120)
    return {s: [r[s] for r in ranks] for s in STAGES}


@pytest.mark.parametrize("n_stages", STAGES)
def test_pipelined_logits_match_the_reference_forward_on_every_rank(n_stages):
    want = _side().result()[0]
    for rank, got in enumerate(_ranks()[n_stages]):
        assert got["logits"].shape == want.shape
        np.testing.assert_allclose(got["logits"], want, atol=REF_TOL, rtol=0,
                                   err_msg=f"S = {n_stages}, rank {rank}")


@pytest.mark.parametrize("n_stages", STAGES)
def test_pipelined_outputs_match_the_one_process_fold_on_every_rank(n_stages):
    h, logits = _side().result()[1]
    for rank, got in enumerate(_ranks()[n_stages]):
        np.testing.assert_allclose(got["h"], h, atol=FOLD_TOL, rtol=0,
                                   err_msg=f"S = {n_stages}, rank {rank}")
        np.testing.assert_allclose(got["logits"], logits, atol=FOLD_TOL, rtol=0,
                                   err_msg=f"S = {n_stages}, rank {rank}")


@pytest.mark.parametrize("n_stages", STAGES)
def test_k1_runs_a_unit_a_tick_on_every_stage(n_stages):
    ticks = MICRO[0] + n_stages - 1
    for rank, got in enumerate(_ranks()[n_stages]):
        assert got["stage"] == rank % n_stages
        assert tuple(got["k1"]) == (0, ticks * N_LAYERS // n_stages), (rank, got["k1"])


@pytest.mark.parametrize("n_stages", STAGES)
def test_the_permutes_and_the_broadcast_are_exact(n_stages):
    m, mb, s = MICRO
    act = mb * s * config().d_model * 4
    for rank, got in enumerate(_ranks()[n_stages]):
        sends = m + n_stages - 1 if got["stage"] < n_stages - 1 else 0
        assert [tuple(e) for e in got["events"]] == (
            [("collective-permute", act, "stage")] * sends + [("broadcast", m * act, "stage")]), rank
