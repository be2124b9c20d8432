"""One ``train_step`` of each arch of ``configs.ARCHS`` (smoke configs,
f32, numpy weights with every leaf non-zero) against the JAX package's,
from the same state and batch (and stub context): each leaf's gradient
within 1e-5 of its largest |gradient|, or within twice the reference's own
spread where that is larger, the loss and grad norm within 2e-5 relative
(or that spread), the moments within the same bound (v, a square, twice
it).  The
reference's own spread is how far its gradient moves (the largest over
leaves, each relative to its largest |gradient|) when every weight moves
by ±2e-7 of itself, about an f32 ulp: 1e-6 for the attention archs and
reservoir_lm, 3.2e-5 for jamba (its SSM scans) and 1.7e-4 for xlstm (its
sLSTM recurrence amplifies rounding, ROADMAP.md Queue 3), where the port's
largest gaps are 1.1e-5 and 5.5e-5.  qwen3-moe-30b-a3b, jamba and xlstm
run in ``test_torch_lm_train_mixers.py`` (the files split the JAX
package's compile time).  A flipped MoE expert set or reservoir branch bit
would show as a gradient outside the bound, and is not widened away.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_train import CS, GRAD_TOL, MOMENT_TOL, _port_grads, _ref_grads, _rel_err

from repro.configs import smoke_config as jsmoke_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import steps as jsteps
from repro_torch import convert
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves, tree_leaves_with_path
from repro_torch.runtime import steps

CPU = torch.device("cpu")
MIXER_ARCHS = ("qwen3-moe-30b-a3b", "jamba-v0.1-52b", "xlstm-1.3b")
DENSE_ARCHS = tuple(a for a in ARCHS if a not in MIXER_ARCHS)


def assert_one_step_matches_reference(arch: str):
    cfg, jcfg = smoke_config(arch), jsmoke_config(arch)
    host = CS.lm_train_state(CS.lm_numpy_params(cfg, 0))
    jstate = jax.tree.map(jnp.asarray, host)
    tstate = convert.train_state_from_reference(host, device=CPU)
    (batch,) = CS.lm_train_batches(cfg, 1, (2, 10), 4)
    ctx = CS.lm_context(cfg, 2, CS.LM_CONTEXT_SEED)
    if ctx is not None:
        batch = {**batch, "context": ctx}
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    paths = [p for p, _ in tree_leaves_with_path(tstate["params"])]
    want = _ref_grads(jcfg, jstate["params"], jb, 1)
    rng = np.random.default_rng(99)
    nudged = jax.tree.map(lambda a: jnp.asarray(
        a * (1 + 2e-7 * rng.choice((-1.0, 1.0), a.shape)), jnp.float32), host["params"])
    spread = max(_rel_err(a, b) for a, b in zip(_ref_grads(jcfg, nudged, jb, 1), want))
    tol = [max(GRAD_TOL, 2 * spread)] * len(want)
    got = _port_grads(cfg, tstate["params"], tb, 1)
    for path, g, w, t in zip(paths, got, want, tol, strict=True):
        assert _rel_err(g, w) <= t, (arch, path, _rel_err(g, w), t)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstate, jm = jsteps.train_step(jcfg, JAdamWConfig(**kw), jstate, jb)
    tstate, tm = steps.train_step(cfg, AdamWConfig(**kw), tstate, tb)
    for k in ("loss", "grad_norm", "moe_aux"):
        bound = max(CS.LM_TRAIN_TOL, tol[0]) * max(1.0, abs(float(jm[k])))
        assert abs(float(tm[k]) - float(jm[k])) <= bound, (arch, k, float(tm[k]), float(jm[k]))
    for name, factor in (("m", 1), ("v", 2)):
        for path, t, w, bound in zip(paths, tree_leaves(tstate["opt"][name]),
                                     jax.tree.leaves(jstate["opt"][name]), tol, strict=True):
            assert _rel_err(t, w) <= factor * max(MOMENT_TOL, bound), (arch, name, path)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_one_train_step_matches_reference(arch):
    assert_one_step_matches_reference(arch)


def test_the_two_files_cover_every_arch():
    assert set(DENSE_ARCHS) | set(MIXER_ARCHS) == set(ARCHS)
    assert dataclasses.is_dataclass(smoke_config("granite-8b"))
