"""The port's optimizer (``repro_torch.optim``) against the JAX package's
``repro.optim``, on the same numpy params and gradients.

AdamW: schedules, the global norm, clipping on and off, and one update of
every smoke arch's params, each leaf's decay decision equal to the
reference's (by the reference's own ``jax.tree_util.keystr`` path).  Both
compute in f32 with the same ops; the norm sums its leaves in another
order, so params and moments agree to f32 round-off (rtol 2e-6 of each
leaf's largest value, the update's own rounding being ~1e-7).  The
compression codes, scales and residual are bitwise the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_model import chip_smoke

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import convert
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.optim import AdamWConfig, apply_updates, global_norm, init_opt_state, schedule_lr
from repro_torch.optim import compression
from repro_torch.optim.adamw import _decay_mask, tree_leaves, tree_leaves_with_path

CPU = torch.device("cpu")
TOL = 2e-6
CS = chip_smoke()


@pytest.mark.parametrize("schedule,warmup", [("cosine", 10), ("cosine", 1), ("constant", 10),
                                             ("constant", 0)])
def test_schedule_lr_matches_reference(schedule, warmup):
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=50, schedule=schedule)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        want = float(jadamw.schedule_lr(jadamw.AdamWConfig(**kw), jnp.asarray(step, jnp.int32)))
        got = schedule_lr(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        # a few f32 ulps: XLA's and torch's cos round apart
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, (step, float(got), want)


def _grads_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        params)


def _close_tree(got: list, want: list, what: str):
    for (path, g), w in zip(got, want, strict=True):
        g = g.detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= TOL * scale, (what, path, err, scale)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_apply_updates_matches_reference_on_every_smoke_arch(arch, clip):
    """One AdamW update from non-zero moments at step 3: params, m and v
    within f32 round-off of the reference's, the grad norm and lr too, and
    the decay decision of every leaf the reference's."""
    cfg = smoke_config(arch)
    params = CS.lm_numpy_params(cfg, 0)
    grads = _grads_like(params, 1)
    m0, v0 = _grads_like(params, 2, 0.1), jax.tree.map(np.abs, _grads_like(params, 3, 0.1))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    step = 3
    jp, jo, jm = jadamw.apply_updates(jadamw.AdamWConfig(**kw), jax.tree.map(jnp.asarray, params),
                                      {"m": jax.tree.map(jnp.asarray, m0),
                                       "v": jax.tree.map(jnp.asarray, v0)},
                                      jax.tree.map(jnp.asarray, grads), jnp.asarray(step))
    tp = convert.lm_params_from_reference(params, device=CPU)
    to = {"m": convert.lm_params_from_reference(m0, device=CPU),
          "v": convert.lm_params_from_reference(v0, device=CPU)}
    tg = tree_leaves(convert.lm_params_from_reference(grads, device=CPU))
    storage = [p.data_ptr() for p in tree_leaves(tp)]
    tm = apply_updates(AdamWConfig(**kw), tp, to, tg, torch.tensor(step, dtype=torch.int32))
    assert [p.data_ptr() for p in tree_leaves(tp)] == storage          # in place
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    leaves = jax.tree.leaves
    _close_tree(tree_leaves_with_path(tp), [np.asarray(x) for x in leaves(jp)], "params")
    _close_tree(tree_leaves_with_path(to["m"]), [np.asarray(x) for x in leaves(jo["m"])], "m")
    _close_tree(tree_leaves_with_path(to["v"]), [np.asarray(x) for x in leaves(jo["v"])], "v")
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    want = {jax.tree_util.keystr(path): jadamw._decay_mask(jax.tree_util.keystr(path))
            for path, _ in flat}
    assert {path: _decay_mask(path) for path, _ in tree_leaves_with_path(tp)} == want


def test_w_in_with_no_gradient_decays_as_in_the_reference():
    """The reservoir's ``w_in`` is detached: the port's autograd gives it no
    gradient (None), the reference a zero one.  Its moments stay zero, and
    weight decay still moves it, by the reference's step."""
    cfg = smoke_config("reservoir_lm")
    params = CS.lm_numpy_params(cfg, 0)
    grads = _grads_like(params, 1)
    grads["units"][0]["mixer/w_in"][:] = 0.0
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jp, jo, _ = jadamw.apply_updates(jadamw.AdamWConfig(**kw), jax.tree.map(jnp.asarray, params),
                                     jadamw.init_opt_state(jax.tree.map(jnp.asarray, params)),
                                     jax.tree.map(jnp.asarray, grads), jnp.asarray(0))
    tp = convert.lm_params_from_reference(params, device=CPU)
    to = init_opt_state(tp)
    paths = [p for p, _ in tree_leaves_with_path(tp)]
    tg = [None if "w_in" in p else g for p, g in
          zip(paths, tree_leaves(convert.lm_params_from_reference(grads, device=CPU)))]
    assert tg.count(None) == 1
    apply_updates(AdamWConfig(**kw), tp, to, tg, torch.tensor(0, dtype=torch.int32))
    w = tp["units"][0]["mixer/w_in"]
    want = np.asarray(jp["units"][0]["mixer/w_in"])
    assert not np.array_equal(want, params["units"][0]["mixer/w_in"])     # it moved
    np.testing.assert_allclose(w.numpy(), want, rtol=0, atol=TOL * float(np.abs(want).max()))
    assert not to["m"]["units"][0]["mixer/w_in"].any()
    assert not to["v"]["units"][0]["mixer/w_in"].any()


def test_global_norm_and_init_opt_state_match_reference():
    params = CS.lm_numpy_params(smoke_config("jamba-v0.1-52b"), 4)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, params)))
    tp = convert.lm_params_from_reference(params, device=CPU)
    assert float(global_norm(tp)) == pytest.approx(want, rel=1e-6)
    opt = init_opt_state(tp)
    for k in ("m", "v"):
        got = tree_leaves_with_path(opt[k])
        assert [p for p, _ in got] == [p for p, _ in tree_leaves_with_path(tp)]
        assert all(t.dtype == torch.float32 and not t.any() for _, t in got)


@pytest.mark.parametrize("shape", [(7,), (256,), (3, 300), (2, 5, 129)])
def test_quantize_codes_scales_and_residual_are_bitwise_the_references(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(np.float32)
    g.flat[0] = 0.0
    q, scale, res = compression.quantize(torch.as_tensor(g))
    jq, jscale, jres = jcomp.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    assert np.array_equal(res.numpy(), np.asarray(jres))
    assert np.array_equal(compression.dequantize(q, scale, shape).numpy(),
                          np.asarray(jcomp.dequantize(jq, jscale, shape)))
    grid = q.float() * scale
    assert np.array_equal(compression.dequantize_from_grid(grid, shape).numpy(),
                          np.asarray(jcomp.dequantize_from_grid(jnp.asarray(grid.numpy()),
                                                                shape)))


def test_quantize_all_zero_block_and_error_state():
    q, scale, res = compression.quantize(torch.zeros(300))
    jq, jscale, jres = jcomp.quantize(jnp.zeros(300))
    assert np.array_equal(scale.numpy(), np.asarray(jscale)) and not q.any() and not res.any()
    params = {"a": torch.ones((2, 3)), "b": (torch.ones(4),)}
    err = compression.init_error_state(params)
    assert err["a"].shape == (2, 3) and err["b"][0].dtype == torch.float32
    assert not err["a"].any()


def test_compressed_psum_waits_for_the_mesh():
    """It reduces over an axis of the active mesh, and raises without one or
    on a mesh without that axis (its run over four ranks against the
    reference: tests/test_torch_parallel.py)."""
    from repro_torch.parallel import sharding

    with pytest.raises(ValueError, match="activate a mesh"):
        compression.compressed_psum(torch.zeros(3), torch.zeros(3), "pod")
    with sharding.use_mesh(sharding.AbstractMesh((2, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="'pod'"):
            compression.tree_compressed_psum({"a": torch.zeros(3)}, {"a": torch.zeros(3)},
                                             "pod")


def test_apply_updates_rejects_mismatched_trees():
    params = {"a": torch.ones(3)}
    with pytest.raises(ValueError, match="gradients"):
        apply_updates(AdamWConfig(), params, init_opt_state(params), [], torch.tensor(0))


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(AdamWConfig)] == \
        [f.name for f in dataclasses.fields(jadamw.AdamWConfig)]
    assert AdamWConfig() == AdamWConfig(**dataclasses.asdict(jadamw.AdamWConfig()))
