"""The port's LM training path against the JAX package's, on the CPU.

The mixer's gradient: the adjoint scan's plain version (``dfr_scan_grad``
on CPU tensors: the kernel's ops in the kernel's order) against
``jax.grad`` of the reference's scan oracle and of its mixer, and against
torch's autograd through the port's own plain forward, with a non-zero
readout (the configs' zero readout gives the mixer a zero gradient at
init, where a broken adjoint would pass).  Gradients agree to f32
round-off: 2e-6 of the largest |gradient| (sums over up to K·N dependent
steps, rounded in another order).

``train_step``: reservoir_lm's smoke config from the same numpy state
(``chip_smoke.lm_train_state``) over 3 steps with 1 and 2 microbatches,
each step's gradients within 1e-5 of each leaf's largest |gradient|
(``GRAD_TOL``), loss and grad norm within 2e-5 (``LM_TRAIN_TOL``), and the
moments within 1e-5 of each leaf's largest.  The params follow from them
by AdamW, whose first steps move an element by about ±lr whatever its
gradient's size: an element whose gradient is at round-off level in the
reference can take the other sign, so such elements (|g| below 1e-4 of
the leaf's largest at some step) are bounded by 2·Σlr and counted in the
assertion message; every other element is held to 1e-5 of the leaf's
largest |param|.  Every other arch of ``configs.ARCHS`` is held for one
step in ``test_torch_lm_train_archs.py``.

Behaviour: remat none, full and dots give the same bits; m microbatches
average to one batch's gradient; the loss falls; a step that raises inside
the adjoint scan leaves the state bitwise as it was.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_model import chip_smoke

from repro.configs import smoke_config as jsmoke_config
from repro.core import layer as jlayer
from repro.kernels.dfr_scan import ref as jscan_ref
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import steps as jsteps
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import MackeyGlass, SiliconMR, SiliconMRLiteral, make_mask
from repro_torch.core import layer as tlayer
from repro_torch.kernels.dfr_scan import ops as scan_ops
from repro_torch.kernels.dfr_scan.ref import dfr_scan_ref
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves, tree_leaves_with_path
from repro_torch.runtime import steps

CPU = torch.device("cpu")
SCAN_GRAD_TOL = 2e-6
GRAD_TOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_TOL = 1e-5
AMBIGUOUS = 1e-4
CS = chip_smoke()


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the mixer's gradient
# ---------------------------------------------------------------------------


def _scan_inputs(b, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, k)).astype(np.float32),
            rng.uniform(0, 0.3, (b, n)).astype(np.float32),
            np.asarray(make_mask(n, seed=1)),
            rng.standard_normal((b, k, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


@pytest.mark.parametrize("beta", [0.0, 0.5])
@pytest.mark.parametrize("b,k,n", [(3, 5, 7), (2, 9, 16), (1, 1, 1)])
def test_adjoint_scan_matches_jax_grad_of_the_reference_scan(b, k, n, beta):
    """dj and ds0 against ``jax.grad`` of the reference's scan oracle
    (``repro.kernels.dfr_scan.ref``) with a non-zero gradient of the final
    state, at beta 0 (the mixer's form) and beta 0.5 (TPA saturation)."""
    from repro.core.nonlinear import SiliconMR as JSiliconMR

    j, s0, mask, g, g_fin = _scan_inputs(b, k, n, b + k + n)

    def loss(jj, ss):
        st = jscan_ref.dfr_scan_ref(JSiliconMR(beta_tpa=beta), jj, jnp.asarray(mask), ss)
        return jnp.sum(st * g) + jnp.sum(st[:, -1] * g_fin)

    want_j, want_s0 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(j), jnp.asarray(s0))
    model = SiliconMR(beta_tpa=beta)
    jt, st0, mt = torch.as_tensor(j), torch.as_tensor(s0), torch.as_tensor(mask)
    states = scan_ops.dfr_scan(model, jt, mt, st0)
    dj, ds0 = scan_ops.dfr_scan_grad(model, jt, mt, st0, states, torch.as_tensor(g),
                                     torch.as_tensor(g_fin))
    assert dj.shape == (b, k) and ds0.shape == (b, n) and dj.dtype == torch.float32
    assert _rel_err(dj, want_j) <= SCAN_GRAD_TOL
    assert _rel_err(ds0, want_s0) <= SCAN_GRAD_TOL


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_adjoint_scan_matches_autograd_through_the_plain_forward(beta):
    j, s0, mask, g, g_fin = (torch.as_tensor(a) for a in _scan_inputs(4, 6, 12, 9))
    model = SiliconMR(beta_tpa=beta)
    jr, sr = j.clone().requires_grad_(), s0.clone().requires_grad_()
    states, fin = dfr_scan_ref(model, jr, mask, sr, return_final=True)
    want = torch.autograd.grad((states * g).sum() + (fin * g_fin).sum(), (jr, sr))
    got = scan_ops.dfr_scan_grad(model, j, mask, s0, states.detach(), g, g_fin)
    for a, w in zip(got, want, strict=True):
        assert _rel_err(a, w) <= SCAN_GRAD_TOL


def _mixer_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, n, r = cfg.d_model, cfg.reservoir_nodes, tlayer._n_channels(cfg)
    return {"w_in": rng.standard_normal((d, r), dtype=np.float32) / np.float32(np.sqrt(d)),
            "readout": rng.standard_normal((r * n, d), dtype=np.float32)
            / np.float32(np.sqrt(r * n)),
            "readout_bias": rng.standard_normal(d, dtype=np.float32) * np.float32(0.1)}


def test_mixer_gradients_match_jax_grad_of_the_reference_mixer():
    """The mixer's gradients to x, its readout and bias, and its carry,
    against ``jax.grad`` of the reference's ``apply_reservoir`` from a
    carry; the reference's carry is (s_prev, s_last) with s_last feeding
    node 0, the port's s_prev alone, so the port's gradient of the carry
    is the reference's s_prev gradient plus its s_last gradient at the
    last node.  w_in gets no gradient (detached; the reference's
    stop_gradient)."""
    cfg, jcfg = smoke_config("reservoir_lm"), jsmoke_config("reservoir_lm")
    p = _mixer_params(cfg, 3)
    rng = np.random.default_rng(4)
    b, s, r, n = 2, 9, tlayer._n_channels(cfg), cfg.reservoir_nodes
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    gy = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    s_prev = rng.uniform(0, 0.3, (b, r, n)).astype(np.float32)

    def loss(xx, pp, sp):
        y, _ = jlayer.apply_reservoir(jcfg, pp, xx, cache=(sp, sp[..., -1]))
        return jnp.sum(y * gy)

    def loss_split(xx, pp, sp, sl):
        y, _ = jlayer.apply_reservoir(jcfg, pp, xx, cache=(sp, sl))
        return jnp.sum(y * gy)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp, jnp.asarray(s_prev))
    _, _, gsp, gsl = jax.grad(loss_split, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jp, jnp.asarray(s_prev), jnp.asarray(s_prev[..., -1]))
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    tsp = torch.as_tensor(s_prev).requires_grad_()
    y, _ = tlayer.apply_reservoir(cfg, tp, tx, cache=(tsp, tsp[..., -1].detach()))
    got = torch.autograd.grad((y * torch.as_tensor(gy)).sum(),
                              (tx, tp["readout"], tp["readout_bias"], tp["w_in"], tsp),
                              allow_unused=True)
    assert got[3] is None and not np.asarray(gp["w_in"]).any()
    assert _rel_err(got[0], gx) <= SCAN_GRAD_TOL
    assert float(np.abs(np.asarray(gx)).max()) > 1e-3      # the states carry a gradient
    assert _rel_err(got[1], gp["readout"]) <= SCAN_GRAD_TOL
    assert _rel_err(got[2], gp["readout_bias"]) <= SCAN_GRAD_TOL
    want_carry = np.array(gsp)
    want_carry[..., -1] += np.asarray(gsl)
    assert _rel_err(got[4], want_carry) <= SCAN_GRAD_TOL


def test_mixer_runs_k1_in_the_autograd_function_only_under_grad():
    cfg = smoke_config("reservoir_lm")
    tp = {k: torch.as_tensor(v) for k, v in _mixer_params(cfg, 5).items()}
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(0))
    calls = scan_ops.dfr_scan.calls, scan_ops.dfr_scan_grad.calls
    y0, c0 = tlayer.apply_reservoir(cfg, tp, x)
    assert y0.grad_fn is None
    xg = x.clone().requires_grad_()
    y1, c1 = tlayer.apply_reservoir(cfg, tp, xg)
    assert torch.equal(y0, y1.detach()) and torch.equal(c0[0], c1[0].detach())
    y1.sum().backward()
    assert (scan_ops.dfr_scan.calls - calls[0], scan_ops.dfr_scan_grad.calls - calls[1]) == (2, 1)
    assert xg.grad is not None and xg.grad.abs().max() > 0


def test_adjoint_scan_raises_for_forms_it_does_not_cover():
    j, s0 = torch.zeros((2, 3)), torch.zeros((2, 4))
    st = torch.zeros((2, 3, 4))
    mask = torch.ones(4)
    for model in (MackeyGlass(), SiliconMRLiteral()):
        with pytest.raises(NotImplementedError, match="SiliconMR only"):
            scan_ops.dfr_scan_grad(model, j, mask, s0, st, st, s0)
    with pytest.raises(NotImplementedError, match="per-lane"):
        scan_ops.dfr_scan_grad(SiliconMR(), j, torch.ones((2, 4)), s0, st, st, s0)
    with pytest.raises(NotImplementedError, match="per-lane"):
        scan_ops.dfr_scan_grad_plain(SiliconMR(), j, torch.ones((2, 4)), s0, st, st, s0)
    with pytest.raises(ValueError, match="f32 states"):
        scan_ops.dfr_scan_grad(SiliconMR(), j, mask, s0, st.bfloat16(), st, s0)
    with pytest.raises(ValueError, match="g_states"):
        scan_ops.dfr_scan_grad(SiliconMR(), j, mask, s0, st, st[:, :2], s0)
    assert scan_ops.grad_layout(64, 256).blocks == 64       # one lane a block
    with pytest.raises(ValueError, match="exceeds its limit"):
        scan_ops.grad_layout(8, scan_ops.max_grad_nodes() + 1)


# (B, N) -> (lanes a block, blocks, row pitch, ring slots, nodes a handoff,
# shared bytes) of K1ᵀ's block layout
GRAD_LAYOUTS = {
    (24, 256): (1, 24, 260, 3, 128, 11568),     # the LM's microbatch: a lane on each of 24 SMs
    (64, 256): (1, 64, 260, 3, 128, 11568),
    (132, 256): (1, 132, 260, 3, 128, 11568),   # the card's SMs, one lane each
    (133, 33): (2, 67, 36, 17, 64, 11600),      # past them: two lanes a block, the last half full
    (1000, 256): (8, 125, 260, 3, 64, 84576),
    (9, 900): (1, 9, 900, 2, 128, 32624),       # long rows: the ring at its least
    (1, 1): (1, 1, 4, 32, 64, 1792),            # short rows: the ring at its most
    (4096, 1180): (4, 1024, 1180, 2, 64, 156256),   # fewer lanes a block where eight would not fit
}


@pytest.mark.parametrize("b,n", sorted(GRAD_LAYOUTS))
def test_adjoint_scan_layout_and_plan(b, n):
    """K1ᵀ's block layout: one lane a block while the batch's blocks fit the
    card's SMs (then 2, 4, 8), 128-node handoffs when one lane has a block
    and a period holds two of them, the ring's depth from N, every block
    within the card's shared memory; the launch plan the contract checker
    reads is the layout's."""
    lay = scan_ops.grad_layout(b, n)
    assert tuple(lay) == GRAD_LAYOUTS[(b, n)]
    assert lay.lanes * lay.blocks >= b > (lay.blocks - 1) * lay.lanes
    assert lay.smem_bytes == scan_ops.grad_smem_bytes(lay.lanes, n, lay.depth, lay.group)
    assert lay.smem_bytes <= scan_ops.SMEM_PER_BLOCK and lay.stride % 4 == 0
    assert scan_ops.grad_plan(b, n) == {"smem_bytes": lay.smem_bytes, "row_bytes": 4 * lay.stride,
                                        "multi_tile": b > lay.lanes}


def test_adjoint_scan_node_limit():
    """The largest N fits one lane a block with a ring of two slots, N + 1
    does not, and the limit is no lower than the kernel's before (1180
    nodes at eight lanes a block); above it the plan still reads, for the
    contract checker to flag."""
    limit = scan_ops.max_grad_nodes()
    assert limit >= 1180
    lay = scan_ops.grad_layout(1, limit)
    assert (lay.lanes, lay.depth) == (1, 2) and lay.smem_bytes <= scan_ops.SMEM_PER_BLOCK
    assert scan_ops.grad_plan(1, limit + 1)["smem_bytes"] > scan_ops.SMEM_PER_BLOCK


def _adjoint_dataflow(model, j, mask, s0, states, g, g_fin):
    """K1ᵀ's dataflow (csrc/dfr_scan_grad.cu), element by element in f32:
    the a row starts as g_fin; each transition k -> k-1 (k = K .. 0) turns
    lam[k] into a[k-1] = g[k-1] + gamma gp[k] (q[0] at k = 0) and c'[k-1]
    (c[k, 0] at node N-1, 1 before the last period), and writes the terms
    of dj[k], summed N-1 -> 0; the chain runs each period between; ds0's
    node N-1 takes one more chain step with c[0, 0]."""
    f = np.float32
    alpha, gamma, beta, keep = (f(v) for v in scan_ops.grad_constants(model))
    j, m, s0, states, g, g_fin = (t.numpy() for t in (j, mask, s0, states, g, g_fin))
    b, k_periods = j.shape
    n = m.shape[0]
    dj, ds0 = np.zeros((b, k_periods), f), np.zeros((b, n), f)
    for lane in range(b):
        a, c, lam = g_fin[lane].copy(), np.ones(n, f), f(0)
        for k in range(k_periods, -1, -1):
            s = states[lane, k - 1] if k else s0[lane]
            jk = j[lane, k] if k < k_periods else f(0)
            jp = j[lane, k - 1] if k else f(0)
            terms = np.zeros(n, f)
            for i in range(n):
                if k == k_periods:
                    q = a[i]
                else:
                    gp = f(alpha * a[i])
                    if beta:
                        den = f(f(1) + f(beta * f(f(jk * m[i]) + f(gamma * s[i]))))
                        gp = f(gp / f(den * den))
                    q, terms[i] = f(gamma * gp), f(m[i] * gp)
                a[i] = f(g[lane, k - 1, i] + q) if k else q
                if i < n - 1 and k:
                    c[i] = f(1) if f(jp * m[i + 1]) > s[i] else keep
                elif i == n - 1 and k < k_periods:
                    c[i] = f(1) if f(jk * m[0]) > s[i] else keep
            if k < k_periods:
                acc = f(0)
                for i in range(n - 1, -1, -1):
                    acc = f(acc + terms[i])
                dj[lane, k] = acc
            if k:
                for i in range(n - 1, -1, -1):
                    lam = a[i] = f(a[i] + f(c[i] * lam))
        a[n - 1] = f(a[n - 1] + f(c[n - 1] * lam))
        ds0[lane] = a
    return torch.from_numpy(dj), torch.from_numpy(ds0)


@pytest.mark.parametrize("b,k,n,beta", [(1, 1, 1, 0.0), (2, 3, 5, 0.5), (3, 4, 8, 0.0),
                                        (2, 5, 33, 0.5)])
def test_adjoint_scan_dataflow_is_bitwise_the_plain_version(b, k, n, beta):
    """The kernel's split of the adjoint into per-node transitions (c'
    wrapping at node N-1, g_fin as the first q, q[0] as ds0, the extra step
    at N-1) gives the plain version's bits."""
    rng = np.random.default_rng(b * k + n)
    model = SiliconMR(beta_tpa=beta)
    j = torch.as_tensor(rng.uniform(0, 1, (b, k)), dtype=torch.float32)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32)
    mask = torch.as_tensor(rng.choice((0.0, 1.0), n), dtype=torch.float32)
    states = scan_ops.dfr_scan(model, j, mask, s0)
    g = torch.as_tensor(rng.standard_normal((b, k, n)), dtype=torch.float32)
    g_fin = torch.as_tensor(rng.standard_normal((b, n)), dtype=torch.float32)
    args = (model, j, mask, s0, states, g, g_fin)
    for got, want in zip(_adjoint_dataflow(*args), scan_ops.dfr_scan_grad_plain(*args),
                         strict=True):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# train_step against the reference
# ---------------------------------------------------------------------------


def _start(cfg, seed=0):
    """The same train state in both packages, from numpy weights."""
    host = CS.lm_train_state(CS.lm_numpy_params(cfg, seed))
    return jax.tree.map(jnp.asarray, host), convert.train_state_from_reference(host, device=CPU)


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _ref_grads(jcfg, params, batch, m):
    """The reference train step's f32 gradients (its microbatch sum / m)."""
    grad_fn = jax.grad(lambda p, b: jsteps.loss_fn(jcfg, p, b)[0])
    total = None
    for i in range(m):
        mb = jax.tree.map(lambda x: x.reshape(m, -1, *x.shape[1:])[i], batch)
        g = grad_fn(params, mb)
        total = g if total is None else jax.tree.map(jnp.add, total, g)
    return [np.asarray(x) / m for x in jax.tree.leaves(total)]


def _port_grads(cfg, params, batch, m):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    total = [torch.zeros(p.shape) for p in leaves]
    for i in range(m):
        mb = {k: v.reshape(m, -1, *v.shape[1:])[i] for k, v in batch.items()}
        loss, _ = steps.loss_fn(cfg, params, mb)
        for acc, g in zip(total, torch.autograd.grad(loss, leaves, allow_unused=True)):
            if g is not None:
                acc += g
    return [(t / m).numpy() for t in total]


@pytest.mark.parametrize("m", [1, 2])
def test_train_step_matches_reference_over_three_steps(m):
    cfg = dataclasses.replace(smoke_config("reservoir_lm"), microbatches=m)
    jcfg = dataclasses.replace(jsmoke_config("reservoir_lm"), microbatches=m)
    jstate, tstate = _start(cfg)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    paths = [p for p, _ in tree_leaves_with_path(tstate["params"])]
    ambiguous = {p: np.zeros(t.shape, bool) for p, t in tree_leaves_with_path(tstate["params"])}
    lr_sum = 0.0
    for batch in CS.lm_train_batches(cfg, 3, (2 * m, 12), 7):
        jb, tb = jax.tree.map(jnp.asarray, batch), _torch_batch(batch)
        want_g = _ref_grads(jcfg, jstate["params"], jb, m)
        got_g = _port_grads(cfg, tstate["params"], tb, m)
        for path, g, w in zip(paths, got_g, want_g, strict=True):
            assert _rel_err(g, w) <= GRAD_TOL, (path, _rel_err(g, w))
            ambiguous[path] |= np.abs(w) <= AMBIGUOUS * np.abs(w).max()
        jstate, jm = jsteps.train_step(jcfg, JAdamWConfig(**kw), jstate, jb)
        tstate, tm = steps.train_step(cfg, AdamWConfig(**kw), tstate, tb)
        assert set(tm) == set(jm)
        for k in ("loss", "ce", "z_loss", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= CS.LM_TRAIN_TOL, (k, tm[k], jm[k])
        assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * m * 12
        lr_sum += float(jm["lr"])
        for name in ("m", "v"):
            for path, t, w in zip(paths, tree_leaves(tstate["opt"][name]),
                                  jax.tree.leaves(jstate["opt"][name]), strict=True):
                assert _rel_err(t, w) <= MOMENT_TOL, (name, path, _rel_err(t, w))
        for path, t, w in zip(paths, tree_leaves(tstate["params"]),
                              jax.tree.leaves(jstate["params"]), strict=True):
            gap = np.abs(t.detach().numpy() - np.asarray(w))
            tight = PARAM_TOL * float(np.abs(np.asarray(w)).max())
            assert float(gap[~ambiguous[path]].max(initial=0.0)) <= tight, path
            flipped = int((gap[ambiguous[path]] > tight).sum())
            assert float(gap[ambiguous[path]].max(initial=0.0)) <= 2 * lr_sum, \
                (path, f"{flipped} elements with a round-off gradient moved apart")
    assert int(tstate["step"]) == int(jstate["step"]) == 3


def test_smoke_train_constants():
    """What the lm_training phase holds the card to (``LM_TRAIN_SMOKE``):
    the JAX package's losses and grad norms on chip_smoke's numpy state and
    batches equal the pasted constants (9 significant digits), and the
    port on the CPU is within the card's tolerance of them."""
    cfg, jcfg = smoke_config("reservoir_lm"), jsmoke_config("reservoir_lm")
    jstate, _ = _start(cfg, CS.LM_SEED)
    want = {"loss": [], "grad_norm": []}
    for batch in CS.lm_train_batches(cfg, CS.LM_TRAIN_SMOKE_STEPS, CS.LM_TRAIN_SMOKE_SHAPE,
                                     CS.LM_TOKENS_SEED):
        jstate, jm = jsteps.train_step(jcfg, JAdamWConfig(**CS.LM_TRAIN_OPT), jstate,
                                       jax.tree.map(jnp.asarray, batch))
        for k in want:
            want[k].append(float(jm[k]))
    got = CS.lm_smoke_train(CPU)
    for k, consts in CS.LM_TRAIN_SMOKE.items():
        np.testing.assert_allclose(want[k], consts, rtol=1e-8, atol=0)
        assert max(abs(a - b) for a, b in zip(got[k], consts)) <= CS.LM_TRAIN_TOL


# ---------------------------------------------------------------------------
# train_step behaviour
# ---------------------------------------------------------------------------


def _step_once(cfg, batch, seed=0):
    _, state = _start(cfg, seed)
    calls = scan_ops.dfr_scan.calls, scan_ops.dfr_scan_grad.calls
    grads = _port_grads(cfg, state["params"], _torch_batch(batch), cfg.microbatches)
    counts = scan_ops.dfr_scan.calls - calls[0], scan_ops.dfr_scan_grad.calls - calls[1]
    state, metrics = steps.train_step(cfg, AdamWConfig(), state, _torch_batch(batch))
    return grads, counts, state, metrics


def test_remat_none_full_and_dots_give_the_same_bits():
    """Losses, gradients and the stepped params bitwise the same under the
    three remat policies; the recompute runs K1 again (twice a layer a
    microbatch under full and dots, once under none); K1ᵀ once."""
    base = dataclasses.replace(smoke_config("reservoir_lm"), n_layers=2)
    (batch,) = CS.lm_train_batches(base, 1, (2, 10), 3)
    runs = {r: _step_once(dataclasses.replace(base, remat=r), batch)
            for r in ("none", "full", "dots")}
    g0, _, s0, m0 = runs["none"]
    assert runs["none"][1] == (2, 2)
    for r in ("full", "dots"):
        g, counts, s, met = runs[r]
        assert counts == (4, 2), r
        assert all(np.array_equal(a, b) for a, b in zip(g, g0)), r
        assert float(met["loss"]) == float(m0["loss"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s["params"]),
                                                     tree_leaves(s0["params"]))), r
    with pytest.raises(ValueError, match="remat"):
        _step_once(dataclasses.replace(base, remat="some"), batch)


def test_microbatches_average_to_the_whole_batch():
    cfg1 = smoke_config("reservoir_lm")
    (batch,) = CS.lm_train_batches(cfg1, 1, (4, 10), 5)
    g1, *_ = _step_once(cfg1, batch)
    g2, counts, _, m2 = _step_once(dataclasses.replace(cfg1, microbatches=2), batch)
    _, _, _, m1 = _step_once(cfg1, batch)
    assert counts == (2, 2)
    for a, b in zip(g2, g1, strict=True):
        assert _rel_err(a, b) <= GRAD_TOL
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-6
    assert float(m2["tokens"]) == float(m1["tokens"]) == 40


def test_loss_falls_on_a_repeated_batch():
    cfg = smoke_config("reservoir_lm")
    _, state = _start(cfg)
    (batch,) = CS.lm_train_batches(cfg, 1, (2, 16), 1)
    losses = []
    for _ in range(8):
        state, metrics = steps.train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=1),
                                          state, _torch_batch(batch))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_a_step_that_raises_in_the_adjoint_scan_leaves_the_state_bitwise(monkeypatch):
    cfg = smoke_config("reservoir_lm")
    _, state = _start(cfg)
    (batch,) = CS.lm_train_batches(cfg, 1, (2, 8), 2)
    state, _ = steps.train_step(cfg, AdamWConfig(), state, _torch_batch(batch))
    before = [t.detach().clone() for t in tree_leaves(state)]

    def broken(*args, **kwargs):
        raise RuntimeError("simulated fault in the adjoint scan")

    monkeypatch.setattr(tlayer, "dfr_scan_grad", broken)
    with pytest.raises(RuntimeError, match="simulated fault"):
        steps.train_step(cfg, AdamWConfig(), state, _torch_batch(batch))
    after = tree_leaves(state)
    assert len(after) == len(before)
    assert all(torch.equal(a.detach(), b) for a, b in zip(after, before))


def test_train_state_from_reference_round_trip():
    cfg, jcfg = smoke_config("reservoir_lm"), jsmoke_config("reservoir_lm")
    ref = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    ref["step"] = jnp.asarray(5, jnp.int32)
    got = convert.train_state_from_reference(ref, device=CPU)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 5
    flat_ref = jax.tree.leaves(ref)
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_ref)
    assert all(np.array_equal(t.numpy(), np.asarray(w)) for t, w in zip(flat_got, flat_ref))
    with pytest.raises(TypeError, match="train state"):
        convert.train_state_from_reference({"params": ref["params"]}, device=CPU)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert [p for p, _ in tree_leaves_with_path(state["opt"]["m"])] == \
        [p for p, _ in tree_leaves_with_path(got["opt"]["m"])]
