"""The mLSTM and sLSTM blocks tensor-parallel over "model"
(``models/xlstm.py`` under a ``parallel.sharding.Plan``) on gloo ranks on
the CPU, against the JAX package's unsharded blocks.

One spawn a mesh ((1, 2), (2, 2), (1, 4);
``torch_parallel_xlstm_ranks.xlstm_rank``) runs every case of its mesh:
the xlstm-1.3b smoke config (f = 85, which "model" does not divide: the
sLSTM's gated projection gathered whole), d_model 96 (f = 128: its
columns and rows), and on (1, 4) the fallbacks: 2 heads (the sLSTM cell
replicated, its c, n, h cache blocks gathered for the step), d_model 36
(head_dim 18: the mLSTM's C and n whole on every rank) and d_model 33 with
3 heads (d_in 66: the mLSTM replicated, its leaves gathered whole).  Each
block (unit 0's mLSTM and sLSTM) serves a prefill of PROMPT positions from
its cache blocks and DECODES one-position steps, then takes one train-plan
gradient of sum(y · r) over the prompt, on numpy inputs drawn from a seed
and chip_smoke's numpy params:

* outputs (each rank's rows) within OUT_TOL of the reference's largest
  |output| a step; each rank's final cache blocks within OUT_TOL (plus
  STATE_RTOL of the buffer's largest |value|, as the sharded serving tests
  hold recurrent states) of the reference's caches cut by the reference's
  ``cache_pspecs``;
* gradients for x (the rank's rows) and for each mixer leaf (the rank's
  block under ``param_pspecs``) within GRAD_TOL of the leaf's largest
  |gradient| (tests/test_torch_lm_train.py's bound): a gather with the
  wrong backward doubles or drops a part of a gradient;
* the leaves' labels: every mixer leaf whose spec puts "model" on a TP
  axis is "local", but the gate biases and a replicated mLSTM's leaves;
  the serving plan's leaf gathers over "model" return exactly the bytes
  of the "gathered" leaves, none of a "local" one;
* a decode step's collectives exactly, in order (kind, bytes, axis): no
  C/n/c/h cache block is all-gathered but a replicated cell's.
"""

import concurrent.futures
import functools
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_lm_model import STATE_RTOL, chip_smoke
from test_torch_lm_train import GRAD_TOL
from test_torch_parallel_serve import _axes
from torch_parallel_xlstm_ranks import block_positions, case_config, xlstm_rank

from repro.compat import abstract_mesh
from repro.configs import smoke_config as jsmoke_config
from repro.models import init_cache as jinit_cache
from repro.models import xlstm as jxlstm
from repro.parallel import sharding as jsharding
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import param_logical_axes
from repro_torch.parallel import sharding

AXES = ("data", "model")
PROMPT, DECODES, BATCH = 7, 3, 2
OUT_TOL = 1e-5
D96 = (("d_model", 96),)
CASES = {
    (1, 2): ((), D96),
    (2, 2): ((), D96),
    (1, 4): ((), D96, (("n_heads", 2), ("n_kv_heads", 2)), (("d_model", 36),),
             (("d_model", 33), ("n_heads", 3), ("n_kv_heads", 3))),
}
ALL_CASES = sorted({c for cases in CASES.values() for c in cases})
CS = chip_smoke()


@functools.cache
def _inputs(case):
    """(numpy params, x [B, PROMPT + DECODES, d], r [B, PROMPT, d])."""
    cfg = case_config(dict(case))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, PROMPT + DECODES, cfg.d_model), dtype=np.float32)
    return CS.lm_numpy_params(cfg, 0), x, rng.standard_normal((BATCH, PROMPT, cfg.d_model),
                                                               dtype=np.float32)


def _jcfg(case):
    import dataclasses

    return dataclasses.replace(jsmoke_config("xlstm-1.3b"), **dict(case))


def _run_reference(case):
    """The reference's unsharded blocks of a case: per kind its outputs, its
    final cache and the gradients (x and each mixer leaf) of sum(y · r)."""
    jcfg = _jcfg(case)
    host, xs, rs = _inputs(case)
    out = {}
    for kind, pos in block_positions(case_config(dict(case))).items():
        p = {k[len("mixer/"):]: jnp.asarray(v[0]) for k, v in host["units"][pos].items()
             if k.startswith("mixer/")}
        if kind == "mlstm":
            fn, cache = jxlstm.apply_mlstm, jxlstm.init_mlstm_cache(jcfg, BATCH)
        else:
            fn, cache = jxlstm.apply_slstm, jxlstm.init_slstm_cache(jcfg, BATCH)
        x = jnp.asarray(xs)
        y, cache = fn(jcfg, p, x[:, :PROMPT], cache=cache)
        ys = [np.asarray(y)]
        for i in range(PROMPT, PROMPT + DECODES):
            y, cache = fn(jcfg, p, x[:, i:i + 1], cache=cache)
            ys.append(np.asarray(y))
        gx, gp = jax.grad(lambda x, p: jnp.sum(fn(jcfg, p, x)[0] * rs), argnums=(0, 1))(
            x[:, :PROMPT], p)
        out[kind] = {"outputs": ys, "cache": [np.asarray(c) for c in cache],
                     "grads": {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}}
    return out


@functools.cache
def _pool():
    return concurrent.futures.ThreadPoolExecutor(max_workers=1)


@functools.cache
def _reference(case):
    return _pool().submit(_run_reference, case)


@functools.cache
def _ran(shape):
    """Each case of ``shape`` on every rank (the references run in a worker
    thread meanwhile)."""
    for case in ALL_CASES:
        _reference(case)
    cases = [(dict(case), *_inputs(case)) for case in CASES[shape]]
    with tempfile.TemporaryDirectory() as store:
        ranks = run_ranks(xlstm_rank, math.prod(shape), store_dir=store,
                          args=(shape, cases, PROMPT, DECODES), timeout=300)
    return {case: [r[i] for r in ranks] for i, case in enumerate(CASES[shape])}


def _coords(shape, rank) -> dict:
    return dict(zip(AXES, divmod(rank, shape[1])))


def _cut(arr, spec, shape, rank):
    """This rank's block of ``arr`` under a spec (entries cut row-major
    over their axes)."""
    sizes, coords = dict(zip(AXES, shape)), _coords(shape, rank)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = math.prod(sizes[a] for a in axes), 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        step = arr.shape[dim] // n
        arr = np.take(arr, range(idx * step, (idx + 1) * step), axis=dim)
    return arr


def _rows(shape, rank):
    return _cut(np.arange(BATCH), (("data",),), shape, rank)


def _cases():
    return [(shape, case) for shape, cases in CASES.items() for case in cases]


def _id(param):
    shape, case = param
    return f"{shape[0]}x{shape[1]}-" + ("-".join(f"{k}{v}" for k, v in case) or "smoke")


@pytest.mark.parametrize("shape_case", _cases(), ids=[_id(c) for c in _cases()])
def test_served_blocks_match_the_reference_and_its_cut_caches(shape_case):
    shape, case = shape_case
    ref = _reference(case).result()
    jcfg = _jcfg(case)
    shapes = jax.eval_shape(lambda: jinit_cache(jcfg, BATCH, PROMPT + DECODES))
    specs = jsharding.cache_pspecs(jcfg, abstract_mesh(shape, AXES), shapes)["units"]
    for rank, got in enumerate(_ran(shape)[case]):
        rows = _rows(shape, rank)
        for kind, pos in block_positions(case_config(dict(case))).items():
            want, mine = ref[kind], got[kind]
            for step, (t, w) in enumerate(zip(mine["outputs"], want["outputs"], strict=True)):
                np.testing.assert_allclose(t, w[rows], rtol=0,
                                           atol=OUT_TOL * float(np.abs(w).max()),
                                           err_msg=f"{case} {kind} rank {rank} step {step}")
            for i, (t, w, spec) in enumerate(zip(mine["cache"], want["cache"], specs[pos],
                                                 strict=True)):
                w = _cut(w, tuple(spec)[1:], shape, rank)
                assert t.shape == w.shape, (case, kind, i)
                np.testing.assert_allclose(t, w, rtol=0,
                                           atol=OUT_TOL + STATE_RTOL * float(np.abs(w).max()),
                                           err_msg=f"{case} {kind} rank {rank} cache {i}")


@pytest.mark.parametrize("shape_case", _cases(), ids=[_id(c) for c in _cases()])
def test_one_block_steps_gradients_match_jax_grad(shape_case):
    shape, case = shape_case
    ref = _reference(case).result()
    cfg = case_config(dict(case))
    specs = sharding.param_pspecs(cfg, sharding.AbstractMesh(shape, AXES))["units"]
    for rank, got in enumerate(_ran(shape)[case]):
        for kind, pos in block_positions(cfg).items():
            want, mine = ref[kind]["grads"], got[kind]["grads"]
            assert sorted(mine) == sorted(want)
            for name, t in mine.items():
                w = want[name]
                w = w[_rows(shape, rank)] if name == "x" else \
                    _cut(w, tuple(specs[pos][f"mixer/{name}"])[1:], shape, rank)
                assert t.shape == w.shape, (case, kind, name)
                err = float(np.abs(t - w).max()) / float(np.abs(want[name]).max())
                assert err <= GRAD_TOL, (case, kind, name, rank, err)


def _expected_decode(cfg, shape):
    """A decode step's collectives on a rank, in order: (kind, bytes, axis)."""
    m, b = shape[1], BATCH // shape[0]
    d, h = cfg.d_model, cfg.n_heads
    d_in = d * cfg.mlstm_expand
    f = int(d * cfg.slstm_proj)
    out = {"mlstm": [], "slstm": []}
    if m == 1:
        return out
    if d_in % m == 0:
        hd = d_in // h
        out["mlstm"] = ([("all-gather", 4 * b * 2 * d_in, "model"),
                         ("all-reduce", 4 * b * (3 * d_in + 2 * h), "model")] +
                        ([("all-reduce", 4 * b * h * (hd + 1), "model")] if hd % m == 0 else []) +
                        [("all-reduce", 4 * b * d, "model")])
    s = [("all-gather", 4 * b * 4 * d, "model")] if (4 * d) % m == 0 else []
    if h % m == 0:
        s.append(("all-gather", 4 * b * (d + h), "model"))     # y and the cache's m
    elif d % m == 0:
        s += [("all-gather", 4 * b * d, "model")] * 3           # c, n, h for the step
    if f % m == 0:
        s.append(("all-reduce", 4 * b * d, "model"))
    out["slstm"] = s
    return out


def _model_gather_bytes(case, shape, pos, labels):
    """The bytes the serving plan's gathers of unit position ``pos``'s
    leaves return over "model": each "gathered" leaf whose spec names
    "model", gathered over it from its stored block (an entry's axes last
    first, so over "model" before "data")."""
    sizes = dict(zip(AXES, shape))
    specs = sharding.param_pspecs(case_config(dict(case)),
                                  sharding.AbstractMesh(shape, AXES))["units"][pos]
    host = _inputs(case)[0]["units"][pos]
    total = 0
    for name, spec in specs.items():
        if labels[name] != "gathered":
            continue
        cur = 4 * host[name][0].size // math.prod(
            math.prod(sizes[a] for a in _axes(e)) for e in tuple(spec)[1:])
        for entry in tuple(spec)[1:]:
            for a in reversed(_axes(entry)):
                if sizes[a] > 1:
                    cur *= sizes[a]
                    total += cur if a == "model" else 0
    return total


@pytest.mark.parametrize("shape_case", _cases(), ids=[_id(c) for c in _cases()])
def test_labels_leaf_gathers_and_a_decode_steps_collectives(shape_case):
    shape, case = shape_case
    cfg = case_config(dict(case))
    specs = sharding.param_pspecs(cfg, sharding.AbstractMesh(shape, AXES))["units"]
    axes = param_logical_axes(cfg)
    replicated = (cfg.d_model * cfg.mlstm_expand) % shape[1] != 0
    want = _expected_decode(cfg, shape)
    for rank, got in enumerate(_ran(shape)[case]):
        for kind, pos in block_positions(cfg).items():
            mine = got[kind]
            for name, label in mine["labels"].items():
                spec, logical = specs[pos][name], axes["units"][pos][name]
                tp = any(e == "model" and ax in sharding._TP_AXES
                         for e, ax in zip(spec, logical, strict=True))
                whole = name in ("mixer/b_i", "mixer/b_f") or (kind == "mlstm" and replicated)
                if tp and name.startswith("mixer/"):
                    assert label == ("gathered" if whole else "local"), (case, kind, name)
            leaf = [e for e in mine["leaf_events"] if e["axis"] == "model"]
            assert all(e["kind"] == "all-gather" for e in leaf)
            assert sum(e["bytes"] for e in leaf) == \
                _model_gather_bytes(case, shape, pos, mine["labels"]), (case, kind)
            events = [(e["kind"], e["bytes"], e["axis"]) for e in mine["decode_events"]]
            assert events == want[kind], (case, kind, rank)
