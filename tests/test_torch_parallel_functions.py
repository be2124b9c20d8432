"""The plan's autograd collectives (``parallel.sharding.Plan``) on gloo
ranks on the CPU, against one process's autograd on the whole tensors.

* Megatron's f (``copy_to_model``: identity, its gradient summed over
  "model") and g (``sum_model``: a sum over "model", its gradient passed
  as it is) around a column- then row-parallel MLP on (2,) and (2, 2)
  (rows split over "data"): the output and every gradient within 1e-5 of
  the largest of one process's.  f with an identity backward would leave
  each rank a part of x's gradient; g with a summing backward would double
  every gradient.
* A gather's two backwards: "slice", where every rank of the axis uses the
  gathered tensor alike, and "reduce-scatter", where they use it
  differently; each case is checked with the right kind and shown to fail
  with the other (a sum where a slice belongs doubles the gradient, a
  slice where a sum belongs drops the other rank's part).  On (2, 2) a
  block over ("data", "model") gathered by ``Plan.gather_to`` takes the
  kinds itself: reduce-scatter over "data", whose ranks see other rows,
  slice over "model".
* The vocab-parallel ``lm_loss`` (masked, with z-loss) on each rank's
  vocab block: its metrics and its block's gradient within 1e-6 of
  ``lm_loss`` on the whole logits of the rank's rows, the same on every
  model rank.
"""

import numpy as np
import pytest
import torch
from torch_parallel_train_ranks import gather_rank, megatron_mlp_rank, vocab_loss_rank

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import losses

TOL = 1e-5
LOSS_TOL = 1e-6
SHAPES = [(2,), (2, 2)]


def _rng(seed):
    return np.random.default_rng(seed)


def _data_rows(shape, rank, n):
    """The rows of n a rank of ``shape`` holds (cut over "data" on a 2-D
    mesh)."""
    if len(shape) == 1:
        return slice(0, n)
    d = rank // shape[1]
    return slice(d * n // shape[0], (d + 1) * n // shape[0])


def _close(got, want, tol, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("shape", SHAPES)
def test_f_and_g_around_a_tensor_parallel_mlp_give_one_processs_gradients(shape, tmp_path):
    rng = _rng(len(shape))
    x = rng.standard_normal((4, 6), dtype=np.float32)
    w1 = rng.standard_normal((6, 8), dtype=np.float32)
    w2 = rng.standard_normal((8, 5), dtype=np.float32)
    r = rng.standard_normal((4, 5), dtype=np.float32)
    tx, t1, t2 = (torch.as_tensor(a).requires_grad_(True) for a in (x, w1, w2))
    out = torch.tanh(tx @ t1) @ t2
    want = torch.autograd.grad((out * torch.as_tensor(r)).sum(), (tx, t1, t2))
    tp = shape[-1]
    ranks = run_ranks(megatron_mlp_rank, int(np.prod(shape)), store_dir=str(tmp_path),
                      args=(shape, x, w1, w2, r), timeout=60)
    for rank, (y, gx, g1, g2) in enumerate(ranks):
        rows, j = _data_rows(shape, rank, 4), rank % tp
        cols = slice(j * 8 // tp, (j + 1) * 8 // tp)
        _close(y, out.detach().numpy()[rows], TOL, f"out rank {rank}")
        _close(gx, want[0].numpy()[rows], TOL, f"dx rank {rank}")
        # the weights' gradients from this rank's rows only (the step sums them over "data")
        part = [torch.as_tensor(a).requires_grad_(True) for a in (x[rows], w1, w2)]
        own = torch.autograd.grad(((torch.tanh(part[0] @ part[1]) @ part[2])
                                   * torch.as_tensor(r[rows])).sum(), part[1:])
        _close(g1, own[0].numpy()[:, cols], TOL, f"dw1 rank {rank}")
        _close(g2, own[1].numpy()[cols], TOL, f"dw2 rank {rank}")


def _gathered_grads(shape, tmp_path, xs, cases):
    """(w, each rank's (gathered w, its block's gradient) a case)."""
    w = _rng(7).standard_normal((8, 3), dtype=np.float32)
    ranks = run_ranks(gather_rank, int(np.prod(shape)), store_dir=str(tmp_path),
                      args=(shape, w, xs, cases), timeout=60)
    return w, [[r[i] for r in ranks] for i in range(len(cases))]


def _block_grads_match(ranks, want, n_blocks):
    rows = want.shape[0] // n_blocks
    return all(np.allclose(g, want[r * rows:(r + 1) * rows], atol=1e-6, rtol=0)
               for r, (_full, g) in enumerate(ranks))


def test_a_gather_used_alike_by_every_rank_slices_its_gradient(tmp_path):
    x = _rng(1).standard_normal((8, 3), dtype=np.float32)
    w, got = _gathered_grads((2,), tmp_path, [x, x], [("slice",), ("reduce-scatter",)])
    for ranks in got:
        for full, _g in ranks:
            np.testing.assert_array_equal(full, w)
    # one process: d sum(w · x) / dw = x; a summed gradient doubles it
    assert _block_grads_match(got[0], x, 2)
    assert not _block_grads_match(got[1], x, 2)


def test_a_gather_used_differently_reduce_scatters_its_gradient(tmp_path):
    xs = _rng(2).standard_normal((2, 8, 3), dtype=np.float32)
    _w, got = _gathered_grads((2,), tmp_path, list(xs), [("reduce-scatter",), ("slice",)])
    # one process: d Σ_r sum(w · x_r) / dw = Σ_r x_r; a slice keeps x_rank only
    assert _block_grads_match(got[0], xs.sum(0), 2)
    assert not _block_grads_match(got[1], xs.sum(0), 2)


def test_the_plan_picks_each_axis_backward_on_a_2x2_mesh(tmp_path):
    """A block over ("data", "model") used whole, each data rank on its own
    rows (x_d): the gradient is Σ_d x_d cut into four blocks in the
    entry's row-major order.  The plan's kinds (slice over "model",
    reduce-scatter over "data") give it; swapping them does not."""
    xs = _rng(3).standard_normal((2, 8, 3), dtype=np.float32)
    cases = [None, ("slice", "reduce-scatter"), ("reduce-scatter", "slice"),
             ("reduce-scatter", "reduce-scatter")]
    _w, got = _gathered_grads((2, 2), tmp_path, list(xs), cases)
    assert [_block_grads_match(ranks, xs.sum(0), 4) for ranks in got] == \
        [True, True, False, False]


@pytest.mark.parametrize("shape", SHAPES)
def test_vocab_parallel_lm_loss_matches_lm_loss_on_the_whole_logits(shape, tmp_path):
    cfg = smoke_config("granite-8b")
    rng = _rng(11)
    b, s, v = 4, 6, cfg.vocab_size
    logits = rng.standard_normal((b, s, v), dtype=np.float32) * 3
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    tp = shape[-1]
    ranks = run_ranks(vocab_loss_rank, int(np.prod(shape)), store_dir=str(tmp_path),
                      args=(shape, logits, labels, mask), timeout=60)
    for rank, (metrics, g) in enumerate(ranks):
        rows, j = _data_rows(shape, rank, b), rank % tp
        whole = torch.as_tensor(logits[rows]).requires_grad_(True)
        loss, want = losses.lm_loss(cfg, whole, torch.as_tensor(labels[rows]),
                                    mask=torch.as_tensor(mask[rows]))
        (gw,) = torch.autograd.grad(loss, (whole,))
        want = {k: float(t.detach()) for k, t in want.items()}
        assert metrics["z_loss"] > 0
        for k, t in want.items():
            assert abs(metrics[k] - t) <= LOSS_TOL * max(1.0, abs(t)), (rank, k)
        cols = slice(j * v // tp, (j + 1) * v // tp)
        _close(g, gw.numpy()[..., cols], LOSS_TOL, f"rank {rank}")
        assert ranks[rank ^ 1][0] == metrics        # the same bits on the other model rank
