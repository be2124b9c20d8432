"""Port parity: the checkpoint store (repro_torch.checkpoint).

Counterparts of tests/test_checkpoint.py, plus the on-disk format shared
with the JAX package: a checkpoint written by the reference's
``CheckpointStore`` restores in the port's bitwise, and one written by the
port's restores in the reference's.  Every comparison here is bitwise
(``.npy`` round-trips losslessly); the server cases run on the CPU with
the kernel wrappers' plain versions.
"""

import pathlib
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JCheckpointStore
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import _flatten, _unflatten


def _tree(x=0.0):
    return {"a": torch.tensor([1.0 + x, 2.0]),
            "b": {"c": torch.arange(6, dtype=torch.int32).reshape(2, 3) + int(x)}}


class _Pair(NamedTuple):
    left: torch.Tensor
    right: object


def test_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(5, _tree(1.0))
    step, restored = store.restore(_tree())
    assert step == 5
    np.testing.assert_array_equal(restored["a"], [2.0, 2.0])
    np.testing.assert_array_equal(restored["b"]["c"], np.arange(6).reshape(2, 3) + 1)
    _, on_dev = store.restore(_tree(), device="cpu")
    assert isinstance(on_dev["a"], torch.Tensor) and on_dev["b"]["c"].dtype == torch.int32


def test_integrity_fallback(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _tree(1.0))
    store.save(2, _tree(2.0))
    leaf = next((tmp_path / "step_0000000002").glob("leaf_*.npy"))
    leaf.write_bytes(b"garbage")
    step, restored = store.restore(_tree())
    assert step == 1
    np.testing.assert_array_equal(restored["a"], [2.0, 2.0])


def test_keep_k_gc(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _tree(float(s)))
    assert store.all_steps() == [3, 4]
    assert store.latest_step() == 4


def test_async_save(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = _tree(7.0)
    store.save_async(7, tree)
    tree["a"].fill_(-1.0)              # the host copy was taken at the call
    store.wait()
    step, restored = store.restore(_tree())
    assert step == 7
    np.testing.assert_array_equal(restored["a"], [8.0, 2.0])


def test_no_tmp_dir_left_behind(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(9, _tree())
    assert not list(pathlib.Path(tmp_path).glob("*.tmp"))


def test_restore_empty(tmp_path):
    store = CheckpointStore(tmp_path)
    step, restored = store.restore(_tree())
    assert step is None and restored is None


def test_flatten_follows_the_reference_leaf_order():
    """Dict keys sorted, sequences in order, None holds no leaf; the
    structure rebuilds dicts, lists, tuples and NamedTuples."""
    tree = {"z": 1, "a": (np.zeros(2), None, [torch.ones(1), 3.0]),
            "m": _Pair(torch.zeros(3), {"q": 5})}
    leaves, structure = _flatten(tree)
    assert [np.asarray(x).tolist() for x in leaves] == [[0.0, 0.0], [1.0], 3.0, [0.0] * 3, 5, 1]
    back = _unflatten(structure, leaves)
    assert back["a"][1] is None and isinstance(back["a"][2], list)
    assert isinstance(back["m"], _Pair) and back["m"].right == {"q": 5}


def test_checkpoint_format_is_the_references_both_ways(tmp_path):
    """A reference checkpoint restores in the port's store bitwise, and the
    port's in the reference's: same leaves, manifest and digests."""
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 4)).astype(np.float32),
              "i32": np.arange(5, dtype=np.int32), "b": np.array([True, False]),
              "u8": np.frombuffer(b"meta", np.uint8).copy()}
    JCheckpointStore(tmp_path / "ref").save(3, {k: jnp.asarray(v) for k, v in arrays.items()})
    template = {k: torch.zeros(1) for k in arrays}
    step, got = CheckpointStore(tmp_path / "ref").restore(template, device="cpu")
    assert step == 3
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k

    CheckpointStore(tmp_path / "port").save(4, {k: torch.from_numpy(v) for k, v in
                                                arrays.items()})
    step, back = JCheckpointStore(tmp_path / "port").restore(
        {k: jnp.zeros(1) for k in arrays})
    assert step == 4
    for k, v in arrays.items():
        assert np.asarray(back[k]).dtype == v.dtype and np.array_equal(back[k], v), k
    ref_manifest = (tmp_path / "ref" / "step_0000000003" / "manifest.json").read_text()
    assert '"sha256"' in ref_manifest and '"leaf_00000.npy"' in ref_manifest


def test_restore_rejects_a_template_of_another_arity(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        store.restore({"a": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the real serving payload: SessionState slab + host queue metadata
# ---------------------------------------------------------------------------


def _serving_pair(tmp_path, *, every=2):
    from repro_torch.core import SiliconMR
    from repro_torch.launch.serve_dfr import DFRServer, StreamRequest
    from repro_torch.pipeline.session import SessionConfig

    cfg = SessionConfig(model=SiliconMR(), n_nodes=16, washout=24,
                        ridge_l2=(1e-6, 1e-4), chunk_k=24, refresh_every=2,
                        state_method="kernel", use_kernel=True)
    server = DFRServer(cfg, 2, checkpoint_dir=str(tmp_path), checkpoint_every=every,
                       device="cpu")
    server.warmup()
    rng = np.random.default_rng(17)
    for r in range(3):
        server.submit(StreamRequest(rid=r, j=rng.random(5 * 24).astype(np.float32),
                                    y=rng.random(5 * 24).astype(np.float32)))
    return cfg, server


def test_session_slab_checkpoint_roundtrip_bit_exact(tmp_path):
    """Every SessionState leaf (f32/i32/bool) survives the round-trip bit
    for bit, and the host queue metadata comes back equal."""
    from repro_torch.launch.serve_dfr import DFRServer

    cfg, server = _serving_pair(tmp_path, every=0)
    for _ in range(3):
        server.step()
    server.save_checkpoint()
    server.close()

    resumed = DFRServer(cfg, 2, checkpoint_dir=str(tmp_path), device="cpu")
    assert resumed.restore() == server.tick
    for name, a, b in zip(server.state._fields, server.state, resumed.state):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert resumed.tick == server.tick
    assert resumed.counters == server.counters
    for sa, sb in zip(server.slots, resumed.slots):
        assert (sa is None) == (sb is None)
        if sa is not None:
            assert (sa.rid, sa.pos) == (sb.rid, sb.pos)
            np.testing.assert_array_equal(sa.j, sb.j)
    assert [r.rid for r in server.queue] == [r.rid for r in resumed.queue]


def test_corrupted_slab_checkpoint_falls_back_and_resumes_bit_exact(tmp_path):
    """Bit rot on the NEWEST slab checkpoint and a torn later write: restore
    walks back to the previous intact one, and the re-served predictions
    are bitwise those of an uninterrupted run."""
    from repro_torch.launch.serve_dfr import DFRServer

    cfg, ref = _serving_pair(tmp_path / "ref", every=0)
    ref.drain()
    expect = {r.rid: np.concatenate(r.y_hat) for r in ref.completed}

    cfg, crash = _serving_pair(tmp_path / "ck", every=2)
    for _ in range(5):
        crash.step()
    crash.close()
    steps = CheckpointStore(tmp_path / "ck").all_steps()
    assert steps == [2, 4]
    newest = tmp_path / "ck" / f"step_{steps[-1]:010d}"
    leaf = sorted(newest.glob("leaf_*.npy"))[0]
    leaf.write_bytes(leaf.read_bytes()[:-8] + b"deadbeef")
    (tmp_path / "ck" / "step_0000000006.tmp").mkdir()

    resumed = DFRServer(cfg, 2, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    resumed.warmup()
    assert resumed.restore() == steps[0]
    resumed.drain()
    got = {r.rid: np.concatenate(r.y_hat) for r in resumed.completed}
    assert set(got) == set(expect)
    for rid in expect:
        np.testing.assert_array_equal(expect[rid], got[rid])
