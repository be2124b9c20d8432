"""Port parity: the continuous-batching DFR server (repro_torch.launch.serve_dfr).

Counterparts of the server cases of tests/test_serving.py and
tests/test_robustness.py, plus the server against the JAX package's
``DFRServer`` on the same streams.  On the CPU the port's kernel wrappers
take their plain versions.

Tolerances:

* port vs JAX server on the same streams: the same ticks, completed
  streams, counters and λ picks; predictions ≤0.05, 1/40 of the 4-PAM
  symbol spacing (readouts solved by two f32 eigh implementations from
  Grams that differ by f32 round-off, at λ down to 1e-8: 0.036 seen), and
  at most 1 decided symbol in 200 differs;
* within the port, bitwise: kill-and-restore (faults armed, replayed from
  their hash), the ingest counters, eviction.
"""

import numpy as np
import pytest
import torch

from repro.core import SiliconMR as JMR
from repro.launch.serve_dfr import DFRServer as JDFRServer
from repro.launch.serve_dfr import StreamRequest as JStreamRequest
from repro.pipeline.session import SessionConfig as JSessionConfig
from repro_torch.core import SiliconMR
from repro_torch.launch import serve_dfr
from repro_torch.launch.serve_dfr import (DFRServer, StreamRequest, _arr_from_json,
                                          _arr_to_json, channel_eq_requests)
from repro_torch.pipeline.session import SessionConfig
from repro_torch.robustness import no_faults, on_rows

N, WASH, CHUNK = 16, 24, 24
LAMS = (1e-8, 1e-6, 1e-4)


def _cfg(**kw) -> SessionConfig:
    base = dict(model=SiliconMR(), n_nodes=N, washout=WASH, ridge_l2=LAMS,
                chunk_k=CHUNK, refresh_every=2, state_method="kernel", use_kernel=True)
    base.update(kw)
    return SessionConfig(**base)


def _mk_requests(n, length, seed=0, cls=StreamRequest):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, j=rng.random(length).astype(np.float32),
                y=rng.random(length).astype(np.float32)) for r in range(n)]


def test_dfr_server_continuous_batching_end_to_end():
    cfg = _cfg(chunk_k=16, forgetting=0.99, refresh_every=2)
    server = DFRServer(cfg, batch=2, mask_seed=0, device="cpu")
    server.warmup()
    rng = np.random.default_rng(0)
    n_req, k = 5, 48
    for r in range(n_req):
        server.submit(StreamRequest(rid=r, j=rng.uniform(0, 1, k).astype(np.float32),
                                    y=rng.choice([-1.0, 1.0], k).astype(np.float32)))
    server.drain()
    assert len(server.completed) == n_req
    assert server.active == 0 and not server.queue
    assert sorted(r.rid for r in server.completed) == list(range(n_req))
    for req in server.completed:
        yh = np.concatenate(req.y_hat)
        assert yh.shape == (k,) and np.all(np.isfinite(yh))
    assert server.tick <= 9
    assert len(server.tick_seconds) == server.tick


def test_server_matches_reference_server_on_the_same_streams():
    """Channel-equalization streams of uneven length (a ragged last tick)
    through 3 slots, λ = 0.99: the port's server against the JAX
    package's, tick for tick."""
    kw = dict(n_nodes=N, washout=32, chunk_k=32, forgetting=0.99, refresh_every=4,
              ridge_l2=LAMS)
    reqs = channel_eq_requests(5, 256, 32, seed=3)
    reqs[1] = StreamRequest(rid=1, j=reqs[1].j[:200], y=reqs[1].y[:200])
    port = DFRServer(_cfg(**kw), 3, mask_seed=2, device="cpu")
    ref = JDFRServer(JSessionConfig(model=JMR(), state_method="fast", **kw), 3, mask_seed=2)
    for server, cls in ((port, StreamRequest), (ref, JStreamRequest)):
        server.warmup()
        for r in reqs:
            server.submit(cls(rid=r.rid, j=r.j.copy(), y=r.y.copy()))
        server.drain()
    assert port.stats() == ref.stats()
    assert [r.rid for r in port.completed] == [r.rid for r in ref.completed]
    np.testing.assert_array_equal(port.state.lam_idx.numpy(), np.asarray(ref.state.lam_idx))
    sym = np.asarray([-3.0, -1.0, 1.0, 3.0], np.float32)

    def decide(y):
        return sym[np.argmin(np.abs(y[:, None] - sym), axis=1)]

    yp = np.concatenate([np.concatenate(r.y_hat) for r in port.completed])
    yr = np.concatenate([np.concatenate(r.y_hat) for r in ref.completed])
    np.testing.assert_allclose(yp, yr, atol=0.05)
    assert np.mean(decide(yp) != decide(yr)) <= 1 / 200


def test_dfr_server_cli_smoke(capsys, tmp_path):
    args = ["--requests", "3", "--batch", "2", "--stream-len", "64", "--nodes", "16",
            "--washout", "16", "--chunk", "16", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    first = serve_dfr.main(args)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "streams/s" in out and "p99" in out
    assert len(first.completed) == 3 and first.device.type == "cpu"
    resumed = serve_dfr.main(args + ["--resume"])
    assert "resumed from checkpoint tick=" in capsys.readouterr().out
    assert resumed.restored_from == first.tick
    for a, b in zip(first.completed, resumed.completed):
        np.testing.assert_array_equal(np.concatenate(a.y_hat), np.concatenate(b.y_hat))


def test_server_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DFRServer(_cfg(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        no_faults(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_dfr.main(["--requests", "1", "--batch", "1"])


def test_lossless_json_helpers_round_trip():
    rng = np.random.default_rng(0)
    for a in (rng.standard_normal((3, 2)).astype(np.float32), np.arange(4, dtype=np.int32),
              np.array([np.nan, -np.inf, 0.1], np.float32)):
        b = _arr_from_json(_arr_to_json(a))
        assert b.dtype == a.dtype and b.tobytes() == a.tobytes()


# ---------------------------------------------------------------------------
# ingest validation, eviction, crash recovery
# ---------------------------------------------------------------------------


def test_server_ingest_drops_nonfinite_and_clamps():
    """The same counters as the reference server on the same requests."""
    results = {}
    for name, server, cls in (
            ("port", DFRServer(_cfg(), 2, ingest_range=(0.0, 1.0), device="cpu"),
             StreamRequest),
            ("reference", JDFRServer(JSessionConfig(
                model=JMR(), n_nodes=N, washout=WASH, ridge_l2=LAMS, chunk_k=CHUNK,
                refresh_every=2), 2, ingest_range=(0.0, 1.0)), JStreamRequest)):
        server.warmup()
        reqs = _mk_requests(2, 3 * CHUNK, seed=8, cls=cls)
        reqs[0].j[CHUNK + 3] = np.nan
        reqs[1].j[5] = 7.0
        reqs[1].y[2 * CHUNK + 1] = np.inf
        for r in reqs:
            server.submit(r)
        server.drain()
        results[name] = server.stats()
        for r in server.completed:
            assert np.isfinite(np.concatenate(r.y_hat)).all()
    stats = results["port"]
    assert stats == results["reference"]
    assert stats["dropped_ticks"] == 2 and stats["dropped_values"] == 2
    assert stats["clamped_values"] == 1 and stats["completed"] == 2
    assert stats["quarantine_events"] == 0


def test_ingest_clamps_only_real_samples_of_kept_rows():
    server = DFRServer(_cfg(chunk_k=4), 3, ingest_range=(0.5, 1.0), device="cpu")
    jc = np.array([[0.1, 0.7, 0.0, 0.0], [np.nan, 2.0, 0.0, 0.0], [0.6, 3.0, 0.7, 0.2]],
                  np.float32)
    yc = np.zeros_like(jc)
    nv = server._sanitize(jc, yc, np.array([2, 2, 4], np.int32))
    assert nv.tolist() == [2, 0, 4]
    np.testing.assert_array_equal(jc, np.array([[0.5, 0.7, 0.0, 0.0], [0.0] * 4,
                                                [0.6, 1.0, 0.7, 0.5]], np.float32))
    assert server.counters["clamped_values"] == 3
    assert server.counters["dropped_ticks"] == 1 and server.counters["dropped_values"] == 1


def test_server_evicts_dead_slot():
    spec = on_rows(no_faults(2, device="cpu"), [0], corrupt_prob=1.0)
    server = DFRServer(_cfg(), 2, fault_spec=spec, max_poison=2, device="cpu")
    server.warmup()
    for r in _mk_requests(2, 8 * CHUNK, seed=9):
        server.submit(r)
    server.drain()
    stats = server.stats()
    assert stats["evictions"] == 1 and len(server.evicted) == 1
    assert server.evicted[0].rid == 0
    assert stats["completed"] == 1
    assert stats["quarantine_events"] >= 2


def test_server_kill_and_restore_is_bit_exact(tmp_path):
    spec = on_rows(no_faults(2, device="cpu"), [1], nan_prob=0.02, until_tick=5)

    def fresh(ckpt=None, every=0):
        s = DFRServer(_cfg(), 2, fault_spec=spec, fault_seed=11, checkpoint_dir=ckpt,
                      checkpoint_every=every, device="cpu")
        s.warmup()
        return s

    ref = fresh()
    for r in _mk_requests(3, 5 * CHUNK, seed=10):
        ref.submit(r)
    ref.drain()
    expect = {r.rid: np.concatenate(r.y_hat) for r in ref.completed}

    crash = fresh(ckpt=str(tmp_path), every=2)
    for r in _mk_requests(3, 5 * CHUNK, seed=10):
        crash.submit(r)
    for _ in range(5):
        crash.step()
    crash.close()

    resumed = fresh(ckpt=str(tmp_path))
    assert resumed.restore() == 4
    assert resumed.stats()["restored_from"] == 4
    resumed.drain()
    got = {r.rid: np.concatenate(r.y_hat) for r in resumed.completed}
    assert set(got) == set(expect)
    for rid in expect:
        np.testing.assert_array_equal(expect[rid], got[rid])
    assert {k: v for k, v in resumed.counters.items() if k != "checkpoints_saved"} == \
        {k: v for k, v in ref.counters.items() if k != "checkpoints_saved"}


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint of the JAX server (its Gram padded to the TPU tile by
    its kernel fold) restores into the port's server, which serves on from
    it: its predictions follow the uninterrupted JAX run within the
    cross-package tolerance, and its counters and streams equal it."""
    kw = dict(n_nodes=N, washout=WASH, chunk_k=CHUNK, ridge_l2=LAMS, refresh_every=2)
    jcfg = JSessionConfig(model=JMR(), state_method="kernel", use_kernel=True, **kw)
    ref = JDFRServer(jcfg, 2, checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=2)
    ref.warmup()
    for r in _mk_requests(3, 5 * CHUNK, seed=12, cls=JStreamRequest):
        ref.submit(r)
    ref.drain()
    assert ref.state.g.shape[1] > N + 1                  # the reference's padded Gram
    resumed = DFRServer(_cfg(**kw), 2, checkpoint_dir=str(tmp_path / "ref"), device="cpu")
    assert resumed.restore(step=6) == 6
    assert resumed.state.g.shape == (2, N + 1, N + 1)
    resumed.drain()
    assert resumed.stats()["completed"] == ref.stats()["completed"]
    for a, b in zip(resumed.completed, ref.completed):
        assert a.rid == b.rid
        np.testing.assert_allclose(np.concatenate(a.y_hat), np.concatenate(b.y_hat),
                                   atol=0.05)


def test_chip_smoke_ser_band_comes_from_the_reference():
    """chip_smoke.py holds its B = 4096 and B = 512 drains on the card to a
    band around the JAX package's steady SER on the CPU (B = 64, the first
    64 streams of the repo's serving configuration, CLI seeds): this
    recomputes those constants, and the port's own steady SER on the CPU
    lies in the band."""
    import importlib.util
    import pathlib

    from repro_torch.launch.serve_dfr import online_ser

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    reqs = channel_eq_requests(64, cs.SERVE_STREAM, cs.SERVE_CHUNK, snr_db=cs.SERVE_SNR_DB)
    for lam, want in cs.SERVE_REF_STEADY_SER.items():
        kw = dict(n_nodes=cs.SERVE_N, washout=cs.SERVE_WASHOUT, chunk_k=cs.SERVE_CHUNK,
                  forgetting=lam, refresh_every=cs.SERVE_REFRESH, ridge_l2=cs.SERVE_LAMS)
        ref = JDFRServer(JSessionConfig(model=JMR(), state_method="fast", **kw), 64)
        port = DFRServer(_cfg(**kw), 64, device="cpu")
        for server, cls in ((ref, JStreamRequest), (port, StreamRequest)):
            server.warmup()
            for r in reqs:
                server.submit(cls(rid=r.rid, j=r.j.copy(), y=r.y.copy()))
            server.drain()
        assert online_ser(ref, cs.SERVE_WASHOUT)[1] == pytest.approx(want, abs=1e-12)
        assert abs(online_ser(port, cs.SERVE_WASHOUT)[1] - want) <= cs.SERVE_SER_BAND
