"""The port's synthetic token stream (``repro_torch.data``) against the JAX
package's ``repro.data``: the same numpy code, so batches are bitwise the
reference's for any (seed, step, hosts, host), and the prefetcher hands
them out in step order."""

import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import DataConfig, Prefetcher, host_batch


@pytest.mark.parametrize("seed,step,n_hosts,host_id", [(0, 0, 1, 0), (0, 7, 2, 0), (0, 7, 2, 1),
                                                      (3, 123, 4, 3), (11, 5, 1, 0)])
def test_host_batch_is_bitwise_the_references(seed, step, n_hosts, host_id):
    kw = dict(vocab_size=500, seq_len=96, global_batch=8, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    got = host_batch(DataConfig(**kw), step)
    want = jpipe.host_batch(jpipe.DataConfig(**kw), step)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == np.int32 and got[k].shape == (8 // n_hosts, 96)
        assert np.array_equal(got[k], want[k])
    assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])     # shifted


def test_hosts_draw_apart_and_the_batch_must_divide():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=8, n_hosts=2)
    a = host_batch(cfg, 3)["tokens"]
    b = host_batch(dataclasses.replace(cfg, host_id=1), 3)["tokens"]
    assert not np.array_equal(a, b)
    assert int(a.max()) < 64 and int(a.min()) >= 0
    with pytest.raises(ValueError, match="divide"):
        host_batch(DataConfig(vocab_size=64, seq_len=16, global_batch=7, n_hosts=2), 0)


def test_config_fields_match_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(DataConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jpipe.DataConfig)]


@pytest.mark.parametrize("start,depth", [(0, 2), (5, 1), (2, 4)])
def test_prefetcher_hands_out_batches_in_step_order(start, depth):
    cfg = DataConfig(vocab_size=100, seq_len=12, global_batch=4, seed=2)
    pf = Prefetcher(cfg, start_step=start, depth=depth)
    try:
        for want_step in range(start, start + 6):
            step, batch = pf.next()
            assert step == want_step
            ref = host_batch(cfg, step)
            assert all(np.array_equal(batch[k], ref[k]) for k in ref)
    finally:
        pf.close()
    assert not pf._thread.is_alive()
