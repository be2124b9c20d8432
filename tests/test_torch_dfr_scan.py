"""Port parity: the DFR scan op (repro_torch.kernels.dfr_scan).

On CPU tensors the wrapper takes the kernel's plain version; it is held
against the JAX Pallas kernel run in interpret mode (as the reference's own
tests run it on CPU) at small shapes: ≤1e-6 for SiliconMR, ≤1e-5 for the
models that call pow/sin, ≤4e-2 for bf16 states (bf16 has 8 bits of
mantissa; the carry stays f32).  The CUDA kernel itself is checked against
the same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py);
its block layout (``ops.scan_layout``), chosen in Python, is tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MZISine as JMZI
from repro.core import MackeyGlass as JMG
from repro.core import SiliconMR as JMR
from repro.core import SiliconMRLiteral as JLit
from repro.kernels.dfr_scan import dfr_scan as jdfr_scan
from repro_torch.core import MackeyGlass, MZISine, SiliconMR, SiliconMRLiteral, make_mask
from repro_torch.kernels.dfr_scan import dfr_scan, dfr_scan_plain, dfr_scan_ref, ops

PAIRS = [(SiliconMR(), JMR(), (0.0, 1.0), 1e-6),
         (SiliconMR(beta_tpa=0.7), JMR(beta_tpa=0.7), (0.0, 1.0), 1e-6),
         (SiliconMRLiteral(), JLit(), (0.0, 1.0), 1e-5),
         (MackeyGlass(), JMG(), (-1.0, 1.0), 1e-5),
         (MZISine(), JMZI(), (0.0, 1.0), 1e-5)]
IDS = ["mr", "mr_tpa", "literal", "mg", "mzi"]


def _inputs(b, k, n, levels=(0.0, 1.0)):
    rng = np.random.default_rng(b * 100 + k * 10 + n)
    j = rng.uniform(0, 1, (b, k)).astype(np.float32)
    s0 = rng.uniform(0, 0.3, (b, n)).astype(np.float32)
    return j, s0, make_mask(n, levels=levels, seed=2)


@pytest.mark.parametrize("b,k,n", [(1, 5, 7), (3, 11, 17), (8, 32, 24)])
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_dfr_scan_matches_pallas_interpret(pair, b, k, n):
    pm, jm, levels, tol = pair
    j, s0, mask = _inputs(b, k, n, levels)
    got, fin = dfr_scan(pm, torch.as_tensor(j), mask, torch.as_tensor(s0), return_final=True)
    want, want_fin = jdfr_scan(jm, jnp.asarray(j), jnp.asarray(mask.numpy()),
                               jnp.asarray(s0), return_final=True, interpret=True)
    # the printed (literal) model grows geometrically: its bound is relative
    literal = isinstance(pm, SiliconMRLiteral)
    scale = max(1.0, float(np.abs(np.asarray(want)).max())) if literal else 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol * scale)
    np.testing.assert_allclose(fin.numpy(), np.asarray(want_fin), rtol=0, atol=tol * scale)


def test_dfr_scan_per_lane_mask_matches_pallas_interpret():
    b, k, n = 5, 7, 24
    j, s0, _ = _inputs(b, k, n)
    masks = torch.stack([make_mask(n, seed=20 + i) for i in range(b)])
    got = dfr_scan(SiliconMR(), torch.as_tensor(j), masks, torch.as_tensor(s0))
    want = jdfr_scan(JMR(), jnp.asarray(j), jnp.asarray(masks.numpy()), jnp.asarray(s0),
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_dfr_scan_bf16_states_match_pallas_interpret():
    b, k, n = 4, 6, 9
    j, s0, mask = _inputs(b, k, n)
    got, fin = dfr_scan(SiliconMR(), torch.as_tensor(j), mask, torch.as_tensor(s0),
                        out_dtype=torch.bfloat16, return_final=True)
    want = jdfr_scan(JMR(), jnp.asarray(j), jnp.asarray(mask.numpy()), jnp.asarray(s0),
                     out_dtype=jnp.bfloat16, interpret=True)
    assert got.dtype == torch.bfloat16 and fin.dtype == torch.float32
    oracle = dfr_scan_ref(SiliconMR(), torch.as_tensor(j), mask, torch.as_tensor(s0))
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(), atol=4e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=4e-2)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_dfr_scan_chunked_resume_bitwise(pair):
    pm = pair[0]
    j, s0, mask = _inputs(3, 13, 9, pair[2])
    jt, s0t = torch.as_tensor(j), torch.as_tensor(s0)
    full, fin_full = dfr_scan(pm, jt, mask, s0t, return_final=True)
    chunks, s = [], s0t
    for lo, hi in ((0, 5), (5, 9), (9, 13)):
        st, s = dfr_scan(pm, jt[:, lo:hi], mask, s, return_final=True)
        chunks.append(st)
    assert torch.equal(torch.cat(chunks, dim=1), full)
    assert torch.equal(s, fin_full)


def test_dfr_scan_plain_is_the_oracle_with_casts():
    j, s0, mask = _inputs(2, 4, 5)
    jt = torch.as_tensor(j).to(torch.bfloat16)
    st, fin = dfr_scan_plain(SiliconMR(), jt, mask, torch.as_tensor(s0))
    assert st.dtype == torch.bfloat16 and fin.dtype == torch.bfloat16
    oracle = dfr_scan_ref(SiliconMR(), jt.float(), mask, torch.as_tensor(s0))
    assert torch.equal(st, oracle.to(torch.bfloat16))


def test_dfr_scan_rejects_bad_arguments():
    j, s0, mask = _inputs(4, 3, 5)
    jt, s0t = torch.as_tensor(j), torch.as_tensor(s0)
    with pytest.raises(ValueError, match="block_s"):
        dfr_scan(SiliconMR(), jt, mask, s0t, block_s=3)
    with pytest.raises(ValueError, match="per-lane mask"):
        dfr_scan(SiliconMR(), jt, torch.zeros(3, 5), s0t)
    with pytest.raises(ValueError, match="do not match"):
        dfr_scan(SiliconMR(), jt, mask, s0t[:, :4])
    with pytest.raises(NotImplementedError, match="no form"):
        ops._launch(object(), jt, mask, s0t, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops._launch(SiliconMR(), jt, mask, s0t, torch.float16)
    before = dfr_scan.launches
    dfr_scan(SiliconMR(), jt, mask, s0t)
    assert dfr_scan.launches == before   # the plain version is not a launch


# The CUDA kernel's block layout (ops.scan_layout), reached here without a card:
# the shapes of every path that launches the kernel, and the edges of the grid
# that tests/test_torch_cuda.py and chip_smoke.py run on the card.
PATH_SHAPES = [(64, 900, False),   # NARMA10, materialized and streamed
               (64, 30, False),    # channel equalisation
               (64, 100, True),    # 64-channel WDM
               (8, 100, True),     # WDM shared readout
               (8, 32, False), (4, 40, False), (37, 45, False), (4, 32, True)]


@pytest.mark.parametrize("b,n,per_lane", PATH_SHAPES
                         + [(b, n, pl) for b in (1, 33, 64, 65, 4096) for n in (1, 31, 32, 33)
                            for pl in (False, True)])
def test_scan_layout_fits_shared_memory(b, n, per_lane):
    lay = ops.scan_layout(b, n, per_lane)
    assert lay.lanes == ops.LANES_PER_BLOCK == 8
    assert lay.smem_bytes <= 232_448
    assert (lay.blocks - 1) * lay.lanes < b <= lay.blocks * lay.lanes
    # two carry rows a lane (this period's, the one before) and the mask rows
    rows = 3 * lay.lanes if per_lane else 2 * lay.lanes + 1
    assert lay.smem_bytes == 4 * rows * lay.stride
    # whole float4s a row, an odd count of them: eight lanes' float4s in distinct banks
    assert lay.stride >= n and lay.stride % 8 == 4
    assert len({(lane * lay.stride // 4) % 8 for lane in range(8)}) == 8


def test_scan_layout_spreads_b64_over_more_than_two_blocks():
    for n, per_lane in ((900, False), (100, True), (30, False)):
        lay = ops.scan_layout(64, n, per_lane)
        assert lay.blocks > 2 and lay.lanes == 8
    # every batch gets blocks of 8 lanes
    assert ops.scan_layout(4096, 100, False) == (8, 512, 100, 4 * 100 * 17)
    assert ops.scan_layout(65, 900, True) == (8, 9, 900, 4 * 900 * 24)


@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per_lane"])
def test_scan_layout_raises_above_the_node_limit(per_lane):
    limit = ops.max_nodes(per_lane)
    assert limit >= 2400   # far above the N = 900 of the paper's operating point
    lay = ops.scan_layout(64, limit, per_lane)
    assert lay.smem_bytes <= ops.SMEM_PER_BLOCK and lay.lanes == 8
    with pytest.raises(ValueError, match=f"limit of {limit} nodes"):
        ops.scan_layout(64, limit + 1, per_lane)
    # the wrapper raises before it allocates or launches anything
    n = limit + 1
    j = torch.zeros(2, 3)
    mask = torch.zeros((2, n) if per_lane else (n,))
    with pytest.raises(ValueError, match="limit"):
        ops._launch(SiliconMR(), j, mask, torch.zeros(2, n), torch.float32)
