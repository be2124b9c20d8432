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


# MackeyGlass's helper-warp route (ops.helper_layout): one lane a block while
# the batch's blocks fit the card's 132 SMs, then the fewest of 2, 4 lanes
# that fit, else 8; its rows and handoff counts within a block's shared memory.
HELPER_LANES = {1: 1, 33: 1, 64: 1, 65: 1, 132: 1, 133: 2, 4096: 8}


@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per_lane"])
@pytest.mark.parametrize("n", [1, 31, 33, 100, 400, 900, 2420, 3412])
@pytest.mark.parametrize("b", sorted(HELPER_LANES))
def test_helper_layout_lanes_blocks_and_shared_memory(b, n, per_lane):
    lay = ops.helper_layout(b, n, per_lane)
    want = HELPER_LANES[b]
    while ops.helper_smem_bytes(want, n, per_lane, lay.group) > ops.SMEM_PER_BLOCK:
        want //= 2           # fewer lanes a block where the rows would not fit
    assert lay.lanes == want >= 1
    assert (lay.blocks - 1) * lay.lanes < b <= lay.blocks * lay.lanes
    assert lay.smem_bytes == ops.helper_smem_bytes(lay.lanes, n, per_lane, lay.group)
    assert lay.smem_bytes <= ops.SMEM_PER_BLOCK
    assert lay.stride == ops.row_stride(n) and lay.stride >= n
    # mbarriers and counts of every node group in whole 16 bytes, then the mask
    # (one row, or one a lane) and each lane's a row and two carry rows
    groups = ops.helper_groups(n, lay.group)
    rows = (lay.lanes if per_lane else 1) + 3 * lay.lanes
    assert lay.smem_bytes == -(-20 * groups // 16) * 16 + 4 * lay.stride * rows


@pytest.mark.parametrize("n", [1, 4, 31, 60, 100, 256, 400, 900, 2420, 3412, 14243])
def test_helper_groups_are_whole_chunks_of_the_unrolled_chain(n):
    """The chain's unrolled chunk (4·C nodes, C of 5, 4, 3 float4s) tiles the
    period where it can, a handoff group is whole chunks near 64 nodes, and
    every group but a lone one has at least a group's nodes (the last takes
    the remainder, under two groups' worth)."""
    chunk, group = ops.helper_chunk(n), ops.helper_group(n)
    assert group % chunk == 0 and 48 <= group <= 64
    if chunk > 4:
        assert n % chunk == 0
    else:
        assert all(n % (4 * c) for c in (3, 4, 5))
    groups = ops.helper_groups(n, group)
    last = n - (groups - 1) * group
    assert groups == max(1, n // group)
    assert (last == n) if groups == 1 else (group <= last < 2 * group)
    # the Fig. 5/6 widths take 20-node chunks and 60-node groups
    if n in (400, 900):
        assert (chunk, group, groups) == (20, 60, n // 60)


@pytest.mark.parametrize("per_lane", [False, True], ids=["broadcast", "per_lane"])
def test_helper_layout_raises_above_its_node_limit(per_lane):
    limit = ops.max_helper_nodes(per_lane)
    # no lower than the chain kernel's limit (3412 with one mask, 2420 per lane)
    assert limit >= ops.max_nodes(per_lane) and limit >= (2420 if per_lane else 3412)
    lay = ops.helper_layout(64, limit, per_lane)
    assert lay.smem_bytes <= ops.SMEM_PER_BLOCK and lay.lanes == 1
    with pytest.raises(ValueError, match=f"limit of {limit} nodes"):
        ops.helper_layout(64, limit + 1, per_lane)
    # the wrapper raises before it allocates or launches anything
    n = limit + 1
    j = torch.zeros(2, 3)
    mask = torch.zeros((2, n) if per_lane else (n,))
    with pytest.raises(ValueError, match="helper-warp route"):
        ops._launch(MackeyGlass(), j, mask, torch.zeros(2, n), torch.float32)


@pytest.mark.parametrize("b,n,per_lane", [(64, 400, False), (64, 900, False), (133, 100, True),
                                          (4096, 3412, False), (1, 1, True)])
def test_scan_plan_reports_the_launched_layout(b, n, per_lane):
    """The contract checker's plan is the layout each form launches under:
    MackeyGlass's helper-warp layout, the chain kernel's for the chain forms
    (``scan_layout`` unchanged), none for MZISine."""
    mg = ops.launch_layout(MackeyGlass(), b, n, per_lane)
    assert mg == ops.helper_layout(b, n, per_lane) and ops.scan_route(MackeyGlass()) == "helpers"
    assert ops.scan_plan(MackeyGlass(), b, n, per_lane) == {
        "smem_bytes": mg.smem_bytes, "row_bytes": 4 * mg.stride, "multi_tile": b > mg.lanes}
    for model in (SiliconMR(), SiliconMR(beta_tpa=0.7), SiliconMRLiteral()):
        lay = ops.launch_layout(model, b, n, per_lane)
        assert lay == ops.scan_layout(b, n, per_lane) and ops.scan_route(model) == "chain"
        assert ops.scan_plan(model, b, n, per_lane)["smem_bytes"] == lay.smem_bytes
    assert ops.launch_layout(MZISine(), b, n, per_lane) is None
    assert ops.scan_plan(MZISine(), b, n, per_lane)["smem_bytes"] == 0


def test_dfr_scan_at_needs_the_card():
    j, s0, mask = _inputs(2, 3, 8, (-1.0, 1.0))
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.dfr_scan_at(MackeyGlass(), torch.as_tensor(j), mask, torch.as_tensor(s0),
                        ops.scan_layout(2, 8, False))


# A step-by-step model of the helper-warp kernel's handoffs (csrc/dfr_scan.cu,
# helper_chain_chunks / helper_chain_nodes / helper_items), one block of L
# lanes: the chain and six helpers as coroutines that a seeded scheduler runs
# in random interleavings, an mbarrier's parity test as the hardware's (true
# once the phase of that parity completed), and every a and carry slot tagged
# with the period it holds, so that a read before its write, or a write over a
# value still to be read, fails.  It runs the kernel's index arithmetic on
# the CPU, where the kernel itself cannot run.
class _Mbar:
    def __init__(self, count):
        self.count, self.pending, self.phases = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phases, self.pending = self.phases + 1, self.count

    def test(self, parity):
        return self.phases % 2 != parity


def _model_helper_block(model, j, mask, s0, group, kernel_free, seed):
    import random

    b, k_periods = j.shape
    n = s0.shape[1]
    per_lane = mask.ndim == 2
    c = float(np.float32(model.kernel_spec()[1][0]))
    ng = ops.helper_groups(n, group)
    tiles = [cc for cc in (5, 4, 3) if ng >= 2 and n % (4 * cc) == 0 and group % (4 * cc) == 0]
    a_row = [[(0.0, None)] * n for _ in range(b)]          # (value, period)
    carry = [[[(0.0, None)] * n for _ in range(b)], [[(float(v), -1) for v in row] for row in s0]]
    done, paired = [_Mbar(b) for _ in range(ng)], [_Mbar(1) for _ in range(ng)]
    ready = [0] * ng
    out = torch.empty((b, k_periods, n))
    fin = torch.empty((b, n))

    def bounds(q):
        lo = q * group
        return lo, (lo + group if q + 1 < ng else n)

    def chain():
        s = [carry[1][l][n - 1][0] for l in range(b)]

        def step(i, got, k):     # node i of period k from the a read earlier
            for l in range(b):
                val, tag = got[l]
                assert tag == k, f"chain read a[{tag}] for period {k} at node {i}"
                s[l] = float(np.float32(np.float32(c) * np.float32(s[l])) + np.float32(val))
                carry[k % 2][l][i] = (s[l], k)

        if tiles:
            cq, ahead = tiles[0], 2
            nchunk, gc = n // (4 * cq), group // (4 * cq)
            last_gc = nchunk - (ng - 1) * gc
            while not paired[0].test(0):
                yield True
            load = lambda chunk, quad: [[a_row[l][4 * (chunk * cq + quad) + e] for l in range(b)]
                                        for e in range(4)]
            ring = [load(0, d) if d < ahead else None for d in range(cq)]
            cc = k = 0
            for g in range(k_periods * ng):
                q = g % ng
                last_q = q + 1 == ng
                n_chunks = last_gc if last_q else gc
                qn, parity = (0, (k + 1) % 2) if last_q else (q + 1, k % 2)
                more = g + 1 < k_periods * ng
                ready = not more or paired[qn].test(parity)   # tested as the group starts
                yield False
                for t in range(n_chunks):
                    if t + 1 == n_chunks and not ready:
                        while not paired[qn].test(parity):
                            yield True
                    nxt = 0 if t + 1 == n_chunks and last_q else cc + 1
                    for jj in range(cq):
                        src, quad = (cc, jj + ahead) if jj + ahead < cq else (nxt, jj + ahead - cq)
                        ring[(jj + ahead) % cq] = load(src, quad)
                        for e in range(4):
                            step(4 * (cc * cq + jj) + e, ring[jj][e], k)
                        yield False
                    cc = nxt
                for _ in range(b):
                    done[q].arrive()
                if last_q:
                    k += 1
        else:
            for k in range(k_periods):
                for q in range(ng):
                    while not paired[q].test(k % 2):
                        yield True
                    for i in range(*bounds(q)):
                        step(i, [a_row[l][i] for l in range(b)], k)
                        yield False
                    for _ in range(b):
                        done[q].arrive()

    def helper(h):
        for seq in range(h, (k_periods + 1) * ng, 6):
            k, q = divmod(seq, ng)
            if k > 0:
                while ready[q] < k or not done[q].test((k - 1) % 2):
                    yield True
            lo, hi = bounds(q)
            for l in range(b):
                for i in range(lo, hi):
                    val, tag = carry[(k + 1) % 2][l][i]
                    assert tag == k - 1, f"helper read s[{tag}] for period {k - 1}"
                    if k < k_periods:
                        m = mask[l, i] if per_lane else mask[i]
                        a_row[l][i] = (kernel_free(j[l, k], m, val), k)
                    if k > 0:
                        out[l, k - 1, i] = val
                    if k == k_periods:
                        fin[l, i] = val
                yield False
            ready[q] = k + 1
            if k < k_periods:
                paired[q].arrive()

    rng = random.Random(seed)
    actors = [chain()] + [helper(h) for h in range(6)]
    stalled = 0     # blocked steps in a row: every actor waiting for long is a deadlock
    while actors:
        a = rng.choice(actors)
        try:
            stalled = stalled + 1 if next(a) else 0
        except StopIteration:
            actors.remove(a)
            stalled = 0
        assert stalled < 10_000, "deadlock: every actor waits"
    return out, fin


def _mg_free(model):
    """free_part<MG>'s a from (j[k], m[i], s_tau), in the plain version's
    f32 ops."""
    one_minus = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(model.decay,
                                                                     dtype=torch.float32)

    def free(jk, m, s_tau):
        u = jk * m
        return float(one_minus * model._drive(u, torch.tensor(s_tau, dtype=torch.float32)))
    return free


@pytest.mark.parametrize("b,k,n,group,per_lane", [
    (1, 3, 120, 60, False),      # chunks of 5 float4s, two groups (the last 60)
    (2, 4, 200, 60, True),       # three groups, the last 80 nodes; two lanes a block
    (1, 3, 128, 64, False),      # chunks of 4 float4s
    (1, 3, 132, 60, True),       # chunks of 3 float4s
    (1, 5, 120, 20, False),      # one chunk a group: every chunk waits
    (3, 3, 33, 64, False),       # node by node: N not whole chunks, one group
    (1, 4, 100, 20, True)])      # node by node: group not whole chunks of 5
@pytest.mark.parametrize("seed", [0, 1])
def test_helper_route_handoffs_model_matches_plain(b, k, n, group, per_lane, seed):
    """Every interleaving the scheduler picks finishes (no deadlock), reads
    each a and carry value only once written and before it is overwritten,
    and gives the plain version's states and carry."""
    model = MackeyGlass()
    rng = np.random.default_rng(seed + n)
    j = torch.as_tensor(rng.uniform(-0.5, 0.5, (b, k)), dtype=torch.float32)
    s0 = torch.as_tensor(rng.uniform(0, 0.3, (b, n)), dtype=torch.float32)
    mask = torch.as_tensor(rng.choice((-1.0, 1.0), (b, n) if per_lane else (n,)),
                           dtype=torch.float32)
    out, fin = _model_helper_block(model, j, mask, s0, group, _mg_free(model), seed)
    want, want_fin = dfr_scan_plain(model, j, mask, s0)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(fin, want_fin, rtol=0, atol=1e-6)
