// K1ᵀ: the adjoint of the SiliconMR DFR scan (dfr_scan.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's LM mixer is a lax.scan that
// jax.grad differentiates (src/repro/core/layer.py:71-84); the port's mixer
// runs its forward on the hand-written scan kernel K1, whose output has no
// autograd graph, so its gradient needs a kernel of its own:
// repro_torch/core/layer.py wraps K1 in a torch.autograd.Function whose
// backward launches this one.
//
// For one lane, K1 computes, for period k and node i (s[-1, .] = s0,
// prev(k, 0) = s[k-1, N-1], prev(k, i) = s[k, i-1]):
//     u = j[k] m[i];  P = u + gamma s[k-1, i];  D = P / (1 + beta P) (D = P at beta = 0)
//     c[k, i] = (u > prev) ? 1 : (1 - alpha);  s[k, i] = alpha D + c prev
// The branch condition passes no gradient.  With g the gradient of the
// states and g_fin that of the final state, the adjoint runs the chain
// backwards, periods K-1 -> 0 and nodes N-1 -> 0:
//     lam[k, i] = a[k, i] + c' lam'        (the chain: one mul, one add)
//     a[k, i]   = g[k, i] + q[k+1, i]      (q[K, .] = g_fin)
//     gp[k, i]  = alpha lam[k, i] D'(P[k, i]),  D' = 1 / (1 + beta P)^2 (1 at beta = 0)
//     q[k, i]   = gamma gp[k, i];   dj[k] = sum over i = N-1 .. 0 of m[i] gp[k, i]
//     ds0[i]    = q[0, i], plus c[0, 0] lam[0, 0] at i = N-1
// where c' lam' is c[k, i+1] lam[k, i+1], or c[k+1, 0] lam[k+1, 0] at
// i = N-1 (0 for the last period).  The branch bits are recomputed from
// the f32 states K1 emitted, with K1's own ops (a bf16 state could flip
// one), strict `>`, a NaN taking the discharge branch as in the forward.
//
// What bounds it: the chain.  Each lane is K*N dependent steps of a mul and
// an add (dfr_scan.cu's dfr_scan_chain_probe, form 4, times the step on the
// card: 8.28 cycles), and lanes are the only parallel axis: the LM's
// microbatch gives 24.  At [24, 512, 256] the chain bound is about
// 0.55 ms at 1980 MHz, while the 25 MB it reads take 7.5 us (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md §6).  The kernel before this design took
// 1.81 ms there, 27 cycles a node: its chain thread also issued every
// chain-free op of a node, and one __syncthreads a period handed over rows
// staged by 4-byte copies from a transposed copy of the inputs.
//
// Design: warp-specialised, a block of L lanes (ops.grad_layout: one lane a
// block while the batch's blocks fit the card's SMs), eight warps:
//   * warp 0, the chain: lane l runs lane l's recurrence and nothing else.
//     Each node it reads a precomputed pair (a[k, i], c'[k, i]) from two
//     rows in shared memory, as float4s of four nodes loaded kAhead float4s
//     ahead, and writes lam[k, i] back over a[k, i].  It is alone on its
//     sub-partition (warp 4 only waits at the block's end), every lane of it
//     runs (lanes past the block's live lanes shadow lane 0 and store
//     nothing), so it never diverges, and it issues no warp barrier and no
//     fence: each lane arrives on `done` for its own stores.  When a period
//     is two or more whole groups, the chain is one stream over all of
//     them, unrolled a group at a time, prefetching across group edges;
//   * warps 1, 2, 5 and 6, the helpers, do every chain-free op, trailing
//     the chain: a period's nodes fall into groups of G, and once the chain
//     has written lam[k, .] of a group, a helper warp turns it, in place,
//     into a[k-1, .] = g[k-1, .] + gamma gp[k, .] and the branch factors
//     c'[k-1, .] of the same nodes, and writes the terms m[i] gp[k, i] of
//     dj[k].  Node i of period k-1 needs only node i of period k, so the
//     chain comes back to the group N nodes after it left it: a helper has
//     N - G nodes of chain time for its group.  The groups of all periods
//     go to the helper warps in turn, so four are in flight at once; a
//     group is one warp's, four nodes of one lane a thread, in the plain
//     version's op order;
//   * warp 3, the summer: lane l sums lane l's terms of period k over nodes
//     N-1 -> 0 from 0 (the plain version's order) one period behind, from
//     two term rows that alternate by period;
//   * warp 7, the stager: each period's state row and gradient row of a
//     lane are N contiguous floats of the caller's [B, K, N] tensors (K1's
//     own layout: the wrapper copies nothing), staged into a ring of
//     `depth` slots by one bulk copy a row (cp.async.bulk, completion on
//     the slot's mbarrier) with the lane's j[p], j[p+1], ahead of the
//     helpers.  Rows that are not whole 16-byte units or start off 16 bytes
//     (N not a multiple of 4, or an input not 16-byte aligned) take 4-byte
//     cp.async copies of the whole warp, completing on the same mbarrier;
//   * the handoffs: monotonic counts in shared memory (release stores,
//     acquire loads) where a waiter may run ahead of the phase it wants,
//     mbarriers where the chain waits or signals (an arrival stalls it for
//     no fence, a test for no load; see Shared).  Waiting warps other than
//     the chain sleep between polls.  A wait of seconds traps;
//   * g_fin enters as the a rows' first content and q of period 0 leaves
//     through them: after the chain, the a rows hold ds0, whose node N-1
//     takes one more chain step with c[0, 0], and the block writes dj and
//     ds0 as [B, K] and [B, N] itself;
//   * rows are whole float4s, an odd count of them (ops.row_stride), so
//     eight lanes' float4s fall in distinct banks.
// At [24, 512, 256] this takes 0.71 ms, 10.7 cycles a node against the
// chain's 8.3 (PERF.md PR 25, which also lists the designs measured on the
// way: one handoff a group through all helpers in step, parity waits on
// mbarriers that a helper could outrun, compiler-scheduled prefetch, a
// diverged chain warp).
//
// Numerics: every product, sum and quotient is a separately rounded
// __fmul_rn/__fadd_rn/__fdiv_rn (and the build passes -fmad=false), in the
// plain version's op order, so the two agree bitwise.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
// Warp roles: warp w runs on sub-partition w % 4, and the chain's, 0, is
// alone on its sub-partition (warp 4 waits at the block's end); the summer,
// the stager and the helpers share sub-partitions 1-3.
constexpr int kChainWarp = 0;
constexpr int kIdleWarp = 4;
constexpr int kSummerWarp = 3;
constexpr int kStagerWarp = 7;
constexpr int kHelpers = 4;  // warps 1, 2, 5, 6
constexpr int kMaxLanes = kWarp;
constexpr int kStaticSmem = 48 * 1024;       // above this, dynamic shared memory needs opting in
constexpr long long kWaitLimit = 1LL << 34;  // cycles: 8.7 s at 1980 MHz
constexpr int kHelperSleepNs = 32;           // a helper's poll (a group is 250 ns of chain)
constexpr int kIdleSleepNs = 128;            // the summer's and the stager's
constexpr int kAhead = 2;                    // float4s of pairs the chain loads ahead
constexpr int kTestAt = 1;  // the chain tests the next group's pairs kTestAt quarters in

// The helper index of a warp, -1 for another role.
__device__ __forceinline__ int helper_of(int warp) {
  if (warp == kChainWarp || warp == kIdleWarp || warp == kSummerWarp || warp == kStagerWarp) {
    return -1;
  }
  return warp < kIdleWarp ? warp - 1 : warp - 3;
}

struct Consts {
  float alpha, gamma, beta, keep;  // keep = 1 - alpha, in f32
};

// The block's shared memory: mbarriers (shared-window addresses of the
// first of each array), each slot's j[p], j[p+1] of its L lanes, the
// handoff counts, then rows of `stride` floats: the mask, and for each lane
// its a row, its c' row, two term rows, and `depth` state and gradient
// slots.  A count only grows, so a wait for "at least n" cannot be met by
// an earlier or a later round, however far ahead of the others a warp
// runs.  An mbarrier's wait names a phase by its parity, so a waiter must
// know that the phase before it has completed: only the stager waits on `full` and
// only the chain on `paired`, each in order, and a helper waits on `done`
// of a group only once `ready` shows the group's previous transition done,
// which waited on the phase before.
struct Shared {
  uint32_t full;          // [depth] mbarriers: a slot's rows have landed
  uint32_t done;          // [ng] mbarriers: a period's lam of node group q are written
  uint32_t paired;        // [ng] mbarriers: a transition's pairs of node group q are written
  float2* j;              // [depth][L]
  unsigned* ready;        // [ng] transitions whose pairs of node group q are written
  unsigned* slot_groups;  // [depth] groups done on a slot's rows
  unsigned* term_groups;  // [2] groups whose terms a term row holds
  unsigned* summed;       // periods whose dj is written
  unsigned* staged;       // periods whose rows have landed
  float *mask, *a, *c, *t, *s, *g;  // first row of each region
  int lanes, rows;                  // L; floats of a region of L rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bar(uint32_t base, int index) { return base + 8 * index; }

__device__ __forceinline__ void bar_init(uint32_t b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(count) : "memory");
}

// Whether the phase of parity `parity` of mbarrier `b` has completed (no
// wait).
__device__ __forceinline__ bool bar_test(uint32_t b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;"
      " selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(b), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned get(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];"
               : "=r"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void put(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
}

__device__ __forceinline__ void add(unsigned* p, unsigned v) {
  asm volatile("red.release.cta.shared::cta.add.u32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
}

// A wait of more than kWaitLimit cycles (seconds: no handoff of a working
// block takes more than a period) traps, so a broken handoff ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void check_wait(long long t0) {
  if (clock64() - t0 > kWaitLimit) __trap();
}

// Waits until count `p` is at least `v`, polling every kSleepNs ns (0: a
// tight spin, the chain's).  Off the chain, a poll that is not met
// sleeps, so that waiting warps leave the issue slots and the shared
// memory to the warps at work.
template <int kSleepNs = 0>
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned v) {
  if (get(p) >= v) return;
  const long long t0 = clock64();
  while (get(p) < v) {
    if constexpr (kSleepNs > 0) __nanosleep(kSleepNs);
    check_wait(t0);
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
}

// One row of `bytes` (whole 16-byte units, both ends 16-byte aligned) from
// global into shared memory, completing on mbarrier `b`.
__device__ __forceinline__ void bulk_row(float* dst, const float* src, uint32_t bytes, uint32_t b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Arrives on `b` once every cp.async this thread issued has landed.
__device__ __forceinline__ void copies_arrive(uint32_t b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(b) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void st4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ float step(float a, float c, float lam) {
  return __fadd_rn(a, __fmul_rn(c, lam));
}

// Shared-memory float4s for the chain, issued in program order (volatile),
// so that the compiler keeps each prefetch kAhead float4s before its use.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ void sts4(float* p, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(smem_addr(p)), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The chain when every node group is whole (N a multiple of G, at least
// two groups): one stream of float4s over all periods, the pairs of the
// float4 kAhead places on loaded before this one's chain runs, across
// group edges, every load and store of a group at a constant offset.  The
// next group's pairs are tested a quarter into this one (`paired`, whose test
// does not stall the chain as a load with acquire semantics does) and
// waited for only if they were not written, before their first load.
template <int G>
__device__ float chain_whole(const Shared& sh, float* a, const float* c, int K, int ng,
                             bool mine) {
  constexpr int kQuads = G / 4;
  static_assert(G % 4 == 0 && kQuads % kAhead == 0 && kQuads > 2 * kAhead,
                "a group is whole rounds of the prefetch ring");
  const auto wait_paired = [&](int q, unsigned parity) {
    if (bar_test(bar(sh.paired, q), parity)) return;
    const long long t0 = clock64();
    while (!bar_test(bar(sh.paired, q), parity)) check_wait(t0);
  };
  float lam = 0.0f;  // c' lam' into the last node: 1 * 0
  wait_paired(ng - 1, 0);
  float4 ra[kAhead], rc[kAhead];  // float4 j of a group in slot j % kAhead
  const int top = (ng - 1) * G;
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    ra[d] = lds4(a + top + G - 4 - 4 * d);
    rc[d] = lds4(c + top + G - 4 - 4 * d);
  }
  // period K-1-kk, node group q; its pairs are transition kk's
  int kk = 0, q = ng - 1;
  for (int s = K * ng - 1; s >= 0; --s) {
    float* const ga = a + q * G;
    const float* const gc = c + q * G;
    // the next group: q-1 of this period, or ng-1 of the next (transition kk+1)
    const bool last = s == 0;
    const int qn = q > 0 ? q - 1 : ng - 1;
    const unsigned parity = (q > 0 ? kk : kk + 1) & 1;
    const float* const na = a + qn * G;
    const float* const nc = c + qn * G;
    bool ready = true;
#pragma unroll
    for (int j = 0; j < kQuads; ++j) {
      const int i0 = G - 4 - 4 * j, slot = j % kAhead;
      if (j == kQuads * kTestAt / 4 && !last) ready = bar_test(bar(sh.paired, qn), parity);
      const float4 a4 = ra[slot], c4 = rc[slot];
      if (j + kAhead < kQuads) {
        ra[slot] = lds4(ga + i0 - 4 * kAhead);
        rc[slot] = lds4(gc + i0 - 4 * kAhead);
      } else if (!last) {
        if (j + kAhead == kQuads && !ready) wait_paired(qn, parity);
        const int nx = G - 4 - 4 * (j + kAhead - kQuads);
        ra[slot] = lds4(na + nx);
        rc[slot] = lds4(nc + nx);
      }
      float4 out;
      out.w = lam = step(a4.w, c4.w, lam);
      out.z = lam = step(a4.z, c4.z, lam);
      out.y = lam = step(a4.y, c4.y, lam);
      out.x = lam = step(a4.x, c4.x, lam);
      if (mine) sts4(ga + i0, out);
    }
    if (mine) bar_arrive(bar(sh.done, q));  // each lane for its own stores: no warp barrier
    if (q > 0) {
      --q;
    } else {
      q = ng - 1;
      ++kk;
    }
  }
  return lam;
}

// The chain warp: lane tl's reverse chain over every period, group by
// group, each group's pairs waited for on `ready` and its lam announced on
// `done`.  Whole groups of 64 or 128 nodes take chain_whole; otherwise
// each group's nodes above its last whole float4 go one by one, then its
// float4s, loaded two ahead.  Returns lam[0, 0].
__device__ float chain_role(const Shared& sh, int K, int N, int ng, int group, int stride,
                           int tl, int live) {
  // every lane of the warp runs, so that it never diverges; lanes past the
  // block's live lanes shadow lane 0 and store nothing
  const bool mine = tl < live;
  float* const a = sh.a + (mine ? tl : 0) * stride;
  const float* const c = sh.c + (mine ? tl : 0) * stride;
  if (N % group == 0 && ng >= 2) {  // with one group, its next is itself: no run-ahead
    if (group == 64) return chain_whole<64>(sh, a, c, K, ng, mine);
    if (group == 128) return chain_whole<128>(sh, a, c, K, ng, mine);
  }
  float lam = 0.0f;  // c' lam' into the last node: 1 * 0
  for (int k = K - 1; k >= 0; --k) {
    for (int q = ng - 1; q >= 0; --q) {
      const int lo = q * group, hi = min(N, lo + group);
      const int top = lo + ((hi - lo) & ~3);  // nodes [top, hi) one by one, then float4s
      wait_for(sh.ready + q, K - k);          // transitions K .. k+1
      for (int i = hi - 1; i >= top; --i) {
        lam = step(a[i], c[i], lam);
        if (mine) a[i] = lam;
      }
      if (top > lo) {
        int i0 = top - 4;
        const int i1 = max(i0 - 4, lo);
        float4 a0 = ld4(a + i0), c0 = ld4(c + i0), a1 = ld4(a + i1), c1 = ld4(c + i1);
        for (; i0 >= lo; i0 -= 4) {
          // two fours down (clamped onto the group's bottom four, unused there)
          const int nx = max(i0 - 8, lo);
          const float4 an = ld4(a + nx), cn = ld4(c + nx);
          float4 out;
          out.w = lam = step(a0.w, c0.w, lam);
          out.z = lam = step(a0.z, c0.z, lam);
          out.y = lam = step(a0.y, c0.y, lam);
          out.x = lam = step(a0.x, c0.x, lam);
          if (mine) st4(a + i0, out);
          a0 = a1;
          c0 = c1;
          a1 = an;
          c1 = cn;
        }
      }
      if (mine) bar_arrive(bar(sh.done, q));
    }
  }
  return lam;
}

// Nodes i0 .. i0+3 of one lane's transition from period k to k-1: lam[k]
// (g_fin at k = K) in `a` becomes a[k-1] (q[0] at k = 0), `c` gets
// c'[k-1] (at k = 0 only node N-1's, c[0, 0]), `t` the terms m gp[k] of
// dj[k] (k < K).  s: the states of period k-1 (s0 at k = 0); g: the
// gradient of period k-1; jk = j[k], jp = j[k-1] where they exist.
template <bool TPA>
__device__ __forceinline__ void transition4(float* a, float* c, float* t, const float* s,
                                            const float* g, const float* msk, int i0, int N,
                                            int k, int K, float jk, float jp,
                                            const Consts& cs) {
  const float4 x4 = ld4(a + i0), s4 = ld4(s + i0), m4 = ld4(msk + i0);
  const float4 g4 = k > 0 ? ld4(g + i0) : float4{};
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
  const float m[4] = {m4.x, m4.y, m4.z, m4.w};
  const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
  float av[4], cv[4], tv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + e;
    float q, term = 0.0f;
    if (k == K) {
      q = x[e];
    } else {
      float gp = __fmul_rn(cs.alpha, x[e]);
      if constexpr (TPA) {
        const float p = __fadd_rn(__fmul_rn(jk, m[e]), __fmul_rn(cs.gamma, sv[e]));
        const float den = __fadd_rn(1.0f, __fmul_rn(cs.beta, p));
        gp = __fdiv_rn(gp, __fmul_rn(den, den));
      }
      q = __fmul_rn(cs.gamma, gp);
      term = __fmul_rn(m[e], gp);
    }
    av[e] = k > 0 ? __fadd_rn(gv[e], q) : q;
    // c'[k-1, i] = c[k-1, i+1]; at node N-1, c[k, 0] (1 before the last period)
    float cf = 1.0f;
    if (i < N - 1) {
      if (k > 0) {
        const float un = __fmul_rn(jp, e < 3 ? m[e + 1] : msk[i0 + 4]);
        cf = un > sv[e] ? 1.0f : cs.keep;
      }
    } else if (k < K) {
      cf = __fmul_rn(jk, msk[0]) > sv[e] ? 1.0f : cs.keep;
    }
    cv[e] = cf;
    tv[e] = term;
  }
  st4(a + i0, float4{av[0], av[1], av[2], av[3]});
  st4(c + i0, float4{cv[0], cv[1], cv[2], cv[3]});
  if (k < K) st4(t + i0, float4{tv[0], tv[1], tv[2], tv[3]});
}

// Helper warp h: groups h, h + kHelpers, ... of the sequence of all
// transitions' groups (K -> K-1, ..., 0 -> -1, each from node group ng-1
// down to 0), so up to kHelpers groups are in flight at once; a group is
// one warp's, four nodes of one lane a thread.
template <bool TPA>
__device__ void helper_role(const Shared& sh, int K, int N, int ng, int lg_group, int stride,
                            int depth, int live, int h, int tl, const Consts& cs) {
  const int lg_quads = lg_group - 2, quads = 1 << lg_quads;
  const int total = (K + 1) * ng;
  for (int seq = h; seq < total; seq += kHelpers) {
    const int tr = seq / ng;  // the transition from period k = K - tr; its rows: staged tr
    const int q = ng - 1 - (seq - tr * ng);
    const int k = K - tr;
    const int slot = tr % depth;
    const int tu = tr - 1;  // period k's terms: the tu-th use of the term rows
    wait_for<kHelperSleepNs>(sh.staged, tr + 1);
    if (k < K) {
      wait_for<kHelperSleepNs>(sh.summed, max(tu - 1, 0));  // the term row's last period summed
      // lam[k] of this group written: `done` is at its phase tu once the
      // group's transition tr-1 is done
      wait_for<kHelperSleepNs>(sh.ready + q, tr);
      if (!bar_test(bar(sh.done, q), tu & 1)) {
        const long long t0 = clock64();
        while (!bar_test(bar(sh.done, q), tu & 1)) {
          __nanosleep(kHelperSleepNs);
          check_wait(t0);
        }
      }
    }
    float* const trow = sh.t + (tu & 1) * sh.rows;
    const float* const srow = sh.s + slot * sh.rows;
    const float* const grow = sh.g + slot * sh.rows;
    const float2* const jrow = sh.j + slot * sh.lanes;
    const int lo = q << lg_group, hi = min(N, lo + (1 << lg_group));
    for (int e = tl; e < live << lg_quads; e += kWarp) {
      const int l = e >> lg_quads, i0 = lo + ((e & (quads - 1)) << 2), off = l * stride;
      if (i0 >= hi) continue;
      const float2 jj = jrow[l];  // j[k-1], j[k]
      transition4<TPA>(sh.a + off, sh.c + off, trow + off, srow + off, grow + off, sh.mask, i0,
                       N, k, K, jj.y, jj.x, cs);
    }
    __syncwarp();
    if (tl == 0) {
      put(sh.ready + q, tr + 1);
      bar_arrive(bar(sh.paired, q));
      add(sh.slot_groups + slot, 1);
      if (k < K) add(sh.term_groups + (tu & 1), 1);
    }
  }
}

// The summer warp: dj[k] of lane tl, its terms summed over nodes N-1 -> 0
// from 0, one period behind the chain, four float4s loaded ahead.
__device__ void sum_role(const Shared& sh, float* __restrict__ dj, int K, int N, int ng,
                         int stride, int lane0, int tl, int live) {
  const bool mine = tl < live;  // all lanes run (no divergence); the others shadow lane 0
  const int n4 = N & ~3;
  const auto quad = [&](const float* t, int i0) { return i0 >= 0 ? ld4(t + i0) : float4{}; };
  for (int k = K - 1; k >= 0; --k) {
    const int tu = K - 1 - k;
    wait_for<kIdleSleepNs>(sh.term_groups + (tu & 1), ((tu >> 1) + 1) * ng);
    const float* const t = sh.t + (tu & 1) * sh.rows + (mine ? tl : 0) * stride;
    float acc = 0.0f;
    for (int i = N - 1; i >= n4; --i) acc = __fadd_rn(acc, t[i]);
    int i0 = n4 - 4;
    float4 v0 = quad(t, i0), v1 = quad(t, i0 - 4), v2 = quad(t, i0 - 8), v3 = quad(t, i0 - 12);
    for (; i0 >= 0; i0 -= 4) {
      const float4 vn = quad(t, i0 - 16);
      acc = __fadd_rn(acc, v0.w);
      acc = __fadd_rn(acc, v0.z);
      acc = __fadd_rn(acc, v0.y);
      acc = __fadd_rn(acc, v0.x);
      v0 = v1;
      v1 = v2;
      v2 = v3;
      v3 = vn;
    }
    if (mine) dj[static_cast<size_t>(lane0 + tl) * K + k] = acc;
    __syncwarp();
    if (tl == 0) put(sh.summed, tu + 1);
  }
}

// The stager warp: the state and gradient rows of periods K-1 .. 0, then
// s0 as the states of period -1, into the slots' ring, with each lane's
// j[p] and j[p+1].  A slot is refilled once every group of its last
// transition is done; lane 0 counts the fills that have landed (their
// mbarriers, waited for in order) into `staged`.
__device__ void stage_role(const Shared& sh, const float* __restrict__ j,
                           const float* __restrict__ s0, const float* __restrict__ states,
                           const float* __restrict__ g, int K, int N, int ng, int stride,
                           int depth, int lane0, int live, int tl, bool bulk) {
  int landed = 0;
  const auto publish = [&](int issued) {
    while (landed < issued && bar_test(bar(sh.full, landed % depth), (landed / depth) & 1)) {
      put(sh.staged, ++landed);
    }
  };
  for (int staged = 0; staged <= K; ++staged) {
    const int p = K - 1 - staged, slot = staged % depth;
    const unsigned free_at = static_cast<unsigned>(staged / depth) * ng;
    if (get(sh.slot_groups + slot) < free_at) {
      const long long t0 = clock64();
      while (get(sh.slot_groups + slot) < free_at) {
        if (tl == 0) publish(staged);
        __nanosleep(kIdleSleepNs);
        check_wait(t0);
      }
    }
    __syncwarp();
    float* const sd = sh.s + slot * sh.rows;
    float* const gd = sh.g + slot * sh.rows;
    float2* const jd = sh.j + slot * sh.lanes;
    const uint32_t full = bar(sh.full, slot);
    const auto state_row = [&](int l) {
      const size_t b = lane0 + l;
      return p >= 0 ? states + (b * K + p) * N : s0 + b * N;
    };
    const auto grad_row = [&](int l) { return g + (static_cast<size_t>(lane0 + l) * K + p) * N; };
    const auto j_at = [&](int l, int k) { return j + static_cast<size_t>(lane0 + l) * K + k; };
    if (bulk) {
      // j by plain copies, ordered before lane 0's arrival by the warp barrier
      if (tl < live) {
        if (p >= 0) jd[tl].x = *j_at(tl, p);
        if (p + 1 < K) jd[tl].y = *j_at(tl, p + 1);
      }
      __syncwarp();
      const uint32_t bytes = 4u * N;
      if (tl == 0) bar_expect(full, bytes * live * (p >= 0 ? 2 : 1));
      __syncwarp();
      if (tl < live) {
        bulk_row(sd + tl * stride, state_row(tl), bytes, full);
        if (p >= 0) bulk_row(gd + tl * stride, grad_row(tl), bytes, full);
      }
    } else {
      for (int e = tl; e < live * N; e += kWarp) {
        const int l = e / N, i = e - l * N;
        copy4(sd + l * stride + i, state_row(l) + i);
        if (p >= 0) copy4(gd + l * stride + i, grad_row(l) + i);
      }
      if (tl < live) {
        if (p >= 0) copy4(&jd[tl].x, j_at(tl, p));
        if (p + 1 < K) copy4(&jd[tl].y, j_at(tl, p + 1));
      }
      copies_arrive(full);
    }
    if (tl == 0) publish(staged + 1);
  }
  if (tl == 0) {
    const long long t0 = clock64();
    while (landed <= K) {
      publish(K + 1);
      __nanosleep(kIdleSleepNs);
      check_wait(t0);
    }
  }
}

// j, s0, g_fin, dj, ds0 [B, K] / [B, N]; states, g [B, K, N]; mask [N].
template <bool TPA>
__global__ void __launch_bounds__(kThreads)
dfr_scan_grad_kernel(const float* __restrict__ j, const float* __restrict__ mask,
                     const float* __restrict__ s0, const float* __restrict__ states,
                     const float* __restrict__ g, const float* __restrict__ g_fin,
                     float* __restrict__ dj, float* __restrict__ ds0, int B, int K, int N,
                     int lanes, int stride, int depth, int lg_group, Consts cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = 1 << lg_group;
  const int ng = (N + group - 1) >> lg_group;
  const int n_counts = ng + depth + 4;
  Shared sh;
  sh.full = smem_addr(smem);
  sh.done = bar(sh.full, depth);
  sh.paired = bar(sh.done, ng);
  sh.j = reinterpret_cast<float2*>(smem + 8 * (depth + 2 * ng));
  sh.ready = reinterpret_cast<unsigned*>(sh.j + depth * lanes);
  sh.slot_groups = sh.ready + ng;
  sh.term_groups = sh.slot_groups + depth;
  sh.summed = sh.term_groups + 2;
  sh.staged = sh.summed + 1;
  sh.lanes = lanes;
  sh.rows = lanes * stride;
  sh.mask = reinterpret_cast<float*>(
      smem + ((8 * (depth + 2 * ng) + 8 * depth * lanes + 4 * n_counts + 15) & ~15));
  sh.a = sh.mask + stride;
  sh.c = sh.a + sh.rows;
  sh.t = sh.c + sh.rows;
  sh.s = sh.t + 2 * sh.rows;
  sh.g = sh.s + depth * sh.rows;
  const int t = threadIdx.x, warp = t / kWarp, tl = t % kWarp;
  const int lane0 = blockIdx.x * lanes;
  const int live = min(lanes, B - lane0);
  const auto aligned = [](const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool bulk = N % 4 == 0 && aligned(states) && aligned(g) && aligned(s0);
  if (t == 0) {
    for (int q = 0; q < depth; ++q) bar_init(bar(sh.full, q), bulk ? 1 : kWarp);
    for (int q = 0; q < ng; ++q) {
      bar_init(bar(sh.done, q), live);  // one arrival a chain lane
      bar_init(bar(sh.paired, q), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = t; i < n_counts; i += kThreads) sh.ready[i] = 0;
  for (int i = t; i < N; i += kThreads) sh.mask[i] = mask[i];
  for (int e = t; e < live * N; e += kThreads) {  // q of the period after the last: g_fin
    const int l = e / N, i = e - l * N;
    sh.a[l * stride + i] = g_fin[static_cast<size_t>(lane0 + l) * N + i];
  }
  __syncthreads();

  float lam = 0.0f;
  if (warp == kChainWarp) {
    lam = chain_role(sh, K, N, ng, group, stride, tl, live);
  } else if (warp == kStagerWarp) {
    stage_role(sh, j, s0, states, g, K, N, ng, stride, depth, lane0, live, tl, bulk);
  } else if (warp == kSummerWarp) {
    sum_role(sh, dj, K, N, ng, stride, lane0, tl, live);
  } else if (helper_of(warp) >= 0) {
    helper_role<TPA>(sh, K, N, ng, lg_group, stride, depth, live, helper_of(warp), tl, cs);
  }
  __syncthreads();
  // s0[N-1] also fed node 0 of period 0: one more chain step with c[0, 0]
  if (warp == kChainWarp && tl < live) {
    float* const a = sh.a + tl * stride;
    a[N - 1] = step(a[N - 1], sh.c[tl * stride + N - 1], lam);
  }
  __syncthreads();
  for (int e = t; e < live * N; e += kThreads) {
    const int l = e / N, i = e - l * N;
    ds0[static_cast<size_t>(lane0 + l) * N + i] = sh.a[l * stride + i];
  }
}

template <bool TPA>
int launch(const float* j, const float* mask, const float* s0, const float* states,
           const float* g, const float* g_fin, float* dj, float* ds0, int B, int K, int N,
           int lanes, int blocks, int stride, int depth, int lg_group, int smem, Consts c,
           cudaStream_t stream) {
  const auto kernel = dfr_scan_grad_kernel<TPA>;
  if (smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(j, mask, s0, states, g, g_fin, dj, ds0, B, K, N,
                                              lanes, stride, depth, lg_group, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// j [B, K], mask [N], s0 [B, N], states [B, K, N] (K1's f32 states),
// g [B, K, N] and g_fin [B, N] (the gradients of the states and of the
// final state), all f32 and contiguous; writes dj [B, K] and ds0 [B, N]
// (f32).  lanes, blocks, stride, depth, group, smem_bytes: the layout of
// ops.grad_layout (lanes a block, blocks, row pitch in floats, slots of
// the staging ring, nodes a chain/helper handoff (a power of two, at least
// 4), dynamic shared bytes); alpha, gamma, beta: SiliconMR's f32
// constants (its kernel_spec()), keep = 1 - alpha in f32.  Returns the
// cudaError_t of the attribute call and the launch (0 on success);
// cudaErrorInvalidValue for a layout that does not cover the batch or a
// row, or K < 1.
extern "C" int dfr_scan_grad_launch(const void* j, const void* mask, const void* s0,
                                    const void* states, const void* g, const void* g_fin,
                                    void* dj, void* ds0, int B, int K, int N, int lanes,
                                    int blocks, int stride, int depth, int group, int smem_bytes,
                                    float alpha, float gamma, float beta, float keep,
                                    void* stream) {
  if (group < 4 || (group & (group - 1)) != 0 || lanes < 1 || lanes > kMaxLanes || depth < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lg_group = __builtin_ctz(static_cast<unsigned>(group));
  const long long ng = (static_cast<long long>(N) + group - 1) / group;
  const long long head =
      (8 * (depth + 2 * ng) + 8LL * depth * lanes + 4 * (ng + depth + 4) + 15) / 16 * 16;
  const long long rows = 1 + static_cast<long long>(lanes) * (4 + 2 * depth);
  if (K < 1 || N < 1 || static_cast<long long>(lanes) * blocks < B || stride < N ||
      stride % 4 != 0 || smem_bytes < head + 4LL * rows * stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts c{alpha, gamma, beta, keep};
  const auto* jf = static_cast<const float*>(j);
  const auto* mf = static_cast<const float*>(mask);
  const auto* sf = static_cast<const float*>(s0);
  const auto* stf = static_cast<const float*>(states);
  const auto* gf = static_cast<const float*>(g);
  const auto* ff = static_cast<const float*>(g_fin);
  auto* djf = static_cast<float*>(dj);
  auto* dsf = static_cast<float*>(ds0);
  auto s = static_cast<cudaStream_t>(stream);
  if (beta != 0.0f) {
    return launch<true>(jf, mf, sf, stf, gf, ff, djf, dsf, B, K, N, lanes, blocks, stride, depth,
                        lg_group, smem_bytes, c, s);
  }
  return launch<false>(jf, mf, sf, stf, gf, ff, djf, dsf, B, K, N, lanes, blocks, stride, depth,
                       lg_group, smem_bytes, c, s);
}
