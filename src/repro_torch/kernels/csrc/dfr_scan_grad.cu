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
// What bounds it: the chain, as in K1.  Each lane is K*N dependent steps
// of a mul and an add (dfr_scan.cu's dfr_scan_chain_probe, form 4, times
// the step on the card), and lanes are the only parallel axis: the LM's
// microbatch gives 24 lanes, three blocks.  At [24, 512, 256] the chain
// bound is about 0.55 ms, while the 25 MB it reads take 7.5 us; this kernel
// takes 1.81 ms there, 27 cycles a node (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6).
//
// Design, K1's layout (dfr_scan.cu, dfr_scan_chain_kernel) run backwards:
//   * a block is eight warps over L = 8 lanes; thread l of warp 0 runs
//     lane l's reverse chain, period by period;
//   * warps 1-7 stage, coalesced across lanes from the wrapper's [K, N, B]
//     layout, the next period's rows into shared memory while warp 0 runs
//     this one: three state slots a lane (periods k, k-1 in use, k-2
//     loading) and two gradient slots (k in use, k-1 loading), by 4-byte
//     cp.async copies all in flight at once; one __syncthreads a period
//     hands them over.  Loads through registers, one in flight a thread,
//     made the staging, not the chain, set the pace, and one stager warp
//     still kept the chain waiting at each period's barrier (PERF.md §6);
//   * the chain thread walks a period's rows in float4 groups of four
//     nodes, downwards, loading the next group's rows while this group's
//     chain runs;
//   * the q row (gamma gp of the period after) is the chain thread's own
//     row, read and rewritten node by node in the same pass; it starts as
//     g_fin and ends as ds0;
//   * dj[k] sums over nodes in the chain's order, N-1 -> 0, from 0; the
//     plain version (kernels/dfr_scan/ops.py, dfr_scan_grad_plain) sums in
//     the same order;
//   * rows are whole float4s, an odd count of them (ops.row_stride), so the
//     eight lanes' rows fall in distinct banks.
//
// Numerics: every product, sum and quotient is a separately rounded
// __fmul_rn/__fadd_rn/__fdiv_rn (and the build passes -fmad=false), in the
// plain version's op order, so the two agree bitwise.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kStagers = 7;             // stager warps a block
constexpr int kThreads = (1 + kStagers) * kWarp;
constexpr int kLanes = 8;               // lanes a block (ops.LANES_PER_BLOCK)
constexpr int kGroup = 4;               // nodes a float4 of a row holds
constexpr int kStaticSmem = 48 * 1024;  // above this, dynamic shared memory needs opting in

struct Consts {
  float alpha, gamma, beta, keep;  // keep = 1 - alpha, in f32
};

// The state slot of period k >= -1 (period -1 is s0) and the gradient slot of k >= 0.
__device__ __forceinline__ int state_slot(int k) { return (k + 3) % 3; }
__device__ __forceinline__ int grad_slot(int k) { return k & 1; }

// Rows [N] of `live` lanes from a [N, B] array (lanes contiguous) into
// rows [kLanes][stride] of shared memory, by `threads` threads from `t`:
// 4-byte cp.async copies, all in flight until the caller's cp_async_wait.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, float* dst, int lane0,
                                           int live, int B, int N, int stride, int t,
                                           int threads) {
#pragma unroll 4
  for (int e = t; e < N * kLanes; e += threads) {
    const int i = e / kLanes, l = e % kLanes;
    if (l < live) {
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + l * stride + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to),
                   "l"(src + static_cast<size_t>(i) * B + lane0 + l)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

// One node of the reverse chain: the branch factor of this node (for the
// node below), lam (c_next lam in, this node's lam out), acc (+= m gp);
// returns this node's q = gamma gp.
template <bool TPA>
__device__ __forceinline__ float node(float jk, float m, float prev, float g, float q_in,
                                      float s_tau, float& lam, float& c_next, float& acc,
                                      const Consts& c) {
  const float u = __fmul_rn(jk, m);
  const float ci = (u > prev) ? 1.0f : c.keep;
  const float a = __fadd_rn(g, q_in);
  lam = __fadd_rn(a, __fmul_rn(c_next, lam));
  float gp = __fmul_rn(c.alpha, lam);
  if constexpr (TPA) {
    const float p = __fadd_rn(u, __fmul_rn(c.gamma, s_tau));
    const float den = __fadd_rn(1.0f, __fmul_rn(c.beta, p));
    gp = __fdiv_rn(gp, __fmul_rn(den, den));
  }
  acc = __fadd_rn(acc, __fmul_rn(m, gp));
  c_next = ci;
  return __fmul_rn(c.gamma, gp);
}

// One period of one lane's reverse chain over its rows in shared memory:
// sk (states of period k), skm1 (period k-1), gk (the gradient of period
// k's states), q (q of period k+1 in, of period k out), msk.  Nodes N-1
// down to the last whole group one by one, then groups of four downwards,
// the next group's rows loaded while this one's chain runs.  Returns dj[k].
template <bool TPA>
__device__ __forceinline__ float run_period(const float* sk, const float* skm1, const float* gk,
                                            float* q, const float* msk, float jk, int N,
                                            float& lam, float& c_next, const Consts& c) {
  const float s_link = skm1[N - 1];
  float acc = 0.0f;
  const int n4 = N - N % kGroup;
  for (int i = N - 1; i >= n4; --i) {
    const float prev = i > 0 ? sk[i - 1] : s_link;
    q[i] = node<TPA>(jk, msk[i], prev, gk[i], q[i], TPA ? skm1[i] : 0.0f, lam, c_next, acc, c);
  }
  if (n4 > 0) {
    int i0 = n4 - kGroup;
    float4 g4 = ld4(gk + i0), q4 = ld4(q + i0), m4 = ld4(msk + i0), s4 = ld4(sk + i0);
    float4 t4 = TPA ? ld4(skm1 + i0) : float4{};
    float4 low = i0 > 0 ? ld4(sk + i0 - kGroup) : float4{0.0f, 0.0f, 0.0f, s_link};
    for (; i0 >= 0; i0 -= kGroup) {
      // the next group down (clamped onto group 0 at the bottom, unused there)
      const int nx = max(i0 - kGroup, 0);
      const float4 g_n = ld4(gk + nx), q_n = ld4(q + nx), m_n = ld4(msk + nx);
      const float4 t_n = TPA ? ld4(skm1 + nx) : float4{};
      const float4 low_n = nx > 0 ? ld4(sk + nx - kGroup) : float4{0.0f, 0.0f, 0.0f, s_link};
      float4 out;
      out.w = node<TPA>(jk, m4.w, s4.z, g4.w, q4.w, t4.w, lam, c_next, acc, c);
      out.z = node<TPA>(jk, m4.z, s4.y, g4.z, q4.z, t4.z, lam, c_next, acc, c);
      out.y = node<TPA>(jk, m4.y, s4.x, g4.y, q4.y, t4.y, lam, c_next, acc, c);
      out.x = node<TPA>(jk, m4.x, low.w, g4.x, q4.x, t4.x, lam, c_next, acc, c);
      *reinterpret_cast<float4*>(q + i0) = out;
      g4 = g_n;
      q4 = q_n;
      m4 = m_n;
      t4 = t_n;
      s4 = low;
      low = low_n;
    }
  }
  return acc;
}

// j [K, B]; mask [N]; s0 [N, B]; states, g [K, N, B]; g_fin [N, B];
// dj [K, B]; ds0 [N, B].
template <bool TPA>
__global__ void __launch_bounds__(kThreads)
dfr_scan_grad_kernel(const float* __restrict__ j, const float* __restrict__ mask,
                     const float* __restrict__ s0, const float* __restrict__ states,
                     const float* __restrict__ g, const float* __restrict__ g_fin,
                     float* __restrict__ dj, float* __restrict__ ds0, int B, int K, int N,
                     int stride, Consts c) {
  extern __shared__ float4 smem4[];
  float* const srow = reinterpret_cast<float*>(smem4);  // state slot q at srow + q * size
  const int size = kLanes * stride;
  float* const grow = srow + 3 * size;  // gradient slot q at grow + q * size
  float* const qrow = srow + 5 * size;
  float* const msk = srow + 6 * size;
  const int t = threadIdx.x;
  const int tl = t % kWarp;
  const int lane0 = blockIdx.x * kLanes;
  const int live = min(kLanes, B - lane0);
  const size_t period = static_cast<size_t>(N) * B;
  const auto state_row = [&](int k) { return k >= 0 ? states + k * period : s0; };
  // stage in: the last two periods' states, the last period's gradient,
  // g_fin as the q row, the mask
  stage_rows(state_row(K - 1), srow + state_slot(K - 1) * size, lane0, live, B, N, stride, t,
             kThreads);
  stage_rows(state_row(K - 2), srow + state_slot(K - 2) * size, lane0, live, B, N, stride, t,
             kThreads);
  stage_rows(g + (K - 1) * period, grow + grad_slot(K - 1) * size, lane0, live, B, N, stride, t,
             kThreads);
  stage_rows(g_fin, qrow, lane0, live, B, N, stride, t, kThreads);
  for (int i = t; i < N; i += kThreads) msk[i] = mask[i];
  cp_async_wait();
  __syncthreads();

  const bool on = t < kWarp && tl < live;
  const int b = lane0 + tl;
  float lam = 0.0f, c_next = 1.0f;  // c' lam' into the last node: 0
  float* const q = qrow + tl * stride;
  for (int k = K - 1; k >= 0; --k) {
    if (on) {
      dj[static_cast<size_t>(k) * B + b] = run_period<TPA>(
          srow + state_slot(k) * size + tl * stride, srow + state_slot(k - 1) * size + tl * stride,
          grow + grad_slot(k) * size + tl * stride, q, msk, j[static_cast<size_t>(k) * B + b], N,
          lam, c_next, c);
    } else if (t >= kWarp) {
      // the stager warps: period k-2's states and period k-1's gradient
      if (k - 2 >= -1) {
        stage_rows(state_row(k - 2), srow + state_slot(k - 2) * size, lane0, live, B, N, stride,
                   t - kWarp, kThreads - kWarp);
      }
      if (k - 1 >= 0) {
        stage_rows(g + (k - 1) * period, grow + grad_slot(k - 1) * size, lane0, live, B, N,
                   stride, t - kWarp, kThreads - kWarp);
      }
      cp_async_wait();
    }
    __syncthreads();
  }
  // s0[N-1] also fed node 0 of period 0
  if (on) q[N - 1] = __fadd_rn(q[N - 1], __fmul_rn(c_next, lam));
  __syncthreads();
  for (int e = t; e < N * live; e += kThreads) {
    const int i = e / live, l = e - i * live;
    ds0[static_cast<size_t>(i) * B + lane0 + l] = qrow[l * stride + i];
  }
}

template <bool TPA>
int launch(const float* j, const float* mask, const float* s0, const float* states,
           const float* g, const float* g_fin, float* dj, float* ds0, int B, int K, int N,
           int lanes, int blocks, int stride, int smem, Consts c, cudaStream_t stream) {
  const auto kernel = dfr_scan_grad_kernel<TPA>;
  if (smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(j, mask, s0, states, g, g_fin, dj, ds0, B, K, N,
                                              stride, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// j [K, B], mask [N], s0 [N, B], states [K, N, B] (K1's f32 states),
// g [K, N, B] and g_fin [N, B] (the gradients of the states and of the
// final state), all f32; writes dj [K, B] and ds0 [N, B] (f32).
// lanes, blocks, stride, smem_bytes: the layout of ops.grad_layout (lanes
// a block, blocks, row pitch in floats, dynamic shared bytes); alpha,
// gamma, beta: SiliconMR's f32 constants (its kernel_spec()), keep =
// 1 - alpha in f32.  Returns the cudaError_t of the attribute call and the
// launch (0 on success); cudaErrorInvalidValue for a layout that does not
// cover the batch or a row, or K < 1.
extern "C" int dfr_scan_grad_launch(const void* j, const void* mask, const void* s0,
                                    const void* states, const void* g, const void* g_fin,
                                    void* dj, void* ds0, int B, int K, int N, int lanes,
                                    int blocks, int stride, int smem_bytes, float alpha,
                                    float gamma, float beta, float keep, void* stream) {
  const long long rows = 6LL * lanes + 1;
  if (K < 1 || N < 1 || lanes != kLanes ||
      static_cast<long long>(lanes) * blocks < B || stride < N || stride % 4 != 0 ||
      smem_bytes < 4LL * rows * stride) {
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
    return launch<true>(jf, mf, sf, stf, gf, ff, djf, dsf, B, K, N, lanes, blocks, stride,
                        smem_bytes, c, s);
  }
  return launch<false>(jf, mf, sf, stf, gf, ff, djf, dsf, B, K, N, lanes, blocks, stride,
                       smem_bytes, c, s);
}
