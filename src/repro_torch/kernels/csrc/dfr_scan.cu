// Fused masking + delayed-feedback reservoir scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dfr_scan_tiled`
// (src/repro/kernels/dfr_scan/dfr_scan.py:97, body `_kernel` :60).
// For each batch lane b, period k and virtual node i:
//     u = j[k] * m[i];   s_i = node_update(u, s_prev[i], s_{i-1})
// where s_prev[i] is the same node one period earlier and s_{i-1} the
// previous node.  Every state is emitted; the final state is the carry.
//
// What bounds it: the node chain's latency, not bytes.  Node i-1 feeds node
// i (the branch `u > s_{i-1}` of SiliconMR, the decay of MackeyGlass) and
// node N-1 of period k feeds node 0 of period k+1, so a lane is K*N
// dependent steps, and batch lanes are the only parallel axis (64 on the
// paths).  SiliconMR's least step is three dependent f32 ops (mul, add,
// select) of about 4.2 cycles each; its step as written here (the select a
// byte permute) takes about 15 cycles.  At 1980 MHz that puts
// [64, 1000, 900] at no less than about 5.8 ms, while its 230 MB of states
// take 0.07 ms of HBM bandwidth; this kernel takes 8.45 ms there, 18.6
// cycles a node (NVIDIA H100 80GB HBM3, 700 W; PERF.md PR 14).
// dfr_scan_chain_probe below measures both step latencies on the card, and
// chip_smoke.py's kernels line reports them with the chain bound.
//
// Design:
//   * each period splits into a chain-free part and the chain.  The
//     chain-free part of node i needs only u_i, s_prev[i] and the model's
//     constants (SiliconMR's pre = alpha * drive, with the TPA division;
//     SiliconMRLiteral's charge and discharge; MackeyGlass's
//     (1 - c) * drive with powf and the division; the CMT cavity's drive
//     max(u + gamma * s_prev[i], 0)).  The chain keeps only what needs
//     s_{i-1}: SiliconMR mul, add, add, compare, select; SiliconMRLiteral
//     compare, select; MackeyGlass mul, add; the CMT cavity everything from
//     its branch on, n_substeps exponential-integrator steps of about 30
//     dependent f32 ops each, with a division, expf and expm1f (its chain
//     step is timed by dfr_scan_chain_probe, form 2);
//   * one thread runs one lane's chain, software-pipelined over groups of
//     four nodes: the carry and mask of group g+2 are loaded and the
//     chain-free part of group g+1 is computed while the chain of group g
//     runs, so loads and chain-free work fill the chain's latency shadow;
//   * a block is two warps over L = 8 lanes (eight blocks at B = 64).
//     Warp 0 runs the chains.  Warp 1 writes the states out, coalesced,
//     from shared memory, so the chain warp issues no global store: the
//     carry is two buffers of rows [L][stride] in shared memory, period k
//     written into buffer k % 2 from buffer (k+1) % 2, and warp 1 writes
//     period k out while warp 0 runs period k+1, handed over by named
//     barriers.  The carry is loaded from `fin` once and flushed to it
//     once; the mask sits after the buffers (one row, or one a lane);
//   * rows are whole float4s, an odd count of them (ops.py `row_stride`),
//     so eight lanes' float4 loads and stores fall in distinct banks; the
//     wrapper (kernels/dfr_scan/ops.py `scan_layout`) gives L, the row
//     pitch and the shared-memory bytes;
//   * MZISine has no chain (node i of period k needs only node i of period
//     k-1), so it runs one thread per (node, lane) pair, its carry in a
//     register, and no shared memory;
//   * states are written in the [K, N, B] layout, lanes contiguous, which
//     the wrapper permutes to [B, K, N].
//
// Tried and dropped (PERF.md PR 14; ms at [64, 256, 900], where this kernel
// takes 2.18 and the PR 13 kernel 10.90): one warp a block that also writes
// the states, 3.04 (its loop issues 13.5 instructions a node, 3 of them for
// the stores); the `?:` select, which compiles to an add predicated on the
// compare and reads the predicate at issue (18.3 cycles a chain step), 2.44;
// the select moved before the add (22.2 cycles a step) or onto the
// multiplier (18.3); the group loop unrolled 2 or 8 times instead of 4,
// 2.37 / 2.25 (not unrolled, 1.5x slower); 16 lanes a block (more
// shared-memory wavefronts a chain step), 3.58; the barrier ids as
// compile-time constants behind a branch, 24 % slower at the per-lane
// [64, 10000, 100].  A second kernel whose helper warps computed the
// chain-free part behind the chain, handed over by segments through
// acquire/release counters: the TPA form 3.12 and MackeyGlass 2.69, against
// about 10.9 and 39.1 here, where the chain warp issues the division and
// powf itself; SiliconMR on it, 2.94 (a segment's handoff costs a release
// fence and a pipeline fill, more than its cheap chain-free part saves).
// No path runs the TPA form or MackeyGlass, so that kernel went.

// Numerics: compute is f32 whatever the output type.  Every product and
// sum is a separately rounded __fmul_rn/__fadd_rn (and the build passes
// -fmad=false), in the reference's op order; each state's own op sequence
// is the same as in node_update, only the schedule differs, so the kernel
// equals its plain PyTorch version up to libm differences (sinf/powf, and
// the CMT form's expf/expm1f against torch's exp/expm1 on the card).
// The branch is the strict `u > s_{i-1}` of jnp.where: a NaN takes the
// discharge branch in both.  Feeding `fin` back as the next call's carry
// resumes bit-exactly, since `fin` holds exactly the f32 values the
// uninterrupted scan keeps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Must match the KERNEL_* ids in repro_torch/core/nonlinear.py.
enum ModelId {
  SILICON_MR = 0,
  SILICON_MR_LITERAL = 1,
  MACKEY_GLASS = 2,
  MZI_SINE = 3,
  MR_CAVITY_CMT = 4
};

// Kernel forms: SiliconMR with TPA saturation (beta_tpa != 0) is its own.
enum Form { MR = 0, MR_TPA = 1, LITERAL = 2, MG = 3, CMT = 4 };

// The model's f32 constants (its kernel_spec()), by value: the launch copies
// the caller's array into it, zero past its length.
constexpr int kMaxParams = 16;
struct Params {
  float v[kMaxParams];
};

constexpr int kWarp = 32;
constexpr int kGroup = 4;                  // nodes a float4 of a carry row holds
constexpr int kStaticSmem = 48 * 1024;     // above this, dynamic shared memory needs opting in
constexpr int kParallelThreads = 256;

// What node i needs besides s_{i-1}: its masked input u and up to two values
// computed from u, s_prev[i] and the constants alone.
struct Free {
  float u, a, b;
};

template <int F>
__device__ __forceinline__ Free free_part(float u, float s_tau, const Params& p);
template <int F>
__device__ __forceinline__ float chain(const Free& f, float s_pn, const Params& p);

// SiliconMR, theta-corrected Eq. (6-7): v0 = alpha, v1 = gamma, v2 = beta_tpa.
template <>
__device__ __forceinline__ Free free_part<MR>(float u, float s_tau, const Params& p) {
  const float drive = __fadd_rn(u, __fmul_rn(p.v[1], s_tau));
  return {u, __fmul_rn(p.v[0], drive), 0.0f};
}

template <>
__device__ __forceinline__ Free free_part<MR_TPA>(float u, float s_tau, const Params& p) {
  float drive = __fadd_rn(u, __fmul_rn(p.v[1], s_tau));
  drive = __fdiv_rn(drive, __fadd_rn(1.0f, __fmul_rn(p.v[2], drive)));
  return {u, __fmul_rn(p.v[0], drive), 0.0f};
}

// The select is a byte permute of the two candidates' bits, its selector
// picked by the compare: written as `?:` on the floats, it compiles to an add
// predicated on the compare, whose predicate is read at issue and puts the
// compare's longer latency on the chain (18.3 cycles a step, against 15.1).
__device__ __forceinline__ float mr_chain(const Free& f, float s_pn, const Params& p) {
  const float charge = __fadd_rn(f.a, s_pn);
  const float discharge = __fadd_rn(f.a, __fmul_rn(s_pn, __fsub_rn(1.0f, p.v[0])));
  const unsigned pick = (f.u > s_pn) ? 0x3210u : 0x7654u;  // charge's bytes : discharge's
  return __uint_as_float(__byte_perm(__float_as_uint(charge), __float_as_uint(discharge), pick));
}

template <>
__device__ __forceinline__ float chain<MR>(const Free& f, float s_pn, const Params& p) {
  return mr_chain(f, s_pn, p);
}

template <>
__device__ __forceinline__ float chain<MR_TPA>(const Free& f, float s_pn, const Params& p) {
  return mr_chain(f, s_pn, p);
}

// SiliconMRLiteral, Eq. (6-7) as printed: v0 = alpha, v1 = gamma.
template <>
__device__ __forceinline__ Free free_part<LITERAL>(float u, float s_tau, const Params& p) {
  const float pre = __fmul_rn(__fadd_rn(u, __fmul_rn(p.v[1], s_tau)), p.v[0]);
  return {u, __fadd_rn(pre, s_tau), __fadd_rn(pre, __fmul_rn(s_tau, __fsub_rn(1.0f, p.v[0])))};
}

template <>
__device__ __forceinline__ float chain<LITERAL>(const Free& f, float s_pn, const Params&) {
  return (f.u > s_pn) ? f.a : f.b;
}

// MackeyGlass: v0 = decay c, v1 = eta, v2 = gamma_in, v3 = exponent p.
template <>
__device__ __forceinline__ Free free_part<MG>(float u, float s_tau, const Params& p) {
  const float x = __fadd_rn(s_tau, __fmul_rn(p.v[2], u));
  const float drive = __fdiv_rn(__fmul_rn(p.v[1], x), __fadd_rn(1.0f, powf(fabsf(x), p.v[3])));
  return {u, __fmul_rn(__fsub_rn(1.0f, p.v[0]), drive), 0.0f};
}

template <>
__device__ __forceinline__ float chain<MG>(const Free& f, float s_pn, const Params& p) {
  return __fadd_rn(__fmul_rn(p.v[0], s_pn), f.a);
}

// MRCavityCMT (repro_torch/devices/cmt.py), its constants in this order
// (MRCavityCMT.kernel_spec).  Per tick, `n_substeps` exponential-integrator
// steps of the intracavity energy e, with the free-carrier density n_fc and
// the temperature t_th closed at tick start from the carried energy.
enum CmtParam {
  kGamma, kKappaC, kKappaD, kDetune, kLin, kPower, kFcGain, kThGain,
  kGFc, kGTh, kFcd, kThShift, kTpa, kFca, kDt, kSubsteps
};

// jnp.maximum(x, 0.0) / torch.clamp_min(x, 0.0): a NaN stays NaN.
__device__ __forceinline__ float clamp_min0(float x) { return x < 0.0f ? 0.0f : x; }

// (1 - e^-x) / x with the reference's guard (1 - x/2 at x <= 1e-6), as
// selects so that a warp does not diverge.
__device__ __forceinline__ float phi1(float x) {
  const bool small = x <= 1e-6f;
  const float safe = small ? 1.0f : x;
  const float big = __fdiv_rn(-expm1f(-safe), safe);
  return small ? __fsub_rn(1.0f, __fmul_rn(0.5f, x)) : big;
}

// The chain-free part is the drive P = max(u + gamma s_tau, 0) (and u).
template <>
__device__ __forceinline__ Free free_part<CMT>(float u, float s_tau, const Params& p) {
  return {u, clamp_min0(__fadd_rn(u, __fmul_rn(p.v[kGamma], s_tau))), 0.0f};
}

// Everything from the branch on: kappa and the loss select, the closure of
// n_fc and t_th, and each substep, in the reference's op order.  The last
// substep's n_fc and t_th updates feed nothing and are not computed, as in
// the plain version.
template <>
__device__ __forceinline__ float chain<CMT>(const Free& f, float s_pn, const Params& p) {
  const bool charging = f.u > s_pn;
  const float kap = charging ? p.v[kKappaC] : p.v[kKappaD];
  const float lin_eff = charging ? 0.0f : p.v[kLin];
  const float pw = p.v[kPower], dt = p.v[kDt];
  float e = clamp_min0(s_pn);
  float pe = __fmul_rn(pw, e);
  float n_fc = __fmul_rn(p.v[kFcGain], __fmul_rn(pe, pe));
  float t_th = __fmul_rn(p.v[kThGain], pe);
  const int n_sub = static_cast<int>(p.v[kSubsteps]);
  for (int m = 0; m < n_sub; ++m) {
    const float delta = __fadd_rn(__fsub_rn(p.v[kDetune], __fmul_rn(p.v[kFcd], n_fc)),
                                  __fmul_rn(p.v[kThShift], t_th));
    const float lor = __fdiv_rn(1.0f, __fadd_rn(__fmul_rn(delta, delta), 1.0f));
    const float r = __fadd_rn(__fadd_rn(lin_eff, __fmul_rn(p.v[kTpa], pe)),
                              __fmul_rn(p.v[kFca], n_fc));
    const float x = __fmul_rn(r, dt);
    e = __fadd_rn(__fmul_rn(e, expf(-x)),
                  __fmul_rn(__fmul_rn(__fmul_rn(kap, lor), f.a), __fmul_rn(dt, phi1(x))));
    if (m + 1 < n_sub) {
      pe = __fmul_rn(pw, e);
      n_fc = __fadd_rn(n_fc, __fmul_rn(p.v[kGFc],
                                       __fsub_rn(__fmul_rn(p.v[kFcGain], __fmul_rn(pe, pe)), n_fc)));
      t_th = __fadd_rn(t_th, __fmul_rn(p.v[kGTh], __fsub_rn(__fmul_rn(p.v[kThGain], pe), t_th)));
    }
  }
  return e;
}

// MZISine: v0 = phi, v1 = beta_in, v2 = alpha_fb.  No theta coupling.
__device__ __forceinline__ float mzi_update(float u, float s_tau, const Params& p) {
  const float arg = __fadd_rn(__fadd_rn(p.v[0], __fmul_rn(p.v[1], u)), __fmul_rn(p.v[2], s_tau));
  const float s = sinf(arg);
  return __fmul_rn(s, s);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

template <int F>
__device__ __forceinline__ void free_group(Free (&f)[kGroup], float jk, float4 s, float4 m,
                                           const Params& p) {
  f[0] = free_part<F>(__fmul_rn(jk, m.x), s.x, p);
  f[1] = free_part<F>(__fmul_rn(jk, m.y), s.y, p);
  f[2] = free_part<F>(__fmul_rn(jk, m.z), s.z, p);
  f[3] = free_part<F>(__fmul_rn(jk, m.w), s.w, p);
}

__device__ __forceinline__ float4 ld4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

// Named barriers (0 is __syncthreads) between the chain warp and the writer
// warp: kFull + q "period in carry buffer q is written", kEmpty + q "buffer
// q is written out and free".  Each is arrived at by one warp and waited on
// by the other, and alternates between the two, so 64 threads complete it.
constexpr int kFull = 1;
constexpr int kEmpty = 3;

// The ids are run-time values (ptxas then reserves all 16 of the block's
// barriers); compile-time ids behind a branch ran slower (see the top).
__device__ __forceinline__ void bar_sync(int id) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * kWarp) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * kWarp) : "memory");
}

// One period of one lane's chain: reads the previous period's carry row
// `prev`, writes this period's states to `cur`; `s` is s_{i-1} in and the
// period's last state out.
template <int F>
__device__ __forceinline__ float run_period(const float* prev, float* cur, const float* mrow,
                                            float jk, float s, int N, const Params& p) {
  const int n4 = N - N % kGroup;
  if (n4 > 0) {
    // in flight: the raw carry and mask of group g+2, the chain-free part of
    // group g+1, the chain of group g.  Loads past the last group are clamped
    // onto it (and unused).
    Free now[kGroup];
    free_group<F>(now, jk, ld4(prev), ld4(mrow), p);
    const int g1 = min(kGroup, n4 - kGroup);
    float4 s_nx = ld4(prev + g1), m_nx = ld4(mrow + g1);
#pragma unroll 4
    for (int i0 = 0; i0 < n4; i0 += kGroup) {
      const int i2 = min(i0 + 2 * kGroup, n4 - kGroup);
      const float4 s_far = ld4(prev + i2), m_far = ld4(mrow + i2);
      Free nxt[kGroup];
      free_group<F>(nxt, jk, s_nx, m_nx, p);
      float4 st;
      st.x = s = chain<F>(now[0], s, p);
      st.y = s = chain<F>(now[1], s, p);
      st.z = s = chain<F>(now[2], s, p);
      st.w = s = chain<F>(now[3], s, p);
      *reinterpret_cast<float4*>(cur + i0) = st;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) now[c] = nxt[c];
      s_nx = s_far;
      m_nx = m_far;
    }
  }
  for (int i = n4; i < N; ++i) {  // the N % 4 nodes past the last group
    s = chain<F>(free_part<F>(__fmul_rn(jk, mrow[i]), prev[i], p), s, p);
    cur[i] = s;
  }
  return s;
}

// j [K, B]; mask [N] or [N, B]; fin [N, B] (s0 in, final state out);
// out [K, N, B].  Block x holds lanes [x*L, x*L + L) in two warps.  Warp 0
// runs the chains, one thread a lane, period k into carry buffer k % 2
// (rows [L][stride]) from buffer (k+1) % 2; warp 1 writes period k out of
// its buffer, coalesced, while warp 0 runs period k+1.  The mask rows
// ([stride] or [L][stride]) sit after the two buffers.
template <int F, typename OutT>
__global__ void __launch_bounds__(2 * kWarp)
dfr_scan_chain_kernel(const float* __restrict__ j, const float* __restrict__ mask, int per_lane,
                      float* __restrict__ fin, OutT* __restrict__ out, int B, int K, int N,
                      int L, int stride, Params p) {
  extern __shared__ float4 smem4[];
  float* const carry = reinterpret_cast<float*>(smem4);   // buffer q at carry + q * size
  const int size = L * stride;
  float* const msk = carry + 2 * size;
  const int t = threadIdx.x;
  const int tl = t % kWarp;
  const int lane0 = blockIdx.x * L;
  const int live = min(L, B - lane0);
  const size_t lanes = static_cast<size_t>(B);
  // stage in: s0 into buffer 1, the "previous period" of period 0
  for (int e = t; e < N * live; e += 2 * kWarp) {
    const int i = e / live, l = e - i * live;
    const size_t g = static_cast<size_t>(i) * lanes + lane0 + l;
    carry[size + l * stride + i] = fin[g];
    if (per_lane) msk[l * stride + i] = mask[g];
  }
  if (!per_lane) {
    for (int i = t; i < N; i += 2 * kWarp) msk[i] = mask[i];
  }
  __syncthreads();
  if (t < kWarp) {
    // the chain warp
    const bool on = tl < live;
    const int b = lane0 + tl;
    const float* mrow = msk + (per_lane ? tl * stride : 0);
    float s = on ? carry[size + tl * stride + N - 1] : 0.0f;
    float jk = on ? j[b] : 0.0f;
    for (int k = 0; k < K; ++k) {
      // the next period's input, a period ahead of its use
      const float jn = (on && k + 1 < K) ? j[static_cast<size_t>(k + 1) * lanes + b] : 0.0f;
      if (k >= 2) bar_sync(kEmpty + k % 2);
      if (on) {
        s = run_period<F>(carry + ((k + 1) % 2) * size + tl * stride,
                          carry + (k % 2) * size + tl * stride, mrow, jk, s, N, p);
      }
      bar_arrive(kFull + k % 2);
      jk = jn;
    }
    for (int k = max(0, K - 2); k < K; ++k) bar_sync(kEmpty + k % 2);
  } else {
    // the writer warp: thread tl writes lane tl % L of nodes tl / L, + 32 / L, ...
    const int l = tl % L;
    for (int k = 0; k < K; ++k) {
      bar_sync(kFull + k % 2);
      if (l < live) {
        const float* row = carry + (k % 2) * size + l * stride;
        OutT* o = out + static_cast<size_t>(k) * N * lanes + lane0 + l;
        for (int i = tl / L; i < N; i += kWarp / L) {
          store(o + static_cast<size_t>(i) * lanes, row[i]);
        }
      }
      bar_arrive(kEmpty + k % 2);
    }
  }
  __syncthreads();
  const float* last = carry + ((K + 1) % 2) * size;
  for (int e = t; e < N * live; e += 2 * kWarp) {
    const int i = e / live, l = e - i * live;
    fin[static_cast<size_t>(i) * lanes + lane0 + l] = last[l * stride + i];
  }
}

// MZISine: one thread per (node, lane) pair, e = i*B + b, over all K periods.
template <typename OutT>
__global__ void __launch_bounds__(kParallelThreads)
dfr_scan_parallel_kernel(const float* __restrict__ j, const float* __restrict__ mask,
                         int per_lane, float* __restrict__ fin, OutT* __restrict__ out, int B,
                         int K, int N, Params p) {
  const size_t lanes = static_cast<size_t>(B);
  const size_t period = static_cast<size_t>(N) * lanes;
  const size_t e = static_cast<size_t>(blockIdx.x) * kParallelThreads + threadIdx.x;
  if (e >= period) return;
  const int b = static_cast<int>(e % lanes);
  const float m = per_lane ? mask[e] : mask[e / lanes];
  float s = fin[e];
  for (int k = 0; k < K; ++k) {
    s = mzi_update(__fmul_rn(j[static_cast<size_t>(k) * lanes + b], m), s, p);
    store(out + static_cast<size_t>(k) * period + e, s);
  }
  fin[e] = s;
}

struct Layout {
  int lanes, blocks, stride, smem;
};

// The chain kernel at the layout ops.scan_layout chose: cudaErrorInvalidValue
// for a layout that does not cover the batch or a row, else the error of the
// shared-memory attribute call or of the launch.
template <int F, typename OutT>
int launch_chain(const float* j, const float* mask, int per_lane, float* fin, OutT* out, int B,
                 int K, int N, const Layout& lay, Params p, cudaStream_t stream) {
  const long long rows = per_lane ? 3LL * lay.lanes : 2LL * lay.lanes + 1;
  if (lay.lanes < 1 || kWarp % lay.lanes != 0 ||
      static_cast<long long>(lay.lanes) * lay.blocks < B || lay.stride < N || lay.stride % kGroup != 0 || lay.smem < 4LL * rows * lay.stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = dfr_scan_chain_kernel<F, OutT>;
  if (lay.smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<lay.blocks, 2 * kWarp, lay.smem, stream>>>(j, mask, per_lane, fin, out, B, K, N,
                                                      lay.lanes, lay.stride, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch(int model_id, const float* j, const float* mask, int per_lane, float* fin, OutT* out,
             int B, int K, int N, const Layout& lay, Params p, cudaStream_t stream) {
  switch (model_id) {
    case SILICON_MR:
      if (p.v[2] != 0.0f) {
        return launch_chain<MR_TPA>(j, mask, per_lane, fin, out, B, K, N, lay, p, stream);
      }
      return launch_chain<MR>(j, mask, per_lane, fin, out, B, K, N, lay, p, stream);
    case SILICON_MR_LITERAL:
      return launch_chain<LITERAL>(j, mask, per_lane, fin, out, B, K, N, lay, p, stream);
    case MACKEY_GLASS:
      return launch_chain<MG>(j, mask, per_lane, fin, out, B, K, N, lay, p, stream);
    case MR_CAVITY_CMT:
      return launch_chain<CMT>(j, mask, per_lane, fin, out, B, K, N, lay, p, stream);
    case MZI_SINE: {
      const size_t pairs = static_cast<size_t>(N) * B;
      const unsigned blocks =
          static_cast<unsigned>((pairs + kParallelThreads - 1) / kParallelThreads);
      dfr_scan_parallel_kernel<OutT><<<blocks, kParallelThreads, 0, stream>>>(
          j, mask, per_lane, fin, out, B, K, N, p);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- The chain's latency on the card, for the chain bound of the kernels
// line (chip_smoke.py): one thread runs `steps` dependent steps on register
// values between two clock64() reads.  Form 0 is SiliconMR's chain step as
// chain<MR> computes it; form 1 one dependent __fadd_rn, the latency of one
// f32 op (the least a SiliconMR step can take is three: mul, add, select);
// form 2 the CMT cavity's chain step as chain<CMT> computes it; form 3
// MackeyGlass's (mul, add) as chain<MG> computes it; form 4 the adjoint
// scan's chain step (dfr_scan_grad.cu: lam = a + c * lam, a mul and an add).
constexpr int kProbeUnroll = 8;

template <int V>
__global__ void chain_probe_kernel(const float* in, float* out, long long* cycles, int steps) {
  Free f[kProbeUnroll];
#pragma unroll
  for (int c = 0; c < kProbeUnroll; ++c) f[c] = Free{in[c], in[kProbeUnroll + c], 0.0f};
  Params p;
#pragma unroll
  for (int c = 0; c < kMaxParams; ++c) p.v[c] = in[2 * kProbeUnroll + 1 + c];
  float s = in[2 * kProbeUnroll];
  const long long t0 = clock64();
  if constexpr (V == 2) {
    // 8 inlined copies of the long CMT step, not 32: those would overflow
    // the instruction cache and time its misses, not the chain
#pragma unroll 1
    for (int n = 0; n < steps; n += kProbeUnroll) {
#pragma unroll
      for (int c = 0; c < kProbeUnroll; ++c) s = chain<CMT>(f[c], s, p);
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < steps; n += kProbeUnroll) {
#pragma unroll
      for (int c = 0; c < kProbeUnroll; ++c) {
        if constexpr (V == 0) {
          s = chain<MR>(f[c], s, p);
        } else if constexpr (V == 3) {
          s = chain<MG>(f[c], s, p);
        } else if constexpr (V == 4) {
          s = __fadd_rn(f[c].a, __fmul_rn(f[c].u, s));
        } else {
          s = __fadd_rn(s, f[c].a);
        }
      }
    }
  }
  const long long t1 = clock64();
  out[0] = s;
  cycles[0] = t1 - t0;
}

}  // namespace

// j [K, B] f32; mask [N] (per_lane = 0) or [N, B] (per_lane = 1) f32;
// fin [N, B] f32 holds s0 on entry and the final state on exit;
// out [K, N, B] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).
// lanes, blocks, stride, smem_bytes: the block layout of ops.scan_layout
// (lanes a block, blocks, carry-row pitch in floats, dynamic shared bytes);
// MZISine, which keeps no rows, ignores it.  params: the model's n_params
// (at most 16) f32 constants, its kernel_spec(), copied into the launch.
// Returns the cudaError_t of the attribute call and the launch (0 on
// success); cudaErrorInvalidValue for more than 16 constants or a layout
// that does not cover the batch or a row.
extern "C" int dfr_scan_launch(const void* j, const void* mask, int per_lane, void* fin, void* out,
                               int out_bf16, int B, int K, int N, int lanes, int blocks,
                               int stride, int smem_bytes, int model_id, const float* params,
                               int n_params, void* stream) {
  if (n_params < 0 || n_params > kMaxParams) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int c = 0; c < n_params; ++c) p.v[c] = params[c];
  const Layout lay{lanes, blocks, stride, smem_bytes};
  const auto* jf = static_cast<const float*>(j);
  const auto* mf = static_cast<const float*>(mask);
  auto* ff = static_cast<float*>(fin);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return dispatch(model_id, jf, mf, per_lane, ff, static_cast<__nv_bfloat16*>(out), B, K, N, lay,
                    p, s);
  }
  return dispatch(model_id, jf, mf, per_lane, ff, static_cast<float*>(out), B, K, N, lay, p, s);
}

// in (on the card, f32): 8 inputs u, 8 chain-free values (SiliconMR's
// alpha * drive, the CMT drive, MackeyGlass's (1 - c) * drive), s0, then
// the 16 constants of Params (SiliconMR's alpha first; the CMT and
// MackeyGlass forms' kernel_spec()); out[0] the last state; cycles[0] the
// clock64() cycles of `steps` (a multiple of 8) steps of chain form `form`
// (0 SiliconMR's step, 1 one f32 add, 2 the CMT step, 3 MackeyGlass's
// step, 4 the adjoint scan's step with c = u), one thread.
extern "C" int dfr_scan_chain_probe(int form, const void* in, void* out, void* cycles, int steps,
                                    void* stream) {
  const auto* x = static_cast<const float*>(in);
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<long long*>(cycles);
  auto s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    chain_probe_kernel<0><<<1, 1, 0, s>>>(x, o, c, steps);
  } else if (form == 1) {
    chain_probe_kernel<1><<<1, 1, 0, s>>>(x, o, c, steps);
  } else if (form == 2) {
    chain_probe_kernel<2><<<1, 1, 0, s>>>(x, o, c, steps);
  } else if (form == 3) {
    chain_probe_kernel<3><<<1, 1, 0, s>>>(x, o, c, steps);
  } else if (form == 4) {
    chain_probe_kernel<4><<<1, 1, 0, s>>>(x, o, c, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
