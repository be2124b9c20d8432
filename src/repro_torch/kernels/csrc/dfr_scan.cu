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
//     the wrapper permutes to [B, K, N] (the helper-warp route below writes
//     [B, K, N] itself).
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
// [64, 10000, 100].  SiliconMR on helper warps, 2.94 (a handoff costs more
// than its cheap chain-free part saves).
//
// MackeyGlass takes a kernel of its own, `dfr_scan_helper_kernel` (PERF.md,
// its findings).  Its chain is one mul and add (about 8.2 cycles a step), but its
// chain-free part is a powf and an IEEE division: one thread a lane issuing
// both, as the chain kernel does, took about 340 cycles a node of the SM's
// issue, 41x the chain.  Node i's chain-free part in period k needs only node
// i of period k-1, so it can run a period behind the chain on other warps:
//   * one lane a block while the batch's blocks fit the card's 132 SMs
//     (ops.helper_layout; up to 8 lanes beyond, fewer where rows do not
//     fit).  Warp 0, the chain, runs only chain<MG>: each node it reads
//     a[k, i] = free_part<MG>(...).a from the lane's a row in shared memory
//     and writes s[k, i] into carry buffer k % 2.  It is alone on its
//     sub-partition (warp 4 exits at once), every lane of it runs (lanes
//     past the live ones shadow lane 0 and store nothing), so it never
//     diverges, and it issues no warp barrier and no fence;
//   * a period's nodes fall into groups of whole chunks (ops.helper_group,
//     about 64 nodes).  Warps 1-3 and 5-7, the helpers, take the groups of
//     every period in turn: once the chain has written group q of period
//     k-1, a helper computes a[k, .] of its nodes, one node a thread, with
//     free_part<MG> unchanged, and writes s[k-1, .] out (and `fin` after
//     the last period), so no warp writes the states beside the chain: in
//     the caller's [B, K, N], a lane's period a contiguous row, so the
//     wrapper permutes nothing.  A
//     helper has the period's other nodes of chain time for a group;
//   * handoffs: the chain arrives on an mbarrier a group (`done`, one
//     arrival a live lane, for its own stores) and tests one (`paired`)
//     before it needs a group's a; helpers chain a group's items through
//     a monotonic count (`ready`, release store, acquire load) and sleep
//     between polls.  A wait of seconds traps;
//   * the chain's loop: chunks of C float4s (C = 5, 4 or 3, the largest
//     that tiles the period), each unrolled, the float4 two on loaded into
//     a ring of C registers whose slots are compile-time, and a group's
//     last chunk peeled off with the group's bookkeeping, so the loop over
//     the other chunks steps two addresses and nothing else.  N that no
//     chunk tiles, or one group a period, steps node by node.
// Its states are the chain kernel's bit for bit (the same ops on the same
// values), which chip_smoke.py and tests/test_torch_cuda.py check.  On the
// way (PERF.md): the stream of float4s rotated through two registers
// (`r0 = r1; r1 = nx`), whose moves waited on the load just issued; every
// group's and period's bookkeeping in the chunk loop's body, which ptxas put
// between one chunk's last add and the next one's first mul; the wait
// inside the chunk loop, costly even when not taken.  Each was several
// cycles a node slower.  At [64, 6000, 400] this kernel takes 15.15 ms, 0.66
// of the chain bound, against 412.4 for the chain kernel's MackeyGlass
// route (NVIDIA H100 80GB HBM3, 700 W; launch/time_kernels.py).

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
#include <cstdint>

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

// ---- The helper-warp route (MackeyGlass): a chain warp that runs only
// chain<MG>, six helper warps that compute free_part<MG> behind it and write
// the states out.  See the top of the file.
constexpr int kHelperBlockWarps = 8;
constexpr int kHelperThreads = kHelperBlockWarps * kWarp;
// Warp w runs on sub-partition w % 4: the chain's, warp 0, is alone on its
// sub-partition (warp 4 exits at once); warps 1-3 and 5-7 are the helpers.
constexpr int kHelperWarps = 6;
constexpr int kMinHelperGroup = 8;           // nodes: two float4s
constexpr long long kWaitLimit = 1LL << 34;  // cycles: 8.7 s at 1980 MHz
constexpr int kHelperSleepNs = 32;           // a helper's poll (a group is ≈ 0.4 us of chain)
constexpr int kChainAhead = 2;               // float4s the chain loads ahead of their use

// The helper index of a warp, -1 for the chain's and the idle one.
__device__ __forceinline__ int helper_of(int warp) {
  if (warp == 0 || warp == 4) return -1;
  return warp < 4 ? warp - 1 : warp - 2;
}

// The node groups of a period: N / group of them (at least one), the last
// taking the remainder, so that every group but a lone one has at least
// `group` nodes.  ops.helper_groups computes the same.
__host__ __device__ __forceinline__ int helper_groups(int N, int group) {
  return N / group > 1 ? N / group : 1;
}

// The block's shared memory: mbarriers `done` and `paired` (shared-window
// addresses of the first of each), the counts `ready`, then rows of `stride`
// floats: the mask (one row, or one a lane), each lane's a row (the
// chain-free values a[k, .] of the period the chain runs next), and two
// carry buffers of a row a lane (period k in buffer k % 2; s0 in buffer 1).
//   done[q]:   the chain has written a period's states of node group q
//              (one arrival a live chain lane, each for its own stores);
//   paired[q]: a helper has written a period's a of node group q (one arrival);
//   ready[q]:  items of node group q done (a count that only grows).
// An mbarrier's wait names a phase by its parity, so a waiter must know that
// the phase before has completed: the chain waits on `paired` in order, and a
// helper waits on `done` of a group only once `ready` shows the group's item
// before done, which waited on the phase before.
struct HelperShared {
  uint32_t done, paired;
  unsigned* ready;
  float *mask, *a, *carry;
  int rows;  // floats of L rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t mbar_at(uint32_t base, int index) { return base + 8 * index; }

__device__ __forceinline__ void mbar_init(uint32_t b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b) : "memory");
}

// Whether the phase of parity `parity` of mbarrier `b` has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint32_t b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;"
      " selp.u32 %0, 1, 0, p; }"
      : "=r"(done)
      : "r"(b), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned get_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void put_release(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// A wait of more than kWaitLimit cycles (seconds: no handoff of a working
// block takes more than a period) traps, so that a broken handoff ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void check_wait(long long t0) {
  if (clock64() - t0 > kWaitLimit) __trap();
}

// Waits for a phase of an mbarrier: the chain spins (kSleepNs 0), a helper
// sleeps between polls, leaving the issue slots to the warps at work.
template <int kSleepNs>
__device__ __forceinline__ void mbar_wait(uint32_t b, uint32_t parity) {
  if (mbar_test(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_test(b, parity)) {
    if constexpr (kSleepNs > 0) __nanosleep(kSleepNs);
    check_wait(t0);
  }
}

// Waits until count `p` is at least `v`, sleeping between polls.
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned v) {
  if (get_acquire(p) >= v) return;
  const long long t0 = clock64();
  while (get_acquire(p) < v) {
    __nanosleep(kHelperSleepNs);
    check_wait(t0);
  }
}

// Shared-memory float4s for the chain at shared-window addresses, issued in
// program order (volatile), so that the compiler keeps each prefetch two
// float4s before its use.
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float mg_step(float a, float s, const Params& p) {
  return chain<MG>(Free{0.0f, a, 0.0f}, s, p);
}

// The chain when N is whole chunks of C float4s and a period has two groups
// or more, groups being whole chunks: one stream of float4s over every chunk
// of every period, each chunk's body unrolled with no branch in it, the
// float4 kAhead places on loaded into a ring of C registers (compile-time
// slots, so no register move waits on a load) before this one's chain
// runs, across chunk and group edges.  A group's last chunk, whose body
// loads the next group's first float4s, is peeled off: the loop over the
// others only steps two addresses, and before the last one the chain waits
// until a helper has written the next group's a, which it tests when the
// group starts (a test's result is read a group later, so its latency stays
// off the chain) and spins for only if it was not written.  `c0`, `c1`: the
// lane's rows of carry buffers 0 and 1; `s` is s0[N-1].
template <int C, int kAhead>
__device__ void helper_chain_chunks(const HelperShared& sh, const float* arow, float* c0,
                                    float* c1, int K, int N, int ng, int group, bool mine,
                                    float s, const Params& p) {
  static_assert(0 < kAhead && kAhead < C, "a ring slot is reloaded only after its use");
  constexpr uint32_t kChunkBytes = 16u * C;
  const int nchunk = N / (4 * C), gc = group / (4 * C), total = K * ng;
  const int last_gc = nchunk - (ng - 1) * gc;  // chunks of the last group
  // shared-window addresses of the lane's a row and carry rows
  const uint32_t a_row = smem_addr(arow), s_row0 = smem_addr(c0), s_row1 = smem_addr(c1);
  mbar_wait<0>(mbar_at(sh.paired, 0), 0);
  float4 r[C];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) r[d] = lds4(a_row + 16 * d);
  uint32_t ga = a_row, gs = s_row0;  // the chunk's a and states (buffer k % 2)
  // one chunk: its float4s' chain, the next chunk's first kAhead float4s
  // loaded from `na`
  const auto chunk = [&](uint32_t na) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      r[(j + kAhead) % C] = j + kAhead < C ? lds4(ga + 16 * (j + kAhead))
                                           : lds4(na + 16 * (j + kAhead - C));
      float4 o;
      o.x = s = mg_step(r[j].x, s, p);
      o.y = s = mg_step(r[j].y, s, p);
      o.z = s = mg_step(r[j].z, s, p);
      o.w = s = mg_step(r[j].w, s, p);
      if (mine) sts4(gs + 16 * j, o);
    }
    ga = na;
    gs += kChunkBytes;
  };
  int q = 0, k = 0;
  for (int g = 0; g < total; ++g) {
    const bool last_q = q + 1 == ng;  // the next group is the next period's first
    const int n_chunks = last_q ? last_gc : gc;
    const uint32_t pn = mbar_at(sh.paired, last_q ? 0 : q + 1);
    const uint32_t parity = (last_q ? k + 1 : k) & 1;
    const bool more = g + 1 < total;
    const bool ready = !more || mbar_test(pn, parity);
    for (int cc = 0; cc + 1 < n_chunks; ++cc) chunk(ga + kChunkBytes);
    if (!ready) mbar_wait<0>(pn, parity);
    chunk(last_q ? a_row : ga + kChunkBytes);  // at the period's end, the next period's first
    if (mine) mbar_arrive(mbar_at(sh.done, q));  // each lane for its own stores: no warp barrier
    if (last_q) {
      q = 0;
      ++k;
      gs = (k & 1) ? s_row1 : s_row0;
    } else {
      ++q;
    }
  }
}

// The chain otherwise (N not whole chunks, or one group a period): group by
// group, each waited for before its first node, its nodes one by one.
__device__ void helper_chain_nodes(const HelperShared& sh, const float* arow, float* c0, float* c1,
                                   int K, int N, int ng, int group, bool mine, float s,
                                   const Params& p) {
  for (int k = 0; k < K; ++k) {
    float* const cur = (k & 1) ? c1 : c0;
    for (int q = 0; q < ng; ++q) {
      mbar_wait<0>(mbar_at(sh.paired, q), k & 1);
      const int lo = q * group, hi = q + 1 < ng ? lo + group : N;
      for (int i = lo; i < hi; ++i) {
        s = mg_step(arow[i], s, p);
        if (mine) cur[i] = s;
      }
      if (mine) mbar_arrive(mbar_at(sh.done, q));
    }
  }
}

// Helper warp h: items h, h + kHelperWarps, ... of the sequence of every
// period's node groups, (k, q) in order for k = 0 .. K.  Item (k, q) waits
// until the chain has written period k-1 of group q (s0 at k = 0), then for
// every live lane and node i of the group, one node a thread: a[k, i] =
// free_part<MG>(j[k] m[i], s[k-1, i]) into the lane's a row (k < K), and
// s[k-1, i] out to `out` (k > 0) and, at k = K, to `fin`.  The chain comes
// back to a group N nodes after it left it, so a helper has the period's
// other nodes of chain time for its item, and up to six items are in flight.
template <typename OutT>
__device__ void helper_items(const HelperShared& sh, const float* __restrict__ j, int per_lane,
                             float* __restrict__ fin, OutT* __restrict__ out, int B, int K, int N,
                             int ng, int group, int stride, int lane0, int live, int h, int tl,
                             const Params& p) {
  const size_t lanes = static_cast<size_t>(B);
  const int total = (K + 1) * ng;
  for (int seq = h; seq < total; seq += kHelperWarps) {
    const int k = seq / ng, q = seq - k * ng;
    if (k > 0) {
      wait_count(sh.ready + q, k);                                   // item (k-1, q) done
      mbar_wait<kHelperSleepNs>(mbar_at(sh.done, q), (k - 1) & 1);  // s[k-1] of the group written
    }
    const int lo = q * group, hi = q + 1 < ng ? lo + group : N;
    const float* const prev = sh.carry + ((k + 1) & 1) * sh.rows;  // buffer (k-1) % 2
    for (int l = 0; l < live; ++l) {
      const float* const sp = prev + l * stride;
      float* const ar = sh.a + l * stride;
      const float* const mr = sh.mask + (per_lane ? l * stride : 0);
      const size_t b = lane0 + l;
      const float jk = k < K ? j[static_cast<size_t>(k) * lanes + b] : 0.0f;
      // out is [B, K, N]: the lane's row of period k-1, contiguous
      for (int i = lo + tl; i < hi; i += kWarp) {
        const float s = sp[i];
        if (k < K) ar[i] = free_part<MG>(__fmul_rn(jk, mr[i]), s, p).a;
        if (k > 0) store(out + (b * K + (k - 1)) * N + i, s);
        if (k == K) fin[static_cast<size_t>(i) * lanes + b] = s;
      }
    }
    __syncwarp();
    if (tl == 0) {
      put_release(sh.ready + q, k + 1);
      if (k < K) mbar_arrive(mbar_at(sh.paired, q));
    }
  }
}

// j [K, B]; mask [N] or [N, B]; fin [N, B] (s0 in, final state out);
// out [B, K, N] (the caller's layout: a helper writes a lane's period row
// contiguously, and the wrapper permutes nothing).  Block x holds lanes
// [x*L, x*L + L): warp 0 runs their chains (one thread a lane), warps 1-3
// and 5-7 the helpers.
template <typename OutT>
__global__ void __launch_bounds__(kHelperThreads)
dfr_scan_helper_kernel(const float* __restrict__ j, const float* __restrict__ mask, int per_lane,
                       float* __restrict__ fin, OutT* __restrict__ out, int B, int K, int N,
                       int L, int stride, int group, Params p) {
  extern __shared__ float4 smem4[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem4);
  const int ng = helper_groups(N, group);
  HelperShared sh;
  sh.done = smem_addr(base);
  sh.paired = mbar_at(sh.done, ng);
  sh.ready = reinterpret_cast<unsigned*>(base + 16 * ng);
  sh.mask = reinterpret_cast<float*>(base + ((20 * ng + 15) & ~15));
  sh.rows = L * stride;
  sh.a = sh.mask + (per_lane ? sh.rows : stride);
  sh.carry = sh.a + sh.rows;
  const int t = threadIdx.x, warp = t / kWarp, tl = t % kWarp;
  const int lane0 = blockIdx.x * L;
  const int live = min(L, B - lane0);
  const size_t lanes = static_cast<size_t>(B);
  if (t == 0) {
    for (int q = 0; q < ng; ++q) {
      mbar_init(mbar_at(sh.done, q), live);  // one arrival a live chain lane
      mbar_init(mbar_at(sh.paired, q), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int q = t; q < ng; q += kHelperThreads) sh.ready[q] = 0;
  // stage in: s0 into buffer 1, the "previous period" of period 0
  for (int e = t; e < N * live; e += kHelperThreads) {
    const int i = e / live, l = e - i * live;
    const size_t g = static_cast<size_t>(i) * lanes + lane0 + l;
    sh.carry[sh.rows + l * stride + i] = fin[g];
    if (per_lane) sh.mask[l * stride + i] = mask[g];
  }
  if (!per_lane) {
    for (int i = t; i < N; i += kHelperThreads) sh.mask[i] = mask[i];
  }
  __syncthreads();
  if (warp == 0) {
    // every lane of the warp runs, so that it never diverges; lanes past the
    // block's live lanes shadow lane 0 and store nothing
    const bool mine = tl < live;
    const int l = mine ? tl : 0;
    float* const c0 = sh.carry + l * stride;
    float* const c1 = c0 + sh.rows;
    const float* const arow = sh.a + l * stride;
    const float s0 = c1[N - 1];
    // the unrolled chunk of the largest C of 5, 4, 3 float4s that tiles the
    // period and the groups (ops.helper_chunk); else node by node
    const auto tiles = [&](int c) { return ng >= 2 && N % (4 * c) == 0 && group % (4 * c) == 0; };
    if (tiles(5)) {
      helper_chain_chunks<5, kChainAhead>(sh, arow, c0, c1, K, N, ng, group, mine, s0, p);
    } else if (tiles(4)) {
      helper_chain_chunks<4, kChainAhead>(sh, arow, c0, c1, K, N, ng, group, mine, s0, p);
    } else if (tiles(3)) {
      helper_chain_chunks<3, kChainAhead>(sh, arow, c0, c1, K, N, ng, group, mine, s0, p);
    } else {
      helper_chain_nodes(sh, arow, c0, c1, K, N, ng, group, mine, s0, p);
    }
  } else if (helper_of(warp) >= 0) {
    helper_items(sh, j, per_lane, fin, out, B, K, N, ng, group, stride, lane0, live,
                 helper_of(warp), tl, p);
  }
}

// Routes of the C entry point's `route`: the chain kernel, or the helper-warp
// kernel (MackeyGlass only).
enum Route { kRouteChain = 0, kRouteHelpers = 1 };

struct Layout {
  int lanes, blocks, stride, group, smem;
};

// The helper-warp kernel at the layout ops.helper_layout chose:
// cudaErrorInvalidValue for a layout that does not cover the batch, a row or
// the block's shared memory, else the error of the attribute call or the
// launch.
template <typename OutT>
int launch_helpers(const float* j, const float* mask, int per_lane, float* fin, OutT* out, int B,
                   int K, int N, const Layout& lay, Params p, cudaStream_t stream) {
  if (lay.lanes < 1 || lay.lanes > kWarp || lay.group < kMinHelperGroup || lay.group % kGroup != 0 ||
      static_cast<long long>(lay.lanes) * lay.blocks < B || lay.stride < N ||
      lay.stride % kGroup != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ng = helper_groups(N, lay.group);
  const long long head = (20 * ng + 15) / 16 * 16;
  const long long rows = (per_lane ? lay.lanes : 1) + 3LL * lay.lanes;
  if (lay.smem < head + 4 * rows * lay.stride) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = dfr_scan_helper_kernel<OutT>;
  if (lay.smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<lay.blocks, kHelperThreads, lay.smem, stream>>>(j, mask, per_lane, fin, out, B, K, N,
                                                           lay.lanes, lay.stride, lay.group, p);
  return static_cast<int>(cudaGetLastError());
}

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
int dispatch(int model_id, int route, const float* j, const float* mask, int per_lane, float* fin,
             OutT* out, int B, int K, int N, const Layout& lay, Params p, cudaStream_t stream) {
  if (route == kRouteHelpers) {
    if (model_id != MACKEY_GLASS) return static_cast<int>(cudaErrorInvalidValue);
    return launch_helpers(j, mask, per_lane, fin, out, B, K, N, lay, p, stream);
  }
  if (route != kRouteChain) return static_cast<int>(cudaErrorInvalidValue);
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
// out f32 (out_bf16 = 0) or bf16 (out_bf16 = 1), [K, N, B] on the chain
// route and [B, K, N] on the helper-warp route.
// lanes, blocks, stride, group, smem_bytes: the block layout (lanes a
// block, blocks, carry-row pitch in floats, nodes a handoff between the
// chain and the helpers, dynamic shared bytes) of ops.scan_layout for the
// chain kernel (route 0, group unused) or of ops.helper_layout for the
// helper-warp kernel (route 1, MackeyGlass only); MZISine, which keeps no
// rows, ignores it.  params: the model's n_params (at most 16) f32
// constants, its kernel_spec(), copied into the launch.  Returns the
// cudaError_t of the attribute call and the launch (0 on success);
// cudaErrorInvalidValue for more than 16 constants, a route the model has
// not, or a layout that does not cover the batch or a row.
extern "C" int dfr_scan_launch(const void* j, const void* mask, int per_lane, void* fin, void* out,
                               int out_bf16, int B, int K, int N, int lanes, int blocks,
                               int stride, int group, int smem_bytes, int route, int model_id,
                               const float* params, int n_params, void* stream) {
  if (n_params < 0 || n_params > kMaxParams) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int c = 0; c < n_params; ++c) p.v[c] = params[c];
  const Layout lay{lanes, blocks, stride, group, smem_bytes};
  const auto* jf = static_cast<const float*>(j);
  const auto* mf = static_cast<const float*>(mask);
  auto* ff = static_cast<float*>(fin);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return dispatch(model_id, route, jf, mf, per_lane, ff, static_cast<__nv_bfloat16*>(out), B, K,
                    N, lay, p, s);
  }
  return dispatch(model_id, route, jf, mf, per_lane, ff, static_cast<float*>(out), B, K, N, lay, p,
                  s);
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
