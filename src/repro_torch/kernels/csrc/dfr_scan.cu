// Fused masking + delayed-feedback reservoir scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dfr_scan_tiled`
// (src/repro/kernels/dfr_scan/dfr_scan.py:97, body `_kernel` :60).
// For each batch lane b, period k and virtual node i:
//     u = j[k] * m[i];   s_i = node_update(u, s_prev[i], s_last)
// where s_prev[i] is the same node one period earlier and s_last the
// previous node.  Every state is emitted; the final state is the carry.
//
// What bounds it on this card: the node chain.  The branch bit of node
// i-1 feeds the value of node i (nonlinear.py), so a lane is K*N dependent
// steps (compare, add, select), and batch lanes are the only parallel axis.
// At B = 64, K = 1000, N = 900 the states are 230 MB (~70 us of HBM
// bandwidth) but the chain is 900k dependent steps per lane: milliseconds
// even at a few cycles per step, and two warps cannot fill the card.
//
// Design:
//   * one thread per lane, a loop over K and inside it a loop over N;
//   * lane-contiguous layouts (j [K, B], mask [N] or [N, B], carry [N, B],
//     out [K, N, B]) so every load and store of a warp is coalesced;
//   * the carry s_prev lives in the `fin` output buffer in global memory
//     (N = 900 is 3.6 KB per lane, 460 KB for 128 lanes: more than a
//     block's shared memory); each thread reads s_prev[i] and writes it
//     back in place, so no two threads touch one word; it stays L1/L2
//     resident;
//   * the carry and mask of CHUNK nodes are loaded before their chain is
//     evaluated, so the load latency is paid once per chunk and not once
//     per dependent step;
//   * 32 threads per block, so a small batch spreads over several SMs
//     (and their L1s) instead of sharing one.
//
// Numerics: compute is f32 whatever the output type.  Every product and
// sum is a separately rounded __fmul_rn/__fadd_rn (and the build passes
// -fmad=false), mirroring the reference's op order, so the kernel equals
// its plain PyTorch version up to libm differences (sinf/powf).  The
// branch is the strict `u > s_prev_node` of jnp.where: a NaN takes the
// discharge branch in both.  Feeding `fin` back as the next call's carry
// resumes bit-exactly, since `fin` holds exactly the f32 values the
// uninterrupted scan keeps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Must match the KERNEL_* ids in repro_torch/core/nonlinear.py.
enum ModelId { SILICON_MR = 0, SILICON_MR_LITERAL = 1, MACKEY_GLASS = 2, MZI_SINE = 3 };

struct Params {
  float p0, p1, p2, p3;
};

constexpr int kThreads = 32;
constexpr int kChunk = 8;

template <int M>
__device__ __forceinline__ float node_update(float u, float s_tau, float s_pn, const Params& p);

// SiliconMR, theta-corrected Eq. (6-7): p0 = alpha, p1 = gamma, p2 = beta_tpa.
template <>
__device__ __forceinline__ float node_update<SILICON_MR>(float u, float s_tau, float s_pn,
                                                          const Params& p) {
  float drive = __fadd_rn(u, __fmul_rn(p.p1, s_tau));
  if (p.p2 != 0.0f) drive = __fdiv_rn(drive, __fadd_rn(1.0f, __fmul_rn(p.p2, drive)));
  const float pre = __fmul_rn(p.p0, drive);
  const float charge = __fadd_rn(pre, s_pn);
  const float discharge = __fadd_rn(pre, __fmul_rn(s_pn, __fsub_rn(1.0f, p.p0)));
  return (u > s_pn) ? charge : discharge;
}

// SiliconMRLiteral, Eq. (6-7) as printed: p0 = alpha, p1 = gamma.
template <>
__device__ __forceinline__ float node_update<SILICON_MR_LITERAL>(float u, float s_tau, float s_pn,
                                                                  const Params& p) {
  const float pre = __fmul_rn(__fadd_rn(u, __fmul_rn(p.p1, s_tau)), p.p0);
  const float charge = __fadd_rn(pre, s_tau);
  const float discharge = __fadd_rn(pre, __fmul_rn(s_tau, __fsub_rn(1.0f, p.p0)));
  return (u > s_pn) ? charge : discharge;
}

// MackeyGlass: p0 = decay c, p1 = eta, p2 = gamma_in, p3 = exponent p.
template <>
__device__ __forceinline__ float node_update<MACKEY_GLASS>(float u, float s_tau, float s_pn,
                                                            const Params& p) {
  const float x = __fadd_rn(s_tau, __fmul_rn(p.p2, u));
  const float drive = __fdiv_rn(__fmul_rn(p.p1, x), __fadd_rn(1.0f, powf(fabsf(x), p.p3)));
  return __fadd_rn(__fmul_rn(p.p0, s_pn), __fmul_rn(__fsub_rn(1.0f, p.p0), drive));
}

// MZISine: p0 = phi, p1 = beta_in, p2 = alpha_fb.  No theta coupling.
template <>
__device__ __forceinline__ float node_update<MZI_SINE>(float u, float s_tau, float s_pn,
                                                        const Params& p) {
  const float arg = __fadd_rn(__fadd_rn(p.p0, __fmul_rn(p.p1, u)), __fmul_rn(p.p2, s_tau));
  const float s = sinf(arg);
  return __fmul_rn(s, s);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

template <int M, typename OutT>
__global__ void __launch_bounds__(kThreads)
dfr_scan_kernel(const float* __restrict__ j, const float* __restrict__ mask, int per_lane,
                float* __restrict__ fin, OutT* __restrict__ out, int B, int K, int N, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t lanes = static_cast<size_t>(B);
  float s_last = fin[static_cast<size_t>(N - 1) * lanes + b];
  for (int k = 0; k < K; ++k) {
    const float jk = j[static_cast<size_t>(k) * lanes + b];
    OutT* out_k = out + static_cast<size_t>(k) * N * lanes + b;
    for (int i0 = 0; i0 < N; i0 += kChunk) {
      float s_tau[kChunk], m[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = i0 + c;
        if (i < N) {
          s_tau[c] = fin[static_cast<size_t>(i) * lanes + b];
          m[c] = per_lane ? mask[static_cast<size_t>(i) * lanes + b] : mask[i];
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = i0 + c;
        if (i < N) {
          const float s = node_update<M>(__fmul_rn(jk, m[c]), s_tau[c], s_last, p);
          fin[static_cast<size_t>(i) * lanes + b] = s;
          store(out_k + static_cast<size_t>(i) * lanes, s);
          s_last = s;
        }
      }
    }
  }
}

template <int M, typename OutT>
void launch(const float* j, const float* mask, int per_lane, float* fin, OutT* out, int B, int K,
            int N, Params p, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  dfr_scan_kernel<M, OutT><<<blocks, kThreads, 0, stream>>>(j, mask, per_lane, fin, out, B, K, N, p);
}

template <typename OutT>
int dispatch(int model_id, const float* j, const float* mask, int per_lane, float* fin, OutT* out,
             int B, int K, int N, Params p, cudaStream_t stream) {
  switch (model_id) {
    case SILICON_MR: launch<SILICON_MR>(j, mask, per_lane, fin, out, B, K, N, p, stream); break;
    case SILICON_MR_LITERAL:
      launch<SILICON_MR_LITERAL>(j, mask, per_lane, fin, out, B, K, N, p, stream);
      break;
    case MACKEY_GLASS: launch<MACKEY_GLASS>(j, mask, per_lane, fin, out, B, K, N, p, stream); break;
    case MZI_SINE: launch<MZI_SINE>(j, mask, per_lane, fin, out, B, K, N, p, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// j [K, B] f32; mask [N] (per_lane = 0) or [N, B] (per_lane = 1) f32;
// fin [N, B] f32 holds s0 on entry and the final state on exit;
// out [K, N, B] f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dfr_scan_launch(const void* j, const void* mask, int per_lane, void* fin, void* out,
                               int out_bf16, int B, int K, int N, int model_id, float p0, float p1,
                               float p2, float p3, void* stream) {
  const Params p{p0, p1, p2, p3};
  const auto* jf = static_cast<const float*>(j);
  const auto* mf = static_cast<const float*>(mask);
  auto* ff = static_cast<float*>(fin);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    return dispatch(model_id, jf, mf, per_lane, ff, static_cast<__nv_bfloat16*>(out), B, K, N, p, s);
  }
  return dispatch(model_id, jf, mf, per_lane, ff, static_cast<float*>(out), B, K, N, p, s);
}
