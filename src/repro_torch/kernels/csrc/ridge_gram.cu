// Batched Gram and moment accumulation for the ridge readout, Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `gram_tiled_batched`
// (src/repro/kernels/ridge_gram/ridge_gram.py:118, body `_kernel` :49 with
// has_init=False) and `gram_tiled_batched_into` (:147, the same body with
// has_init=True and the running stacks aliased onto the outputs):
//     G[b] = G0[b] + X[b]^T X[b]      [B, F, F] f32
//     c[b] = c0[b] + X[b]^T Y[b]      [B, F, C] f32
// with G0 = c0 = 0 for the one-shot form.
//
// What bounds it on this card: operations.  2*B*T*F^2 FLOP (9.8e10 at the
// main path's B = 64, T = 940, F = 901) against 0.43 GB of traffic (X read
// once, G written once: 0.13 ms at 3.35 TB/s), so the f32 rate outside the
// tensor cores (~67 TFLOP/s on an H100 SXM) sets the floor, ~1.5 ms.  Tensor cores are ruled out: TF32 keeps ~3 decimal
// digits, and the Gram squares cond(X), which the f32 eigh solve of the
// readout was calibrated against.
//
// Design:
//   * one block per (j-tile, i-tile, b) of G, 64 x 64 outputs, 256
//     threads, 4 x 4 outputs per thread held in registers;
//   * X[b, t-tile, i-cols] and X[b, t-tile, j-cols] staged through shared
//     memory 16 rows at a time (bf16 X is widened to f32 on load);
//   * the blocks of j-tile 0 also accumulate c for their i-columns, in
//     shared memory (each element owned by one thread);
//   * ragged T and F edges are masked in the kernel: no padding copies.
//
// Exactness: each output element has ONE accumulator, updated by IEEE f32
// fmaf in ascending t.  No split over T across blocks, no atomics.  So the
// accumulate-into form folding a stream chunk by chunk is bitwise equal to
// one pass over the whole stream, for any chunk split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kRows = 16;      // T rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT, bool HAS_INIT>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const XT* __restrict__ x, const float* __restrict__ y, float* g, float* c, int T, int F,
            int C) {
  __shared__ __align__(16) float xi[kRows][kTile];
  __shared__ __align__(16) float xj[kRows][kTile];
  extern __shared__ float dyn[];  // c accumulators [kTile * C], then Y rows [kRows * C]
  float* c_acc = dyn;
  float* ys = dyn + kTile * C;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool do_c = blockIdx.x == 0;

  const XT* xb = x + static_cast<size_t>(b) * T * F;
  const float* yb = y + static_cast<size_t>(b) * T * C;
  float* gb = g + static_cast<size_t>(b) * F * F;
  float* cb = c + static_cast<size_t>(b) * F * C;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gi = i0 + ty * 4 + r;
      const int gj = j0 + tx * 4 + q;
      acc[r][q] = (HAS_INIT && gi < F && gj < F) ? gb[static_cast<size_t>(gi) * F + gj] : 0.0f;
    }
  }
  if (do_c) {
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int fi = i0 + e / C;
      c_acc[e] = (HAS_INIT && fi < F) ? cb[static_cast<size_t>(fi) * C + e % C] : 0.0f;
    }
  }

  for (int t0 = 0; t0 < T; t0 += kRows) {
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile;
      const int f = e % kTile;
      const int t = t0 + r;
      const size_t row = static_cast<size_t>(t) * F;
      xi[r][f] = (t < T && i0 + f < F) ? widen(xb[row + i0 + f]) : 0.0f;
      xj[r][f] = (t < T && j0 + f < F) ? widen(xb[row + j0 + f]) : 0.0f;
    }
    if (do_c) {
      for (int e = tid; e < kRows * C; e += kThreads) {
        const int t = t0 + e / C;
        ys[e] = t < T ? yb[static_cast<size_t>(t) * C + e % C] : 0.0f;
      }
    }
    __syncthreads();

    const int rows = min(kRows, T - t0);
    for (int r = 0; r < rows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xi[r][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&xj[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], vv[q], acc[p][q]);
      }
    }
    if (do_c) {
      for (int e = tid; e < kTile * C; e += kThreads) {
        const int f = e / C;
        const int col = e % C;
        float s = c_acc[e];
        for (int r = 0; r < rows; ++r) s = fmaf(xi[r][f], ys[r * C + col], s);
        c_acc[e] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gi = i0 + ty * 4 + r;
      const int gj = j0 + tx * 4 + q;
      if (gi < F && gj < F) gb[static_cast<size_t>(gi) * F + gj] = acc[r][q];
    }
  }
  if (do_c) {
    for (int e = tid; e < kTile * C; e += kThreads) {
      const int fi = i0 + e / C;
      if (fi < F) cb[static_cast<size_t>(fi) * C + e % C] = c_acc[e];
    }
  }
}

template <typename XT, bool HAS_INIT>
void launch(const void* x, const float* y, float* g, float* c, int B, int T, int F, int C,
            cudaStream_t stream) {
  const int tiles = (F + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  const size_t smem = static_cast<size_t>(kTile + kRows) * C * sizeof(float);
  gram_kernel<XT, HAS_INIT>
      <<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(x), y, g, c, T, F, C);
}

}  // namespace

// x [B, T, F] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); y [B, T, C] f32;
// g [B, F, F] and c [B, F, C] f32.  has_init = 1 reads the running stacks
// from g and c and adds onto them in place; has_init = 0 overwrites them.
// C <= 128 (shared memory; checked by the wrapper).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ridge_gram_launch(const void* x, int x_bf16, const void* y, void* g, void* c,
                                 int has_init, int B, int T, int F, int C, void* stream) {
  const auto* yf = static_cast<const float*>(y);
  auto* gf = static_cast<float*>(g);
  auto* cf = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (has_init) launch<__nv_bfloat16, true>(x, yf, gf, cf, B, T, F, C, s);
    else launch<__nv_bfloat16, false>(x, yf, gf, cf, B, T, F, C, s);
  } else {
    if (has_init) launch<float, true>(x, yf, gf, cf, B, T, F, C, s);
    else launch<float, false>(x, yf, gf, cf, B, T, F, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}
