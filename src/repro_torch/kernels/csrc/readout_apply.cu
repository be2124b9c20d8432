// Readout apply: the fitted linear readout on a chunk of reservoir states,
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package applies its readout with
// `einsum(..., preferred_element_type=f32)` (src/repro/pipeline/
// experiment.py:336-337), which reads bf16 features and accumulates in
// f32 without widening them first.  PyTorch has no bf16 x f32 -> f32
// matmul, so the port's streamed evaluation and session prediction widened
// each bf16 chunk's [B, T, N + 1] features to an f32 copy before the
// product.  This kernel reads the features in their own type instead:
//
//     y[b, t, c] = sum_{f < N} x[b, t, f] * w[b, f, c] + w[b, N, c]
//
// x [B, T, N] f32 or bf16 (row-major, contiguous), w [B, N + 1, C] f32 (the
// bias row last; a batch stride of 0 broadcasts one readout over B, as the
// WDM shared readout's [1, N + 1, C] may), y [B, T, C] f32.  Each product
// is taken in f32 and accumulated in f32; the features are never copied.
//
// One warp a row (b, t): lane l sums the products of nodes l, l + 32, ...
// for up to kCols target columns at a time, the warp adds its 32 partial
// sums by a butterfly of shuffles, and lane 0 adds the bias row and writes
// y.  Consecutive lanes read consecutive features, so a row's reads are
// coalesced; w[b] is read through the read-only cache, shared by the T rows
// of instance b.
//
// What bounds it: bytes.  The features are read once (2 or 4 bytes a
// node), for 2 flops a node and target column; at C = 1 that is 1 flop a
// byte of bf16, far below the card's balance point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    readout_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ y, long long rows, int t_len, int n, int cols,
                         long long w_batch_stride) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long b = row / t_len;
  const T* xr = x + row * n;
  const float* wb = w + b * w_batch_stride;
  float* yr = y + row * cols;
  for (int c0 = 0; c0 < cols; c0 += kCols) {
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
    for (int f = lane; f < n; f += 32) {
      const float xv = load_f32(xr + f);
      const float* wf = wb + static_cast<size_t>(f) * cols + c0;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (c0 + k < cols) acc[k] = acc[k] + xv * __ldg(wf + k);
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] = acc[k] + __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
      const float* bias = wb + static_cast<size_t>(n) * cols + c0;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (c0 + k < cols) yr[c0 + k] = acc[k] + __ldg(bias + k);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, float* y, long long rows, int t_len, int n, int cols,
           long long w_batch_stride, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  readout_apply_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, y, rows, t_len, n, cols, w_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, T, N] (x_bf16 = 0: f32, 1: bf16), w [B or 1, N + 1, C] f32 with
// batch stride w_batch_stride floats (0 broadcasts one readout), y [B, T, C]
// f32; all row-major and contiguous.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int readout_apply_launch(const void* x, int x_bf16, const float* w, float* y,
                                    int batch, int t_len, int n, int cols,
                                    long long w_batch_stride, void* stream) {
  if (batch < 0 || t_len < 1 || n < 0 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * t_len;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch<__nv_bfloat16>(x, w, y, rows, t_len, n, cols, w_batch_stride, s);
  return launch<float>(x, w, y, rows, t_len, n, cols, w_batch_stride, s);
}
