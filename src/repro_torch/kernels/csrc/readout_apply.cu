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
// is taken in f32 and summed in f32; the features are never copied.
//
// What bounds it: bytes.  The features are read once (2 or 4 bytes a
// node), for 2 flops a node and target column; at C = 1 that is 1 flop a
// byte of bf16, far below the card's balance point.  The first version put
// a warp on a row with 2- or 4-byte loads, about one in flight a lane, and
// ran at 0.2 of the byte bound; at the serving tick (64 f32 a row) it was
// 1.9x torch.baddbmm.
//
// The design (the launch plan is `apply_plan` in
// kernels/readout_apply/ops.py, which the CPU tests simulate):
//
// * A group of G lanes a row, G in {4, 8, 16} from the row's length in
//   16-byte chunks (half of them, rounded up to a power of two): N = 64 f32
//   is 16 chunks, so 8 lanes take a row, two chunks a lane, and a block of
//   128 threads an instance's 32 rows; N = 900 bf16 is 112 chunks, so 16
//   lanes take a row, four chunks a lane a pass, in two passes, and a block
//   of 256 threads 16 rows.
// * A row is a scalar head up to its first 16-byte boundary, a body of
//   16-byte chunks (8 bf16 or 4 f32) and a scalar tail, each element read
//   once.  A bf16 row of N = 900 is 1800 bytes, so every other row starts 8
//   bytes off a boundary: its head and tail are 4 elements each.
// * A block takes rows of one instance (16 and 32 at the two shapes above).
//   Each pass, every lane issues its body chunks of the pass, for all its
//   rows, as 16-byte cp.async copies straight into shared memory (no
//   register held), up to 16 KB a block in flight at once; the head and
//   tail elements are loaded into registers before that.  Data landing in registers would cap the bytes
//   in flight by the register file; shared memory holds more.
// * Per pass the block also stages the slice of w[b] its rows need,
//   transposed so that the lanes of a group, which read consecutive chunks,
//   read consecutive words for each element of a chunk: no bank conflict,
//   where reading w from global memory at the lanes' 16- or 32-byte stride
//   took 4-8 L1 wavefronts a load.  Head, tail and bias are read from the
//   same slice.
// * Up to KC target columns a sweep (1, or 4 where C > 1); the group adds
//   its partial sums by log2(G) shuffles over the columns that exist.  One
//   fixed order of sums a row and no atomics: the result is the same bits
//   from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 16 bytes of a chunk as its elements in f32 (bf16 -> f32 is exact).
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[4]) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[8]) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// 16 bytes global -> shared without a register (Ampere's cp.async).
__device__ __forceinline__ void copy16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Floats of the staged w slice, [KC][E][seg + 1], rounded to whole 16 bytes.
__host__ __device__ constexpr int ws_floats(int kc, int elems, int seg) {
  return (kc * elems * (seg + 1) + 3) & ~3;
}

template <typename T, int KC, int RG>
__global__ void __launch_bounds__(kMaxThreads)
    readout_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ y, int t_len, int n, int cols,
                         long long w_batch_stride, int log_group, int seg, int blocks_per_b,
                         int passes) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int kHeadTail = (E + 2) / 4;              // head or tail elements a lane, G >= 4
  extern __shared__ __align__(16) float smem[];
  const int kQ = seg + 1;                             // odd: the slice's rows start in other banks
  float* ws = smem;                                   // w's slice [KC][E][kQ]
  uint4* xs = reinterpret_cast<uint4*>(smem + ws_floats(KC, E, seg));  // x's chunks [rows][seg]

  const int group = 1 << log_group;
  const int gl = threadIdx.x & (group - 1);           // lane within the row's group
  const int per_group = static_cast<int>(blockDim.x) >> log_group;
  const int b = static_cast<int>(blockIdx.x) / blocks_per_b;
  const int t0 = (static_cast<int>(blockIdx.x) - b * blocks_per_b) * RG * per_group;
  const float* wb = w + b * w_batch_stride;

  // This lane's rows (one a row group): the split of each into a head up to
  // its first 16-byte boundary, body chunks and a tail; head and tail
  // elements loaded first.
  const T* xr[RG];
  int slot[RG], head[RG], body[RG], tail0[RG];
  bool live[RG];
  float xh[RG][kHeadTail], xt[RG][kHeadTail];
#pragma unroll
  for (int g = 0; g < RG; ++g) {
    slot[g] = g * per_group + (static_cast<int>(threadIdx.x) >> log_group);
    live[g] = t0 + slot[g] < t_len;
    xr[g] = x + (static_cast<long long>(b) * t_len + (live[g] ? t0 + slot[g] : 0)) * n;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(xr[g]) & 15);
    head[g] = min(n, ((16 - mis) & 15) / static_cast<int>(sizeof(T)));
    body[g] = (n - head[g]) / E;
    tail0[g] = head[g] + body[g] * E;
#pragma unroll
    for (int i = 0; i < kHeadTail; ++i) {
      const int fh = gl + i * group, ft = tail0[g] + gl + i * group;
      xh[g][i] = (live[g] && fh < head[g]) ? to_f32(xr[g][fh]) : 0.0f;
      xt[g][i] = (live[g] && ft < n) ? to_f32(xr[g][ft]) : 0.0f;
    }
  }

  for (int c0 = 0; c0 < cols; c0 += KC) {
    const int kc = KC == 1 ? 1 : min(KC, cols - c0);
    float acc[RG][KC];
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[g][k] = 0.0f;
    for (int p = 0; p < passes; ++p) {
      __syncthreads();                                // the last pass has read xs and ws
      // 1. every body chunk of the pass, all rows of the block, in flight
      //    at once: global -> shared, no register held
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        if (!live[g]) continue;
        const uint4* xb = reinterpret_cast<const uint4*>(xr[g] + head[g]) + p * seg;
        const int m = min(seg, body[g] - p * seg);
        for (int j = gl; j < m; j += group) copy16(xs + slot[g] * seg + j, xb + j);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      // 2. stage w[b, f0 : f0 + (seg + 1) * E] (bias row included where it
      //    falls), columns c0 .. c0 + kc, as ws[k][f % E][f / E]
      const int f0 = p * seg * E;
      const int len = min((seg + 1) * E, n + 1 - f0);
      for (int i = threadIdx.x; i < len * kc; i += blockDim.x) {
        const int fr = i / kc, k = i - fr * kc;
        ws[(k * E + (fr & (E - 1))) * kQ + fr / E] =
            __ldg(wb + static_cast<size_t>(f0 + fr) * cols + c0 + k);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      // 3. the products: head (pass 0's slice), body chunk by chunk, tail
      //    (the last slice), in that order
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        if (!live[g]) continue;
        if (p == 0) {
#pragma unroll
          for (int i = 0; i < kHeadTail; ++i) {
            const int f = gl + i * group;
            if (f < head[g]) {
#pragma unroll
              for (int k = 0; k < KC; ++k)
                if (k < kc)
                  acc[g][k] = acc[g][k] + xh[g][i] * ws[(k * E + (f & (E - 1))) * kQ + f / E];
            }
          }
        }
        const int m = min(seg, body[g] - p * seg);
        for (int j = gl; j < m; j += group) {
          float xv[E];
          unpack(xs[slot[g] * seg + j], xv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int fr = head[g] + e;                // element of the chunk, from its start
            const float* wr = ws + (fr & (E - 1)) * kQ + j + fr / E;
#pragma unroll
            for (int k = 0; k < KC; ++k)
              if (k < kc) acc[g][k] = acc[g][k] + xv[e] * wr[k * E * kQ];
          }
        }
        if (p == passes - 1) {
#pragma unroll
          for (int i = 0; i < kHeadTail; ++i) {
            const int fr = tail0[g] + gl + i * group - f0;
            if (fr < n - f0) {
#pragma unroll
              for (int k = 0; k < KC; ++k)
                if (k < kc)
                  acc[g][k] = acc[g][k] + xt[g][i] * ws[(k * E + (fr & (E - 1))) * kQ + fr / E];
            }
          }
        }
      }
    }
    // 4. each group's sum over its lanes, then the bias row (in the last slice)
    const int fb = n - (passes - 1) * seg * E;
#pragma unroll
    for (int g = 0; g < RG; ++g) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < kc) {
          for (int off = group >> 1; off > 0; off >>= 1)
            acc[g][k] = acc[g][k] + __shfl_xor_sync(0xffffffffu, acc[g][k], off);
        }
      }
      if (live[g] && gl == 0) {
        float* yr = y + (static_cast<long long>(b) * t_len + t0 + slot[g]) * cols + c0;
#pragma unroll
        for (int k = 0; k < KC; ++k)
          if (k < kc) yr[k] = acc[g][k] + ws[(k * E + (fb & (E - 1))) * kQ + fb / E];
      }
    }
  }
}

struct Args {
  const void* x;
  const float* w;
  float* y;
  int t_len, n, cols;
  long long w_batch_stride;
  int log_group, seg, threads, blocks_per_b, passes, smem;
  long long grid;
  cudaStream_t stream;
};

template <typename T, int KC, int RG>
int launch(const Args& a) {
  auto kernel = readout_apply_kernel<T, KC, RG>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(a.grid), a.threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.x), a.w, a.y, a.t_len, a.n, a.cols, a.w_batch_stride,
      a.log_group, a.seg, a.blocks_per_b, a.passes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC>
int launch_rows(int row_groups, const Args& a) {
  switch (row_groups) {
    case 1: return launch<T, KC, 1>(a);
    case 2: return launch<T, KC, 2>(a);
    case 4: return launch<T, KC, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_cols(int col_block, int row_groups, const Args& a) {
  if (col_block == 1) return launch_rows<T, 1>(row_groups, a);
  if (col_block == 4) return launch_rows<T, 4>(row_groups, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory a block takes: w's slice and x's chunks (the plan's smem_bytes).
extern "C" int readout_apply_smem_bytes(int x_bf16, int seg, int rows, int col_block) {
  return 4 * ws_floats(col_block, x_bf16 ? 8 : 4, seg) + rows * seg * 16;
}

// x [B, T, N] (x_bf16 = 0: f32, 1: bf16), w [B or 1, N + 1, C] f32 with
// batch stride w_batch_stride floats (0 broadcasts one readout), y [B, T, C]
// f32; all row-major and contiguous.  The plan (apply_plan in ops.py): lanes
// a row 2^log_group, `threads` a block (128 or 256), row groups a block
// `row_groups` (1, 2 or 4: a block takes row_groups * threads / 2^log_group
// rows of one instance), chunks a row a pass `seg`, target columns a sweep
// `col_block` (1 or 4), blocks an instance, grid = B * blocks_per_b, passes
// over a row, shared memory a block `smem_bytes`.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int readout_apply_launch(const void* x, int x_bf16, const float* w, float* y,
                                    int batch, int t_len, int n, int cols,
                                    long long w_batch_stride, int log_group, int seg,
                                    int row_groups, int col_block, int threads,
                                    int blocks_per_b, long long grid, int passes, int smem_bytes,
                                    void* stream) {
  const int elems = x_bf16 ? 8 : 4;
  const int rows = row_groups * (threads >> log_group);
  if (batch < 1 || t_len < 1 || n < 0 || cols < 1 || log_group < 2 || log_group > 5 ||
      (threads != 128 && threads != 256) || seg < (1 << log_group) || passes < 1 ||
      static_cast<long long>(passes) * seg < n / elems || blocks_per_b < 1 ||
      static_cast<long long>(blocks_per_b) * rows < t_len ||
      grid != static_cast<long long>(batch) * blocks_per_b || grid > INT_MAX ||
      smem_bytes != readout_apply_smem_bytes(x_bf16, seg, rows, col_block))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,         w,     y,         t_len,      n,      cols,       w_batch_stride,
               log_group, seg,   threads,   blocks_per_b, passes, smem_bytes, grid,
               static_cast<cudaStream_t>(stream)};
  if (x_bf16) return launch_cols<__nv_bfloat16>(col_block, row_groups, a);
  return launch_cols<float>(col_block, row_groups, a);
}
