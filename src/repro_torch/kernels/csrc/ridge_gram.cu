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
// What bounds it on this card: operations.  G is symmetric, so the function
// needs F(F+1)/2 dot products of length T per instance, plus the F*C of c:
// B*T*F*(F+1) + 2*B*T*F*C FLOP (4.9e10 at the main path's B = 64, T = 940,
// F = 901, C = 1), 0.73 ms at the ~67 TFLOP/s f32 rate outside the tensor
// cores, against 0.43 GB of traffic (X read once, G written once: 0.13 ms
// at 3.35 TB/s).  Tensor cores are ruled out: TF32 keeps ~3 decimal
// digits, and the Gram squares cond(X), which the f32 eigh solve of the
// readout was calibrated against; a split over several tensor-core
// products would also break the exactness contract below.
//
// Exactness contract: each element of G and c is ONE IEEE f32 fmaf chain
// over t in ascending order, starting from 0 (one-shot) or from G0 / c0
// (accumulate-into).  No split over T across blocks, no atomics, and rows
// past T are never folded in.  So folding a stream chunk by chunk is
// bitwise equal to one pass over it, for any chunk split, and the result
// does not depend on the tiling below.
//
// Design:
//   * upper-triangle grid: one block per 64 x 64 tile pair I <= J of G
//     (blockIdx.x walks the pairs, blockIdx.y the instance).  An
//     off-diagonal block writes its tile and, through shared memory so
//     that both stores are coalesced, the transpose (fmaf(a, b, acc) and
//     fmaf(b, a, acc) are the same operation).  A diagonal block stages
//     its one column strip once for both operands;
//   * accumulate-into for any G0: an off-diagonal block reads G0[I, J] and
//     G0[J, I] together; if every element equals its mirror bitwise
//     (__syncthreads_or of the mismatches) one chain per pair serves both
//     tiles, else the block runs the chains of tile (J, I) as a second
//     pass.  Every G0 the pipeline hands in is a Gram made by this kernel
//     (or one scaled elementwise), hence symmetric;
//   * register blocking: 8 x 8 outputs a thread (two 4-wide groups 32
//     apart each way, 64 threads a block), fragments read as float4 from
//     shared memory without bank conflicts: 64 fmaf for 16 floats read.
//     Where the triangle grid gives fewer than 4 blocks an SM (the WDM
//     Gram at F = 101, the shared readout's one instance) the tile is
//     spread over 256 threads of 4 x 4;
//   * X rows of F = 901 floats start at every alignment, and TMA needs
//     16-byte row strides, so a ring of kStages stages in dynamic shared
//     memory holds each strip row of kRows rows as the aligned 16-byte
//     window around it, filled with 16-byte cp.async two steps ahead of
//     its use.  A warp a row of X then shifts both strips out of their
//     windows into the f32 compute slot (a bf16 X is copied raw and
//     widened there).  Copying 4 bytes an element straight into the
//     compute layout instead cost as much time as the fmaf themselves.
//     Chunks past the ragged T and F edges are not read, and X is never
//     padded;
//   * c = X^T Y in blocks of its own, one row of F/64 of them per
//     instance after the tile pairs: one fmaf chain per element in
//     ascending t, so no Gram block waits on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;                 // output tile edge, features a moment block
constexpr int kRows = 16;                 // rows of X a stage holds
constexpr int kStages = 3;                // window ring depth
constexpr int kSlot = kRows * 2 * kTile;  // floats of a compute slot: I strip | J strip
constexpr int kPitch = kTile + 1;         // epilogue tile pitch (no bank conflicts)

// A window stage holds each strip row as the 16-byte-aligned window around
// it: kTile / EPC whole chunks of 16 bytes (EPC elements of X each) and the
// one it straddles into.
template <typename XT>
struct Ring {
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(XT));
  static constexpr int kWhole = kTile / kEpc;
  static constexpr int kRowBytes = (kWhole + 1) * 16;
  static constexpr int kStageBytes = 2 * kRows * kRowBytes;
  static constexpr int kSlotOffset = kStages * kStageBytes;  // then the compute slot
  static constexpr int kMainBytes = kSlotOffset + kSlot * static_cast<int>(sizeof(float));
  static constexpr int kTileBytes = kTile * kPitch * static_cast<int>(sizeof(float));
  static constexpr size_t kBytes = kMainBytes > 2 * kTileBytes ? kMainBytes : 2 * kTileBytes;
};

template <int M>
struct Shape {
  static constexpr int kTd = kTile / M;  // threads along each tile edge
  static constexpr int kThreads = kTd * kTd;
  static constexpr int kGroup = 4 * kTd;  // distance between a thread's 4-wide groups
  static constexpr int kMinBlocks = M == 4 ? 2 : 6;
  static_assert(M == 4 || M == 8, "8 x 8 or 4 x 4 outputs a thread");
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Offset of X[t, f0] within its 16-byte chunk, in elements, for f0 a
// multiple of kTile (the same for both strips of row t).
template <typename XT>
__device__ __forceinline__ int row_shift(const XT* xb, int t, int F) {
  const auto base = static_cast<unsigned>(reinterpret_cast<size_t>(xb) / sizeof(XT));
  return static_cast<int>((base + static_cast<unsigned>(t) * static_cast<unsigned>(F)) &
                          (Ring<XT>::kEpc - 1));
}

// Issue the 16-byte copies of window stage `stage`: rows [t0, t0 + kRows)
// of X's columns [i0, i0 + kTile) (and, off the diagonal, [j0, j0 +
// kTile)).  Chunks past T or past the row's last column are zero-filled,
// not read.
template <typename XT, int NT>
__device__ __forceinline__ void load_stage(const XT* xb, unsigned char* stage, int t0, int T,
                                           int F, int i0, int j0, bool two) {
  using R = Ring<XT>;
  constexpr int kRowsPass = NT / R::kWhole;
  const int tid = threadIdx.x;
  const int ch = tid % R::kWhole;
#pragma unroll
  for (int op = 0; op < 2; ++op) {
    if (op == 1 && !two) break;
    const int f0 = op ? j0 : i0;
    const int nvalid = min(kTile, F - f0);
#pragma unroll
    for (int pass = 0; pass < (kRows + kRowsPass - 1) / kRowsPass; ++pass) {
      const int r = pass * kRowsPass + tid / R::kWhole;
      if (kRows % kRowsPass != 0 && r >= kRows) break;
      const int t = t0 + r;
      const int sh = row_shift(xb, t, F);
      cp_async16(stage + (op * kRows + r) * R::kRowBytes + ch * 16,
                 xb + static_cast<size_t>(t) * F + f0 - sh + ch * R::kEpc,
                 t < T && ch * R::kEpc - sh < nvalid);
    }
  }
  if (tid < (two ? 2 : 1) * kRows) {  // the straddled chunk of each strip row
    const int t = t0 + tid % kRows;
    const int f0 = tid < kRows ? i0 : j0;
    const int sh = row_shift(xb, t, F);
    cp_async16(stage + tid * R::kRowBytes + R::kWhole * 16,
               xb + static_cast<size_t>(t) * F + f0 - sh + R::kWhole * R::kEpc,
               t < T && kTile - sh < min(kTile, F - f0));
  }
}

// Shift each strip row of `stage` out of its window into the f32 compute
// slot [kRows][I strip | J strip] (bf16 widened).  One warp a row (both
// strips), two columns a lane: the row's shift is uniform over the warp, so
// an even shift reads both columns in one aligned load.  Nothing is
// masked: window chunks past T or F were zero-filled or hold finite values
// of X that only reach outputs past F, which are never stored.
template <typename XT, int NT>
__device__ __forceinline__ void realign(const XT* xb, const unsigned char* stage, float* slot,
                                        int t0, int F, bool two) {
  using R = Ring<XT>;
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kRows / kWarps; ++k) {
    const int r = k * kWarps + static_cast<int>(threadIdx.x) / 32;
    const int sh = row_shift(xb, t0 + r, F);
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      if (op == 1 && !two) break;
      const XT* w =
          reinterpret_cast<const XT*>(stage + (op * kRows + r) * R::kRowBytes) + sh + 2 * lane;
      float2 v;
      if (sh & 1) {
        v = make_float2(widen(w[0]), widen(w[1]));
      } else if constexpr (sizeof(XT) == 4) {
        v = *reinterpret_cast<const float2*>(w);
      } else {
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
      }
      *reinterpret_cast<float2*>(slot + r * 2 * kTile + op * kTile + 2 * lane) = v;
    }
  }
}

// Row (or column) within the tile of a thread's p-th output row (column).
template <int M>
__device__ __forceinline__ int frag_index(int lane, int p) {
  return (p / 4) * Shape<M>::kGroup + lane * 4 + p % 4;
}

// acc[p][q] += x[t, row p] * x[t, col q] for the first `rows` rows of a slot.
template <int M>
__device__ __forceinline__ void fma_rows(const float* slot, int b_off, int ty, int tx, int rows,
                                         float (&acc)[M][M]) {
  auto step = [&](int r) {
    const float* row = slot + r * 2 * kTile;
    float a[M];
    float v[M];
#pragma unroll
    for (int g = 0; g < M / 4; ++g) {
      const float4 av = *reinterpret_cast<const float4*>(row + frag_index<M>(ty, 4 * g));
      const float4 bv = *reinterpret_cast<const float4*>(row + b_off + frag_index<M>(tx, 4 * g));
      a[4 * g] = av.x;
      a[4 * g + 1] = av.y;
      a[4 * g + 2] = av.z;
      a[4 * g + 3] = av.w;
      v[4 * g] = bv.x;
      v[4 * g + 1] = bv.y;
      v[4 * g + 2] = bv.z;
      v[4 * g + 3] = bv.w;
    }
#pragma unroll
    for (int p = 0; p < M; ++p) {
#pragma unroll
      for (int q = 0; q < M; ++q) acc[p][q] = fmaf(a[p], v[q], acc[p][q]);
    }
  };
  if (rows == kRows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) step(r);
  } else {
    for (int r = 0; r < rows; ++r) step(r);
  }
}

// c[f0 + 64 features, :] = c0 + X^T Y: one fmaf chain per element, ascending t.
template <typename XT, int NT, bool HAS_INIT>
__device__ __forceinline__ void moment_block(const XT* xb, const float* yb, float* cb, int T,
                                             int F, int C, int f0) {
  for (int e = threadIdx.x; e < kTile * C; e += NT) {
    const int f = f0 + e % kTile;
    const int col = e / kTile;
    if (f >= F) continue;
    const XT* xp = xb + f;
    const float* yp = yb + col;
    float s = HAS_INIT ? cb[static_cast<size_t>(f) * C + col] : 0.0f;
    int t = 0;
    for (; t + 8 <= T; t += 8) {
      float xv[8];
      float yv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        xv[u] = widen(xp[static_cast<size_t>(t + u) * F]);
        yv[u] = yp[static_cast<size_t>(t + u) * C];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) s = fmaf(xv[u], yv[u], s);
    }
    for (; t < T; ++t)
      s = fmaf(widen(xp[static_cast<size_t>(t) * F]), yp[static_cast<size_t>(t) * C], s);
    cb[static_cast<size_t>(f) * C + col] = s;
  }
}

// One tile of G: rows [r0, r0 + kTile), columns [q0, q0 + kTile), from
// G0 (accumulate-into) or 0, and, if `mirror` (an off-diagonal tile) and
// G0 equals its transpose there bitwise, the mirror tile too.  Returns
// whether it wrote the mirror.
template <typename XT, int M, bool HAS_INIT>
__device__ __forceinline__ bool gram_tile(const XT* xb, float* gb, int T, int F, int r0, int q0,
                                          bool mirror, float* smem) {
  using S = Shape<M>;
  using R = Ring<XT>;
  constexpr int NT = S::kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % S::kTd;
  const int ty = tid / S::kTd;
  float* tile = smem;                    // [kTile][kPitch], outside the main loop
  float* tile_t = smem + kTile * kPitch;  // the same, for G0's mirror tile
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  float* slot = reinterpret_cast<float*>(ring + R::kSlotOffset);
  float acc[M][M];
  if constexpr (HAS_INIT) {
    // G0[r0.., q0..] into `tile` and, while the block may mirror, the
    // mirror tile G0[q0.., r0..] transposed into `tile_t`, read together
#pragma unroll 8
    for (int e = tid; e < kTile * kTile; e += NT) {
      const int a = e / kTile;
      const int bc = e % kTile;
      tile[a * kPitch + bc] =
          (r0 + a < F && q0 + bc < F) ? gb[static_cast<size_t>(r0 + a) * F + q0 + bc] : 0.0f;
      if (mirror)
        tile_t[bc * kPitch + a] =
            (q0 + a < F && r0 + bc < F) ? gb[static_cast<size_t>(q0 + a) * F + r0 + bc] : 0.0f;
    }
    __syncthreads();
    int differs = 0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int at = frag_index<M>(ty, i) * kPitch + frag_index<M>(tx, j);
        acc[i][j] = tile[at];
        if (mirror) differs |= __float_as_uint(acc[i][j]) != __float_as_uint(tile_t[at]);
      }
    }
    if (mirror) {
      mirror = __syncthreads_or(differs) == 0;
    } else {
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) acc[i][j] = 0.0f;
    }
  }

  // main loop: stage k + kStages - 1 is copied while step k shifts
  // stage k into the compute slot and folds it in.  Its window slot held
  // stage k - 1, which every thread has shifted out by the first barrier
  // of step k; the second barrier publishes the compute slot.
  const bool two = r0 != q0;
  const int b_off = two ? kTile : 0;
  const int steps = (T + kRows - 1) / kRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<XT, NT>(xb, ring + s * R::kStageBytes, s * kRows, T, F, r0, q0, two);
    cp_async_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (next < steps)
      load_stage<XT, NT>(xb, ring + (next % kStages) * R::kStageBytes, next * kRows, T, F, r0,
                         q0, two);
    cp_async_commit();
    realign<XT, NT>(xb, ring + (k % kStages) * R::kStageBytes, slot, k * kRows, F, two);
    __syncthreads();
    fma_rows<M>(slot, b_off, ty, tx, min(kRows, T - k * kRows), acc);
  }
  cp_async_wait_all();
  __syncthreads();

  // epilogue: the tile through shared memory, then coalesced row stores
  // of tile (r0, q0) and, if mirrored, of its transpose
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      tile[frag_index<M>(ty, i) * kPitch + frag_index<M>(tx, j)] = acc[i][j];
  }
  __syncthreads();
#pragma unroll 8
  for (int e = tid; e < kTile * kTile; e += NT) {
    const int r = e / kTile;
    const int col = e % kTile;
    if (r0 + r < F && q0 + col < F)
      gb[static_cast<size_t>(r0 + r) * F + q0 + col] = tile[r * kPitch + col];
    if (mirror && q0 + r < F && r0 + col < F)
      gb[static_cast<size_t>(q0 + r) * F + r0 + col] = tile[col * kPitch + r];
  }
  return mirror;
}

template <typename XT, int M, bool HAS_INIT>
__global__ void __launch_bounds__(Shape<M>::kThreads, Shape<M>::kMinBlocks)
gram_kernel(const XT* __restrict__ x, const float* __restrict__ y, float* g, float* c, int T,
            int F, int C, int tiles) {
  constexpr int NT = Shape<M>::kThreads;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.y;
  const XT* xb = x + static_cast<size_t>(b) * T * F;
  float* gb = g + static_cast<size_t>(b) * F * F;
  const int pairs = tiles * (tiles + 1) / 2;
  int p = blockIdx.x;
  if (p >= pairs) {
    moment_block<XT, NT, HAS_INIT>(xb, y + static_cast<size_t>(b) * T * C,
                                   c + static_cast<size_t>(b) * F * C, T, F, C,
                                   (p - pairs) * kTile);
    return;
  }
  int I = 0;
  while (p >= tiles - I) {
    p -= tiles - I;
    ++I;
  }
  const int J = I + p;
  // tile (I, J) and its mirror; with a G0 that is not symmetric there, the
  // chains of tile (J, I) as a second pass
  const bool mirrored = gram_tile<XT, M, HAS_INIT>(xb, gb, T, F, I * kTile, J * kTile, I != J,
                                                   smem);
  if constexpr (HAS_INIT) {
    if (I != J && !mirrored) {
      __syncthreads();  // the first tile's epilogue is done with shared memory
      gram_tile<XT, M, HAS_INIT>(xb, gb, T, F, J * kTile, I * kTile, false, smem);
    }
  }
}

template <typename XT, int M, bool HAS_INIT>
int launch(const void* x, const float* y, float* g, float* c, int B, int T, int F, int C,
           int tiles, cudaStream_t stream) {
  constexpr size_t smem = Ring<XT>::kBytes;
  static_assert(smem <= 48 * 1024, "above 48 KB the launch needs cudaFuncSetAttribute");
  const dim3 grid(tiles * (tiles + 1) / 2 + tiles, B);
  gram_kernel<XT, M, HAS_INIT><<<grid, Shape<M>::kThreads, smem, stream>>>(
      static_cast<const XT*>(x), y, g, c, T, F, C, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, bool HAS_INIT>
int launch_tiled(const void* x, const float* y, float* g, float* c, int B, int T, int F, int C,
                 cudaStream_t stream) {
  const int tiles = (F + kTile - 1) / kTile;
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 8 x 8 outputs a thread where the triangle grid gives every SM 4
  // blocks, else 4 x 4 over 256 threads: 4x the threads a tile.  Both give
  // the same G bitwise (the chains do not depend on the tiling).
  if (static_cast<long long>(tiles) * (tiles + 1) / 2 * B >= 4LL * sms)
    return launch<XT, 8, HAS_INIT>(x, y, g, c, B, T, F, C, tiles, stream);
  return launch<XT, 4, HAS_INIT>(x, y, g, c, B, T, F, C, tiles, stream);
}

}  // namespace

// x [B, T, F] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); y [B, T, C] f32;
// g [B, F, F] and c [B, F, C] f32.  has_init = 1 reads the running stacks
// from g and c and adds onto them in place; has_init = 0 overwrites them.
// 1 <= C <= 128 and B <= 65535 (checked by the wrapper).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ridge_gram_launch(const void* x, int x_bf16, const void* y, void* g, void* c,
                                 int has_init, int B, int T, int F, int C, void* stream) {
  const auto* yf = static_cast<const float*>(y);
  auto* gf = static_cast<float*>(g);
  auto* cf = static_cast<float*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return has_init ? launch_tiled<__nv_bfloat16, true>(x, yf, gf, cf, B, T, F, C, s)
                    : launch_tiled<__nv_bfloat16, false>(x, yf, gf, cf, B, T, F, C, s);
  }
  return has_init ? launch_tiled<float, true>(x, yf, gf, cf, B, T, F, C, s)
                  : launch_tiled<float, false>(x, yf, gf, cf, B, T, F, C, s);
}

// The dynamic shared memory a block of the kernel takes for an f32 (x_bf16
// = 0) or bf16 X, so that the wrapper's plan (ops.gram_plan) can be held
// to the kernel's own constant.
extern "C" int ridge_gram_smem_bytes(int x_bf16) {
  return static_cast<int>(x_bf16 ? Ring<__nv_bfloat16>::kBytes : Ring<float>::kBytes);
}
