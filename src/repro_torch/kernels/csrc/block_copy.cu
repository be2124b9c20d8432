// Tiled 2-D copy through dynamic shared memory, Hopper (sm_90a).
//
// Replaces the fixture of the JAX contract checker's VmemBudget tests,
// `_copy_kernel_program` (tests/test_analysis.py:251, its pallas_call at
// :261): a Pallas kernel that copies a 2-D array one block at a time, with
// the block shape given.  It is the subject of the port checker's
// SmemBudget tests.
//
//     out[r, c] = x[r, c]      x, out [rows, cols], any element width
//
// One thread block copies one tile of tile_r x tile_c elements: it stages
// the tile in dynamic shared memory (tile_r * tile_c * itemsize bytes, the
// plan the wrapper holds to the card's 227 KB a block before it launches)
// and writes it back out.  Elements move as raw bits of their width, so the
// copy is exact for every dtype.  Tiles at the ragged right and bottom
// edges copy only what lies inside the array.
//
// What bounds it: bytes.  Every element is read once and written once.
// The first version moved 4-byte words through registers, one integer
// division by the tile width an element, with few loads in flight a
// thread, and took 2.6x the time of x.clone().  Two routes now, chosen by
// the wrapper from shapes and pointers before the launch (`copy_route` in
// kernels/block_copy/ops.py); this entry point does not choose, it checks
// the chosen route's conditions and fails the launch if they do not hold:
//
// * TMA (Hopper's tile copy engine): base pointers 16-byte aligned, a row
//   of the array and a row of the tile whole 16-byte units, the tile plus
//   its 8-byte mbarrier within a block's shared memory, and each box's slot
//   in shared memory at a multiple of 128 bytes.  The host encodes
//   a 2-D tensor map for x and one for out (cuTensorMapEncodeTiled, through
//   cudaGetDriverEntryPoint: the library links no libcuda).  One thread a
//   block issues the tile's box loads (a box is at most 256 x 256
//   elements, so a larger tile takes several, each a divisor of the tile),
//   waits on the mbarrier armed with their bytes, issues the box stores and
//   waits until they have read shared memory.  TMA zero-fills the loads and
//   clips the stores at the array's edges; boxes wholly outside it are not
//   issued.  Threads spend no registers on the data; the thread prefetches
//   the two tensor maps first.
// * SIMT (every other tile: the card tests' (37, 101) f32 with an (8, 33)
//   tile, (5, 7) int64, unaligned views, the tile that fills the last
//   bytes): the widest vector (16, 8, 4, 2 or 1 bytes) that divides a row
//   of the array, a row of the tile and both pointers, 2-D indexing with no
//   division an element, and four loads in flight a thread before their
//   stores.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // a SIMT block
constexpr int kInFlight = 4;    // loads a SIMT thread issues before its stores
constexpr int kBarrierBytes = 8;

// ---------------------------------------------------------------------------
// SIMT route
// ---------------------------------------------------------------------------

// Copy h rows of wv vectors V from src (row pitch sp bytes) to dst (pitch
// dp): thread (tx, ty) of a tx_n x ty_n grid takes columns tx, tx + tx_n,
// ... of rows ty, ty + ty_n, ..., kInFlight loads before their stores.
template <typename V>
__device__ __forceinline__ void copy_rows(const unsigned char* __restrict__ src, size_t sp,
                                          unsigned char* __restrict__ dst, size_t dp, int h,
                                          int wv, int tx, int ty, int tx_n, int ty_n) {
  if (tx >= wv) return;
  int r = ty, c = tx;
  while (r < h) {
    V v[kInFlight];
    int rr[kInFlight], cc[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      rr[k] = r;
      cc[k] = c;
      if (r < h) v[k] = *reinterpret_cast<const V*>(src + r * sp + c * sizeof(V));
      c += tx_n;
      if (c >= wv) {
        c = tx;
        r += ty_n;
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (rr[k] < h) *reinterpret_cast<V*>(dst + rr[k] * dp + cc[k] * sizeof(V)) = v[k];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    block_copy_simt(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                    int elem, int rows, int cols, int tile_r, int tile_c, int tiles_c) {
  extern __shared__ __align__(16) unsigned char staged[];
  const int tr = static_cast<int>(blockIdx.x) / tiles_c;      // one division a block
  const int r0 = tr * tile_r;
  const int c0 = (static_cast<int>(blockIdx.x) - tr * tiles_c) * tile_c;
  const int h = min(tile_r, rows - r0);
  const int wv = min(tile_c, cols - c0) * elem / static_cast<int>(sizeof(V));
  // columns of vectors across threads, a power of two up to the block
  int tx_n = 1;
  while (tx_n < wv && tx_n < kThreads) tx_n <<= 1;
  const int tx = threadIdx.x & (tx_n - 1);
  const int ty = threadIdx.x >> (__ffs(tx_n) - 1);
  const int ty_n = kThreads / tx_n;
  const size_t pitch = static_cast<size_t>(cols) * elem;
  const size_t at = static_cast<size_t>(r0) * pitch + static_cast<size_t>(c0) * elem;
  const size_t tile_pitch = static_cast<size_t>(wv) * sizeof(V);
  copy_rows<V>(x + at, pitch, staged, tile_pitch, h, wv, tx, ty, tx_n, ty_n);
  __syncthreads();
  copy_rows<V>(staged, tile_pitch, out + at, pitch, h, wv, tx, ty, tx_n, ty_n);
}

// ---------------------------------------------------------------------------
// TMA route
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
    block_copy_tma(const __grid_constant__ CUtensorMap src, const __grid_constant__ CUtensorMap dst,
                   int rows, int cols, int tile_r, int tile_c, int tiles_c, int box_r,
                   int box_c, int box_bytes, int tile_bytes) {
  extern __shared__ __align__(128) unsigned char tile[];
  if (threadIdx.x != 0) return;
  asm volatile("prefetch.tensormap [%0];" ::"l"(&src) : "memory");
  asm volatile("prefetch.tensormap [%0];" ::"l"(&dst) : "memory");
  const uint32_t base = smem_addr(tile);
  if (base & 127) __trap();                   // a box must start 128-byte aligned
  const uint32_t bar = base + tile_bytes;     // tile_bytes: whole 16-byte units
  const int tr = static_cast<int>(blockIdx.x) / tiles_c;
  const int r0 = tr * tile_r;
  const int c0 = (static_cast<int>(blockIdx.x) - tr * tiles_c) * tile_c;
  // boxes that start inside the array; the rest of the tile lies outside it
  const int n_r = (min(tile_r, rows - r0) + box_r - 1) / box_r;
  const int n_c = (min(tile_c, cols - c0) + box_c - 1) / box_c;
  const int per_row = tile_c / box_c;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(n_r * n_c * box_bytes)
               : "memory");
  for (int i = 0; i < n_r; ++i)
    for (int j = 0; j < n_c; ++j)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3}], [%4];" ::"r"(base + (i * per_row + j) * box_bytes),
          "l"(&src), "r"(c0 + j * box_c), "r"(r0 + i * box_r), "r"(bar)
          : "memory");
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  for (int i = 0; i < n_r; ++i)
    for (int j = 0; j < n_c; ++j)
      asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
                   ::"l"(&dst), "r"(c0 + j * box_c), "r"(r0 + i * box_r),
                   "r"(base + (i * per_row + j) * box_bytes)
                   : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

bool tensor_map(CUtensorMap* map, const void* ptr, int elem, int rows, int cols, int box_r,
                int box_c) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  CUtensorMapDataType type;
  switch (elem) {
    case 1: type = CU_TENSOR_MAP_DATA_TYPE_UINT8; break;
    case 2: type = CU_TENSOR_MAP_DATA_TYPE_UINT16; break;
    case 4: type = CU_TENSOR_MAP_DATA_TYPE_UINT32; break;
    case 8: type = CU_TENSOR_MAP_DATA_TYPE_UINT64; break;
    default: return false;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_r)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int launch_tma(const void* x, void* out, int elem, int rows, int cols, int tile_r, int tile_c,
               int smem, int box_r, int box_c, unsigned blocks, int tiles_c,
               cudaStream_t stream) {
  const long long box_bytes = static_cast<long long>(box_r) * box_c * elem;
  const int boxes = (tile_r / box_r) * (tile_c / box_c);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0 ||
      (static_cast<long long>(cols) * elem) % 16 != 0 ||
      (static_cast<long long>(tile_c) * elem) % 16 != 0 ||
      box_r < 1 || box_c < 1 || box_r > 256 || box_c > 256 || tile_r % box_r != 0 ||
      tile_c % box_c != 0 || (static_cast<long long>(box_c) * elem) % 16 != 0 ||
      (boxes > 1 && box_bytes % 128 != 0) || smem % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap src_map, dst_map;
  if (!tensor_map(&src_map, x, elem, rows, cols, box_r, box_c) ||
      !tensor_map(&dst_map, out, elem, rows, cols, box_r, box_c))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem + kBarrierBytes;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(block_copy_tma), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_copy_tma<<<blocks, 32, bytes, stream>>>(src_map, dst_map, rows, cols, tile_r, tile_c,
                                                tiles_c, box_r, box_c,
                                                static_cast<int>(box_bytes), smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_simt(const void* x, void* out, int elem, int rows, int cols, int tile_r, int tile_c,
                int smem, unsigned blocks, int tiles_c, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % sizeof(V) != 0 ||
      (static_cast<long long>(cols) * elem) % sizeof(V) != 0 ||
      (static_cast<long long>(tile_c) * elem) % sizeof(V) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = block_copy_simt<V>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const unsigned char*>(x),
                                             static_cast<unsigned char*>(out), elem, rows, cols,
                                             tile_r, tile_c, tiles_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out [rows, cols], row-major and contiguous, elements of elem_bytes
// (1, 2, 4 or 8); tiles of tile_r x tile_c; smem_bytes = tile_r * tile_c *
// elem_bytes (the plan, held to the card's limit by the wrapper).  route 1:
// TMA with boxes of box_r x box_c elements; route 0: SIMT with vectors of
// vec_bytes.  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue where the route's conditions do not hold.
extern "C" int block_copy_launch(const void* x, void* out, int elem_bytes, int rows, int cols,
                                 int tile_r, int tile_c, int smem_bytes, int route,
                                 int vec_bytes, int box_r, int box_c, void* stream) {
  if (rows < 1 || cols < 1 || tile_r < 1 || tile_c < 1 ||
      static_cast<long long>(tile_r) * tile_c * elem_bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_r = (rows + static_cast<long long>(tile_r) - 1) / tile_r;
  const long long tiles_c = (cols + static_cast<long long>(tile_c) - 1) / tile_c;
  if (tiles_r * tiles_c > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>(tiles_r * tiles_c);
  const int tc = static_cast<int>(tiles_c);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return launch_tma(x, out, elem_bytes, rows, cols, tile_r, tile_c, smem_bytes, box_r, box_c,
                      blocks, tc, s);
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec_bytes) {
    case 1: return launch_simt<uint8_t>(x, out, elem_bytes, rows, cols, tile_r, tile_c,
                                        smem_bytes, blocks, tc, s);
    case 2: return launch_simt<uint16_t>(x, out, elem_bytes, rows, cols, tile_r, tile_c,
                                         smem_bytes, blocks, tc, s);
    case 4: return launch_simt<uint32_t>(x, out, elem_bytes, rows, cols, tile_r, tile_c,
                                         smem_bytes, blocks, tc, s);
    case 8: return launch_simt<uint2>(x, out, elem_bytes, rows, cols, tile_r, tile_c,
                                      smem_bytes, blocks, tc, s);
    case 16: return launch_simt<uint4>(x, out, elem_bytes, rows, cols, tile_r, tile_c,
                                       smem_bytes, blocks, tc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
