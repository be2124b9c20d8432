// Tiled 2-D copy through dynamic shared memory, Hopper (sm_90a).
//
// Replaces the fixture of the JAX contract checker's VmemBudget tests,
// `_copy_kernel_program` (tests/test_analysis.py:251, its pallas_call at
// :261): a Pallas kernel that copies a 2-D array one block at a time, with
// the block shape given.  It is the subject of the port checker's
// SmemBudget tests, and is simple on purpose.
//
//     out[r, c] = x[r, c]      x, out [rows, cols], any element width
//
// One thread block copies one tile of tile_r x tile_c elements: it stages
// the tile in dynamic shared memory (tile_r * tile_c * itemsize bytes, the
// plan the wrapper holds to the card's 227 KB a block before it launches)
// and writes it back out.  Consecutive threads take consecutive columns,
// so both the reads and the writes of a tile row are coalesced.  Elements
// move as raw bits of their width (1, 2, 4 or 8 bytes), so the copy is
// exact for every dtype.  Tiles at the ragged right and bottom edges copy
// only what lies inside the array.
//
// What bounds it: bytes.  Every element is read once and written once.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_copy_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int cols,
                      int tile_r, int tile_c, int tiles_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int r0 = static_cast<int>(blockIdx.x / tiles_c) * tile_r;
  const int c0 = static_cast<int>(blockIdx.x % tiles_c) * tile_c;
  const int h = min(tile_r, rows - r0);
  const int w = min(tile_c, cols - c0);
  const int n = h * w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / w;
    tile[i] = x[static_cast<size_t>(r0 + r) * cols + c0 + (i - r * w)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / w;
    out[static_cast<size_t>(r0 + r) * cols + c0 + (i - r * w)] = tile[i];
  }
}

template <typename T>
int launch(const void* x, void* out, int rows, int cols, int tile_r, int tile_c, int smem,
           cudaStream_t stream) {
  const long long tiles_r = (rows + tile_r - 1) / tile_r;
  const int tiles_c = (cols + tile_c - 1) / tile_c;
  const long long blocks = tiles_r * tiles_c;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = block_copy_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, cols, tile_r, tile_c, tiles_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out [rows, cols], row-major and contiguous, elements of elem_bytes
// (1, 2, 4 or 8); tiles of tile_r x tile_c; smem_bytes = tile_r * tile_c *
// elem_bytes (checked against the card's limit by the wrapper).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int block_copy_launch(const void* x, void* out, int elem_bytes, int rows, int cols,
                                 int tile_r, int tile_c, int smem_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(x, out, rows, cols, tile_r, tile_c, smem_bytes, s);
    case 2: return launch<uint16_t>(x, out, rows, cols, tile_r, tile_c, smem_bytes, s);
    case 4: return launch<uint32_t>(x, out, rows, cols, tile_r, tile_c, smem_bytes, s);
    case 8: return launch<uint64_t>(x, out, rows, cols, tile_r, tile_c, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
