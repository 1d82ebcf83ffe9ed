// Row-wise ascending bitonic sort for Hopper (sm_90a), float32 or int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitonic_sort.py::
// bitonic_sort_pallas (body _bitonic_kernel, stage _compare_exchange): the
// same network on every row of a contiguous (rows, n) array, n a power of
// 2.  For k = 2, 4, ..., n and j = k/2, ..., 1, element i meets its partner
// i ^ j, and the pair is put in ascending order where (i & k) == 0 and in
// descending order elsewhere.  i is the element's index within its ROW: a
// tile's index within the row decides the direction of the stages with
// k >= tile, so an index within the tile would build another network.
//
// What bounds it on an H100: bytes.  A sort reads each element and writes
// it once at least, 2 * rows * n * 4 bytes over 3.35 TB/s (0.16 ms for
// 2^26 fp32); the n log2 n comparisons any comparison sort makes take a
// sixth of that at the fp32 rate (67 TFLOP/s).  The TPU kernel keeps a block of whole
// rows in VMEM (tens of MB) and runs all log2(n) (log2(n) + 1) / 2 stages
// there, so it touches HBM once.  A GPU block has at most 227 KB of shared
// memory and a row here reaches 2^26 elements (256 MiB), so this kernel
// takes the classic split instead:
//   (a) sort_tiles: one block per tile of T = 4096 elements (16 KiB of
//       static shared memory) runs every stage with k <= T;
//   (b) merge_global: for each k > T, one launch for each j >= T, one
//       thread per pair, in device memory;
//   (c) merge_tiles: for that k, one launch finishes the stages j < T of
//       every tile in shared memory.
// A 2^26 row takes 1 + 105 + 14 = 120 launches, each reading and writing
// the whole array: some 120 passes where the bound counts one.  That is
// this first kernel's price; fewer passes (several stages per pass held in
// registers, larger tiles in dynamic shared memory) are later work.
//
// Min and max are taken by comparison (b < a ? b : a), as the TPU kernel's
// jnp.minimum / jnp.maximum give on finite values; fminf/fmaxf have another
// rule for NaN.  Row and tile counts share one flattened grid, indexed in
// 64 bits (rows * n reaches 2^26 and more; gridDim.y stops at 65535).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

enum DtypeCode { kF32 = 0, kI32 = 1 };

constexpr int kTile = 4096;          // elements a block sorts in shared memory
constexpr int kTileThreads = 1024;   // threads of a tile block (2 pairs each)
constexpr int kPairThreads = 256;    // threads of a merge_global block
constexpr long long kMaxBlocks = 1LL << 20;  // grid cap; blocks stride on

// Order the pair (a at the lower index, b at the upper one): ascending
// keeps the smaller value at the lower index.
template <typename T>
__device__ __forceinline__ void order(T& a, T& b, bool ascending) {
  const T lo = b < a ? b : a;
  const T hi = b < a ? a : b;
  a = ascending ? lo : hi;
  b = ascending ? hi : lo;
}

// One stage (k, j) on a tile of ``tile`` elements in shared memory whose
// first element has index ``row_off`` within its row; ends synchronised.
template <typename T>
__device__ __forceinline__ void tile_stage(T* s, int tile, long long row_off,
                                           long long k, int j) {
  for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
    const int p = 2 * q - (q & (j - 1));  // lower element of pair q
    order(s[p], s[p + j], ((row_off + p) & k) == 0);
  }
  __syncthreads();
}

// (a) every stage with k <= tile, reading ``in`` and writing ``out``.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    sort_tiles(const T* __restrict__ in, T* __restrict__ out, long long n,
               int tile, long long tiles) {
  __shared__ T s[kTile];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * tile;
    const long long row_off = base & (n - 1);
    for (int e = threadIdx.x; e < tile; e += blockDim.x) s[e] = in[base + e];
    __syncthreads();
    for (int k = 2; k <= tile; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) tile_stage(s, tile, row_off, k, j);
    for (int e = threadIdx.x; e < tile; e += blockDim.x) out[base + e] = s[e];
    __syncthreads();  // s is refilled for this block's next tile
  }
}

// (b) one stage (k, j) with j >= tile over the whole array, in place.
template <typename T>
__global__ void __launch_bounds__(kPairThreads)
    merge_global(T* __restrict__ x, long long n, long long pairs, long long k,
                 long long j) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < pairs; q += stride) {
    const long long p = 2 * q - (q & (j - 1));  // a block of 2j never
    T a = x[p];                                 // straddles two rows
    T b = x[p + j];
    order(a, b, ((p & (n - 1)) & k) == 0);
    x[p] = a;
    x[p + j] = b;
  }
}

// (c) the stages j = tile/2, ..., 1 of one k > tile, in place.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    merge_tiles(T* __restrict__ x, long long n, int tile, long long tiles,
                long long k) {
  __shared__ T s[kTile];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * tile;
    const long long row_off = base & (n - 1);
    for (int e = threadIdx.x; e < tile; e += blockDim.x) s[e] = x[base + e];
    __syncthreads();
    for (int j = tile >> 1; j > 0; j >>= 1) tile_stage(s, tile, row_off, k, j);
    for (int e = threadIdx.x; e < tile; e += blockDim.x) x[base + e] = s[e];
    __syncthreads();
  }
}

unsigned capped_blocks(long long blocks) {
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
cudaError_t sort_rows(const T* in, T* out, long long rows, long long n,
                      cudaStream_t stream, int* launches) {
  const int tile = n < kTile ? static_cast<int>(n) : kTile;
  const long long tiles = rows * (n / tile);
  const int threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  const unsigned tile_blocks = capped_blocks(tiles);
  const long long pairs = rows * n / 2;
  const unsigned pair_blocks =
      capped_blocks((pairs + kPairThreads - 1) / kPairThreads);
  int count = 1;
  sort_tiles<T><<<tile_blocks, threads, 0, stream>>>(in, out, n, tile, tiles);
  cudaError_t err = cudaGetLastError();
  for (long long k = 2LL * tile; err == cudaSuccess && k <= n; k <<= 1) {
    for (long long j = k >> 1; err == cudaSuccess && j >= tile; j >>= 1) {
      merge_global<T><<<pair_blocks, kPairThreads, 0, stream>>>(out, n, pairs,
                                                                k, j);
      ++count;
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) break;
    merge_tiles<T><<<tile_blocks, threads, 0, stream>>>(out, n, tile, tiles, k);
    ++count;
    err = cudaGetLastError();
  }
  *launches = count;
  return err;
}

}  // namespace

// Plain C interface for ctypes.  Sorts each row of the contiguous (rows, n)
// array ``in`` into ``out`` (n a power of 2, at least 2; the caller checks);
// ``in`` is only read.  Writes the number of kernel launches to
// ``launches`` and returns cudaGetLastError() after the last one; the
// caller raises on anything but 0.  Launches on ``stream`` and does not
// synchronise.
extern "C" int repro_bitonic_sort(const void* in, void* out, int dtype,
                                  long long rows, long long n, void* stream,
                                  int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kI32)
    return static_cast<int>(sort_rows<int>(static_cast<const int*>(in),
                                           static_cast<int*>(out), rows, n, s,
                                           launches));
  return static_cast<int>(sort_rows<float>(static_cast<const float*>(in),
                                           static_cast<float*>(out), rows, n,
                                           s, launches));
}
