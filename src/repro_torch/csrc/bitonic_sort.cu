// Row-wise ascending bitonic sort for Hopper (sm_90a), float32 or int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitonic_sort.py::
// bitonic_sort_pallas (body _bitonic_kernel, stage _compare_exchange): the
// same network on every row of a contiguous (rows, n) array, n a power of
// 2.  For k = 2, 4, ..., n and j = k/2, ..., 1, element i meets its partner
// i ^ j, and the pair is put in ascending order where (i & k) == 0 and in
// descending order elsewhere.  i is the element's index within its ROW.
// The stages run in the network's order; only their grouping into passes
// and where each element sits during a stage are this kernel's own, so the
// output is the plain version's (kernels/ref.py::bitonic_sort_ref) bit for
// bit on any input, NaN, -0.0 and inf included.
//
// What bounds it on an H100: bytes.  A sort reads each element and writes
// it once at least, 2 * rows * n * 4 bytes over 3.35 TB/s (0.16 ms for
// 2^26 fp32); the n log2 n comparisons any comparison sort makes take a
// sixth of that at the fp32 rate (67 TFLOP/s).  The TPU kernel keeps a
// block of whole rows in VMEM (tens of MB) and runs all log2(n) (log2(n) +
// 1) / 2 stages there.  A GPU block has at most 227 KB of shared memory and
// a row here reaches 2^26 elements (256 MiB), so the stages are split into
// passes over device memory, and the design is about having few of them:
//   (a) Block passes.  A block holds a tile of T = 2^14 elements in
//       dynamic shared memory (66 KiB with its padding; T / n whole rows
//       where n < T), and each of its 512 threads holds E = 32 of them in
//       registers.  A run of stages whose j bits lie in the thread's
//       window of log2(E) = 5 index bits [lo, lo + 4] goes on in registers
//       with no barrier; between runs one exchange through shared memory
//       (store, barrier, load) lays the tile out for the next window.
//       first_block_pass runs every stage with k <= min(n, T): all k <= 32
//       in one window, then ceil(log2(k) / 5) windows a k, 23 for a full
//       tile; for each k > T, finish_block_pass runs the stages j < T in
//       3 windows (bits 13-9, 8-4, 3-0).  A tile moves between device and
//       shared memory in 16-byte loads and stores.
//   (b) global_pass: for k > T, the stages j >= T go in groups of up to
//       m = 6 consecutive stages (j, j/2, ..., j/32), one launch a group;
//       a thread loads the 64 elements p + i * 2^lo (window [lo, lo + 5],
//       lo = log2(j) - 5) into registers, runs the group, writes them
//       back.  Consecutive threads take consecutive p: every access
//       coalesces.  The last group of a k is the shorter one.
// A 2^26 row takes 1 + 18 + 12 = 31 launches (120 before this design: a
// tile of 4096 in static shared memory with a barrier a stage, and one
// launch a stage j >= 4096); each still reads and writes the whole array,
// where the bound counts one pass.  kernels/bitonic_sort.py::passes states
// the same schedule.
//
// Why T = 2^14 and m = 6.  A 2^15 tile (132 KiB) leaves room for one block
// on an SM, whose loads and stores then wait on its own compare-exchanges;
// two 2^14 blocks overlap them (tools/sort_tile_sweep.py on an H100 80GB
// HBM3 at 700 W: 2^26 fp32 in 6.81 ms at T = 2^14, m = 6, against 7.88 ms
// at T = 2^15, m = 5).  A block pass's 512 threads, two blocks to an SM, have
// 64 registers each, which 32 elements and their addressing fill; a
// global pass's 256-thread blocks have no such cap, hold 64 elements (114
// registers, no spill) and so run 6 stages a launch, which keeps 2^26 at
// 31 launches with the smaller tile.
//
// Shared memory is padded, one word after every 32 (element e at word
// e + e / 32): in every window a warp's 32 lanes differ in 5 index bits
// whose words fall in 32 distinct banks, and so do the 16-byte fills, 4
// words a thread: no bank conflict.  Since the pad of a sum of disjoint
// bits is the sum of their pads, a register's word is the thread's word
// plus a constant of the window: one address register a thread.  Min and
// max are taken by comparison (``order``).  Indices are 64 bits (rows * n
// reaches 2^26 and more) and grids are capped, the blocks striding on.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC

#include <cuda_runtime.h>

#include <cstdint>

// The tile and the global group; tools/sort_tile_sweep.py builds others.
#ifndef SORT_LOG_TILE
#define SORT_LOG_TILE 14
#endif
#ifndef SORT_LOG_GROUP
#define SORT_LOG_GROUP 6
#endif

namespace {

enum DtypeCode { kF32 = 0, kI32 = 1 };

constexpr int kLogE = 5;                 // log2 of the elements a thread holds
constexpr int kE = 1 << kLogE;           // 32, one window of 5 index bits
constexpr int kLogTile = SORT_LOG_TILE;  // log2 of a block pass's tile
constexpr int kTile = 1 << kLogTile;     // 2^14: 64 KiB of fp32/int32
constexpr int kBlockThreads = kTile / kE;  // 512
constexpr int kMaxLo = kLogTile - kLogE;  // the highest window's low bit
constexpr int kLogGroup = SORT_LOG_GROUP;  // stages a global pass runs
constexpr int kGlobalThreads = 256;      // threads of a global_pass block
constexpr long long kMaxBlocks = 1LL << 20;  // grid cap; blocks stride on
// What a tile and group build must satisfy (kernels/bitonic_sort.py
// config_ok states the same): a block pass has a warp to 1024 threads;
// a global pass's 2^kLogGroup registers stay at most 64 (no spill); the
// block pass's padded tile fits the 227 KB a block may have.
static_assert(kLogTile >= kLogE + 5 && kLogTile <= kLogE + 10,
              "a block pass has 32 to 1024 threads");
static_assert(kLogGroup >= 1 && kLogGroup <= 6,
              "a global pass holds 2 to 64 elements a thread");
static_assert((kTile + kTile / 32) * 4 <= 232448,
              "a block pass's tile fits a block's shared memory");

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// Order the pair (a at the lower index, b at the upper one): ascending
// keeps the smaller value at the lower index.  Each element takes its value
// by its own comparison with its partner, as in the plain version
// (kernels/ref.py::bitonic_sort_ref): ascending, the lower one
// b < a ? b : a, the upper one a < b ? b : a.  Where one value is less,
// that is the TPU kernel's per-element jnp.minimum / jnp.maximum too;
// where neither is (NaN, -0.0 beside +0.0) both take a in an ascending
// pair and b in a descending one, as in the plain version, bit for bit
// (jnp.minimum would spread a NaN, fminf / fmaxf would drop it).
template <typename T>
__device__ __forceinline__ void order(T& a, T& b, bool ascending) {
  const T lower = (b < a) == ascending ? b : a;
  const T upper = (a < b) == ascending ? b : a;
  a = lower;
  b = upper;
}

// Shared-memory word of tile element e (the padding of the note above).
__host__ __device__ constexpr int pad(int e) { return e + (e >> 5); }

// The stages j = 2^(lo + s), s = s_hi, ..., s_lo, of one k on the 2^kLog
// registers r, where r[i] holds element base + (i << lo) and k's bit lies
// above the window: every pair of the thread goes one way, ``up``.
template <int kLog, typename T>
__device__ __forceinline__ void register_stages(T (&r)[1 << kLog], int s_hi,
                                                int s_lo, bool up) {
#pragma unroll
  for (int s = kLog - 1; s >= 0; --s) {
    if (s > s_hi || s < s_lo) continue;
#pragma unroll
    for (int i = 0; i < (1 << kLog); ++i)
      if (!(i & (1 << s))) order(r[i], r[i | (1 << s)], up);
  }
}

// Every stage of k = 2, ..., min(32, 2^log_k_hi) on the registers of the
// window [0, 4], r[i] holding tile element (t << 5) | i: k's bit is i's
// (k <= 16) or the thread's bit 0 (k = 32); k == n ascends everywhere.
template <typename T>
__device__ __forceinline__ void first_window(T (&r)[kE], int log_k_hi,
                                             long long n, int t) {
#pragma unroll
  for (int kb = 1; kb <= kLogE; ++kb) {
    if (kb > log_k_hi) break;
    const bool all_up = (1LL << kb) == n;
    const bool thread_up = kb < kLogE || !(t & 1);
#pragma unroll
    for (int s = kb - 1; s >= 0; --s) {
#pragma unroll
      for (int i = 0; i < kE; ++i)
        if (!(i & (1 << s)))
          order(r[i], r[i | (1 << s)],
                all_up || (thread_up && !(i & (1 << kb))));
    }
  }
}

// The thread's registers in the window [lo, lo + 4]: register i holds tile
// element tbase | (i << lo), tbase the thread index spread over the other
// bits.
__device__ __forceinline__ int window_base(int t, int lo) {
  return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + kLogE));
}

// Registers <-> shared memory in the window [kLo, kLo + 4]; ``at`` is
// pad(window_base(t, kLo)), each register's word at + pad(i << kLo).
template <typename T, int kLo, bool kStore>
__device__ __forceinline__ void move_window(T* s, T (&r)[kE], int at) {
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    if (kStore)
      s[at + pad(i << kLo)] = r[i];
    else
      r[i] = s[at + pad(i << kLo)];
  }
}

// move_window for a window known only at run time: one compile-time case
// for each lo in [0, kMaxLo], so every register's offset stays a constant.
template <typename T, bool kStore, int kLo = 0>
__device__ __forceinline__ void exchange(T* s, T (&r)[kE], int t, int lo) {
  if constexpr (kLo <= kMaxLo) {
    if (lo == kLo)
      move_window<T, kLo, kStore>(s, r, pad(window_base(t, kLo)));
    else
      exchange<T, kStore, kLo + 1>(s, r, t, lo);
  }
}

// Device memory -> shared memory for the first ``valid`` elements of a tile
// at src.  A full tile of kTile on kBlockThreads threads (16-byte aligned:
// ``vec``) takes 16-byte loads at offsets known to the compiler, all eight
// of a thread issued before its first store; a shorter tile (rows shorter
// than kTile) four 16-byte loads in flight a thread; a misaligned view
// element by element.
template <typename T>
__device__ __forceinline__ void fill_tile(const T* src, T* s, int valid,
                                          bool vec) {
  using V = typename Vec4<T>::type;
  const int t = threadIdx.x;
  if (vec && valid == kTile && blockDim.x == kBlockThreads) {
    const V* v = reinterpret_cast<const V*>(src) + t;
    V x[kE / 4];
#pragma unroll
    for (int u = 0; u < kE / 4; ++u) x[u] = v[u * kBlockThreads];
    T* w = s + pad(4 * t);  // element 4 (t + u kBlockThreads) + c
#pragma unroll
    for (int u = 0; u < kE / 4; ++u) {
      constexpr int kStep = pad(4 * kBlockThreads);
      w[u * kStep] = x[u].x;
      w[u * kStep + 1] = x[u].y;
      w[u * kStep + 2] = x[u].z;
      w[u * kStep + 3] = x[u].w;
    }
    return;
  }
  const int nt = blockDim.x;
  int done = 0;
  if (vec) {
    const V* v = reinterpret_cast<const V*>(src);
    const int quads = valid >> 2;
#pragma unroll 1
    for (int q = t; q < quads; q += nt) {
      const V x = v[q];
      T* w = s + pad(4 * q);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    }
    done = quads << 2;
  }
  for (int e = done + t; e < valid; e += nt) s[pad(e)] = src[e];
}

// Shared memory -> device memory, the reverse of fill_tile.
template <typename T>
__device__ __forceinline__ void drain_tile(const T* s, T* dst, int valid,
                                           bool vec) {
  using V = typename Vec4<T>::type;
  const int t = threadIdx.x;
  if (vec && valid == kTile && blockDim.x == kBlockThreads) {
    V* v = reinterpret_cast<V*>(dst) + t;
    const T* w = s + pad(4 * t);
#pragma unroll
    for (int u = 0; u < kE / 4; ++u) {
      constexpr int kStep = pad(4 * kBlockThreads);
      V x;
      x.x = w[u * kStep];
      x.y = w[u * kStep + 1];
      x.z = w[u * kStep + 2];
      x.w = w[u * kStep + 3];
      v[u * kBlockThreads] = x;
    }
    return;
  }
  const int nt = blockDim.x;
  int done = 0;
  if (vec) {
    V* v = reinterpret_cast<V*>(dst);
    const int quads = valid >> 2;
    for (int q = t; q < quads; q += nt) {
      const T* w = s + pad(4 * q);
      V x;
      x.x = w[0];
      x.y = w[1];
      x.z = w[2];
      x.w = w[3];
      v[q] = x;
    }
    done = quads << 2;
  }
  for (int e = done + t; e < valid; e += nt) dst[e] = s[pad(e)];
}

// (a) Block passes.  first_block_pass runs every stage with
// k <= 2^log_k_hi = min(n, tile) on each tile of 2^log_tile elements, from
// ``in`` to ``out``; its windows move with k (lo from 0 to log_tile - 5).
// blockDim.x is tile / kE.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads, 1024 / kBlockThreads)
    first_block_pass(const T* __restrict__ in, T* __restrict__ out,
                     long long total, long long n, int log_tile, int log_k_hi,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int tile = 1 << log_tile;
  const unsigned tiles = static_cast<unsigned>((total + tile - 1) >> log_tile);
  const int t = threadIdx.x;
  for (unsigned b = blockIdx.x; b < tiles; b += gridDim.x) {
    const long long base = static_cast<long long>(b) << log_tile;
    const int valid = static_cast<int>(
        total - base < tile ? total - base : tile);
    fill_tile(in + base, s, valid, vec);
    __syncthreads();
    T r[kE];
    move_window<T, 0, false>(s, r, pad(window_base(t, 0)));
    first_window(r, log_k_hi, n, t);
    int cur = 0;  // the window the registers hold
    for (int kb = kLogE + 1; kb <= log_k_hi; ++kb) {  // k = 2^kb > 32
      // k's bit of the index within the row (k == n: every pair ascends)
      // is a thread's bit (kt) or, where k == tile < n, the tile's bit 0
      const bool all_up = (1LL << kb) == n;
      const bool tile_up = kb < log_tile || !(b & 1);
      const int kt = kb < log_tile ? 1 << kb : 0;
      for (int h = kb - 1; h >= 0;) {  // the top j bit of the next run
        const int lo = h - (kLogE - 1) > 0 ? h - (kLogE - 1) : 0;
        if (lo != cur) {
          exchange<T, true>(s, r, t, cur);
          __syncthreads();
          exchange<T, false>(s, r, t, lo);
          cur = lo;
        }
        register_stages<kLogE>(
            r, h - lo, 0,
            all_up || (tile_up && (window_base(t, lo) & kt) == 0));
        h = lo - 1;
      }
    }
    exchange<T, true>(s, r, t, cur);
    __syncthreads();
    drain_tile(s, out + base, valid, vec);
    __syncthreads();  // s is refilled for this block's next tile
  }
}

// The windows of a finishing pass, from the top j bit kH down: [kH - 4, kH]
// (or [0, 4] at the bottom), each loaded, run and stored, then a barrier.
template <typename T, int kH>
__device__ __forceinline__ void finish_windows(T* s, T (&r)[kE], int t,
                                               bool up) {
  constexpr int kLo = kH - (kLogE - 1) > 0 ? kH - (kLogE - 1) : 0;
  const int at = pad(window_base(t, kLo));
  move_window<T, kLo, false>(s, r, at);
  register_stages<kLogE>(r, kH - kLo, 0, up);
  move_window<T, kLo, true>(s, r, at);
  __syncthreads();
  if constexpr (kLo > 0) finish_windows<T, kLo - 1>(s, r, t, up);
}

// finish_block_pass: the stages j < kTile of one k > kTile on each tile of
// the array, in place (n > kTile, so tiles are kTile long and every pair of
// a tile has the tile's direction).
template <typename T>
__global__ void __launch_bounds__(kBlockThreads, 1024 / kBlockThreads)
    finish_block_pass(T* __restrict__ x, long long total, long long n,
                      long long k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const unsigned tiles = static_cast<unsigned>(total >> kLogTile);
  const long long kk = k == n ? 0 : k;
  for (unsigned b = blockIdx.x; b < tiles; b += gridDim.x) {
    const long long base = static_cast<long long>(b) << kLogTile;
    fill_tile(x + base, s, kTile, vec);
    __syncthreads();
    T r[kE];
    finish_windows<T, kLogTile - 1>(s, r, threadIdx.x,
                                    (base & (n - 1) & kk) == 0);
    drain_tile(s, x + base, kTile, vec);
    __syncthreads();
  }
}

// (b) ``count`` stages j = 2^top, ..., 2^(top - count + 1) of one k > tile
// over the whole array, in place: each thread's 2^kLogGroup registers hold
// the window [top - kLogGroup + 1, top].
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads)
    global_pass(T* __restrict__ x, long long total, long long n, long long k,
                int top, int count) {
  constexpr int kG = 1 << kLogGroup;
  const int lo = top - (kLogGroup - 1);
  const long long kk = k == n ? 0 : k;
  const long long groups = total >> kLogGroup;
  const long long low = (1LL << lo) - 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < groups; q += stride) {
    const long long p = (q & low) | ((q >> lo) << (lo + kLogGroup));
    T* y = x + p;
    T r[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) r[i] = y[static_cast<long long>(i) << lo];
    register_stages<kLogGroup>(r, kLogGroup - 1, kLogGroup - count,
                               (p & kk) == 0);
#pragma unroll
    for (int i = 0; i < kG; ++i) y[static_cast<long long>(i) << lo] = r[i];
  }
}

unsigned capped_blocks(long long blocks) {
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

int log2_of(long long v) { return 63 - __builtin_clzll(v); }

template <typename T>
cudaError_t sort_rows(const T* in, T* out, long long rows, long long n,
                      cudaStream_t stream, int* launches) {
  *launches = 0;
  const long long total = rows * n;
  // the tile: T elements, or (n < T) T / n whole rows, or all the rows
  // there are (rounded up to a power of 2), and at least one thread's E
  long long tile = kTile;
  if (n < kTile) {
    long long r = 1;
    while (r < rows && r * n < kTile) r <<= 1;
    tile = r * n < kE ? kE : r * n;
  }
  const int log_tile = log2_of(tile);
  const size_t smem = static_cast<size_t>(pad(static_cast<int>(tile))) *
                      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      first_block_pass<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && n > kTile)
    err = cudaFuncSetAttribute(finish_block_pass<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned tile_blocks = capped_blocks((total + tile - 1) / tile);
  const int threads = static_cast<int>(tile / kE);
  const bool out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec = out_vec && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const unsigned group_blocks = capped_blocks(
      ((total >> kLogGroup) + kGlobalThreads - 1) / kGlobalThreads);
  int count = 1;
  first_block_pass<T><<<tile_blocks, threads, smem, stream>>>(
      in, out, total, n, log_tile, log2_of(n < tile ? n : tile), vec);
  err = cudaGetLastError();
  for (long long k = 2 * tile; err == cudaSuccess && k <= n; k <<= 1) {
    for (int top = log2_of(k) - 1; err == cudaSuccess && top >= log_tile;) {
      const int group = top - log_tile + 1 < kLogGroup ? top - log_tile + 1
                                                       : kLogGroup;
      global_pass<T><<<group_blocks, kGlobalThreads, 0, stream>>>(
          out, total, n, k, top, group);
      ++count;
      err = cudaGetLastError();
      top -= group;
    }
    if (err != cudaSuccess) break;
    finish_block_pass<T><<<tile_blocks, threads, smem, stream>>>(
        out, total, n, k, out_vec);
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
// ``launches`` and returns cudaGetLastError() after the last one (or the
// error of setting the block pass's shared memory); the caller raises on
// anything but 0.  Launches on ``stream`` and does not synchronise.
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

// The build's tile and group and its block pass as the runtime has them:
// six ints to ``out``: log2 of the tile, log2 of the global group, the
// dynamic shared memory of a full fp32 tile, threads of a block pass,
// registers a thread of the fp32 first block pass, and its resident blocks
// an SM at that shared memory.  Returns a cudaError_t.
extern "C" int repro_bitonic_sort_info(int* out) {
  const int smem = pad(kTile) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      first_block_pass<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, first_block_pass<float>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, first_block_pass<float>, kBlockThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row[6] = {kLogTile, kLogGroup, smem, kBlockThreads, attr.numRegs,
                      blocks};
  for (int i = 0; i < 6; ++i) out[i] = row[i];
  return 0;
}
