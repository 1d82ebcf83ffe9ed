// Strided, batched matmul with a fused bias + activation + cast epilogue,
// for Hopper (sm_90a).
//
//   C[z1, z2, m, n] = epilogue(sum_k A[z1, z2, m, k] * B[z1, z2, k, n] + bias[n])
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py::matmul_pallas
// (body _matmul_kernel): the same function, epilogue(A @ B + bias) with an
// fp32 accumulator and one cast at the end.  A and B are read through four
// element strides each (two batch levels, rows, columns), so the port's
// projections (2-D, row-major), the unembedding (B is the transposed
// (vocab, d) table), the backward's aᵀ and bᵀ and the two contractions of
// cached attention (batch = slot x kv head, B a strided view of the KV
// cache) all run here without a copy.  C is written contiguous.
//
// Three paths, chosen by the caller from the operands' dtypes alone
// (kernels/matmul.py choose_path), never from M or the batch:
//   * tensor core (bf16 x bf16): matmul_wgmma_kernel.  wgmma.mma_async
//     m64nNk16 (N = 64 or 128) bf16 -> fp32 accumulators in registers, A and
//     B read from shared memory in the 128-byte swizzled layout, K-major or
//     MN-major through the instruction's transpose bits, so row-major
//     weights, table.t(), a.t() and the cache permutes need no copy.  Tiles
//     are 128 x BN x 64 in a ring of shared-memory stages guarded by
//     mbarriers; one producer warp fills them with TMA (cp.async.bulk.
//     tensor, a 4-D tensor map per operand encoded on the host for each
//     call, boxes out of bounds filled with zeros, so ragged M, N, K need
//     no padding and a 4-row decode step fills a 64-row wgmma tile for
//     free), two consumer warpgroups each own 64 rows.  A 96 KB ring (3-4
//     stages) lets two CTAs share an SM, so one's epilogue runs under the
//     other's main loop; CTAs take tiles in groups of 8 row tiles, so those
//     in flight share B in L2.  An operand TMA cannot describe (base not
//     16-byte aligned, a pitch that is not a multiple of 16 bytes, no unit
//     stride) is copied by the producer's threads into the same swizzled
//     layout: the loader differs, the wgmma sequence does not.
//   * split (fp32 x bf16 or bf16 x fp32): matmul_wgmma_split_kernel, the
//     same kernel with the fp32 operand given as two bf16 tensors hi =
//     bf16(x) and lo = bf16(x - hi) (made by the caller); each k step issues
//     the wgmma of hi and then that of lo into the same accumulator (stages
//     of up to 200 KB, one CTA an SM).  A bf16 x bf16 product is exact in
//     fp32, so the only loss is x - hi - lo, below 2^-17 |x|.
//   * FMA (fp32 x fp32): matmul_kernel, the FP32-pipe kernel of the first
//     port, unchanged: each output element is one thread's fmaf chain over
//     k = 0, 1, ..., K-1 (rmsnorm's and the group norm's sums with a column
//     of ones, the fp32 card-vs-CPU and train-parity gates).
//
// The batch-invariance contract: a row's bits do not depend on how many
// rows it is multiplied with.  On the tensor-core paths every output
// element is summed over k in steps of 16, in the order 0, 16, 32, ...;
// each step is one wgmma (on the split path hi, then lo), issued in order
// into one accumulator; the sum inside an instruction is the hardware's.
// There is no split-K and there are no atomics.  The tile width BN is
// picked by the caller from N alone (kernels/matmul.py tile_n), never from
// M, so every row of a given product takes the same instruction sequence
// wherever it sits in its 64-row tile; rows past M are TMA's zeros and
// touch no other row.  The card tests check it bit for bit, per path.
//
// What bounds it on an H100: the training and prefill shapes (thousands of
// rows against 0.5-190 MB weights) are bound by operations, 989 TFLOP/s of
// bf16 tensor cores: wgmma from swizzled shared memory with loads in
// flight behind it is what reaches them.  Decode (M = slots, a few rows)
// moves the whole weight matrix for a handful of rows and is bound by
// bytes, 3.35 TB/s: there what counts is bytes in flight, a ring of B
// tiles per CTA, two CTAs an SM and, for N < 4096, 64-wide tiles for twice
// the CTAs; the 64-row wgmma tile costs no bytes (TMA fills it with
// zeros), and a consumer warpgroup whose 64 rows all lie past M issues no
// wgmma.  Every wgmma sits on a path the compiler can see is uniform (the
// warpgroup index through a shuffle, the barrier's retry loop inside its
// asm): otherwise ptxas serializes them (its C7520 notice).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -Xptxas -v  (no fast-math: expf/tanhf stay
//             accurate).  libcuda's cuTensorMapEncodeTiled is found
//             through the runtime's entry-point query, so nothing links
//             libcuda.

#include "hopper.cuh"

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1 };
enum ActCode { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4 };
enum PathCode { kFma = 0, kTensorCore = 1, kSplit = 2 };

// Element (z1, z2, r, c) lives at ptr + z1*s0 + z2*s1 + r*s2 + c*s3.
struct Operand {
  const void* ptr;
  long long s0, s1, s2, s3;
};

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case kRelu:
      return x > 0.f ? x : 0.f;
    case kGelu: {  // tanh form, as jax.nn.gelu's default (approximate=True)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kSilu:
      return x / (1.f + expf(-x));
    case kTanh:
      return tanhf(x);
    default:
      return x;
  }
}

// ---------------------------------------------------------------------------
// FMA path (fp32 x fp32)
// ---------------------------------------------------------------------------

// One block computes a BM x BN tile of C; each thread a TM x TN micro-tile
// whose rows are strided by BM/TM and columns by BN/TN, so a warp reads
// neighbouring shared-memory words and writes neighbouring columns of C.
template <int BM, int BN, int BK, int TM, int TN, typename TA, typename TB,
          typename TC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    matmul_kernel(Operand a, Operand b, const float* __restrict__ bias,
                  TC* __restrict__ c, int M, int N, int K, int Z2, int act) {
  constexpr int RT = BM / TM;  // thread rows
  constexpr int CT = BN / TN;  // thread columns
  constexpr int THREADS = RT * CT;
  // +1 padding: the transposing stores below hit distinct banks
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int z1 = blockIdx.z / Z2;
  const int z2 = blockIdx.z % Z2;
  const TA* A = static_cast<const TA*>(a.ptr) + z1 * a.s0 + z2 * a.s1;
  const TB* B = static_cast<const TB*>(b.ptr) + z1 * b.s0 + z2 * b.s1;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tr = tid / CT;
  const int tc = tid % CT;
  // neighbouring threads load along whichever dimension is contiguous
  const bool a_k_fast = a.s3 == 1;
  const bool b_n_fast = b.s3 == 1;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f32(A[gr * a.s2 + gk * a.s3]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = b_n_fast ? e / BN : e % BK;
      const int n = b_n_fast ? e % BN : e / BK;
      const int gk = k0 + kk;
      const int gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? to_f32(B[gk * b.s2 + gn * b.s3]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][tr + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tc + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  TC* C = c + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr + i * RT;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tc + j * CT;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      C[static_cast<long long>(gr) * N + gn] = from_f32<TC>(apply_act(v, act));
    }
  }
}

struct Problem {
  Operand a, b;
  const float* bias;
  void* c;
  int z1, z2, m, n, k, act;
  cudaStream_t stream;
};

template <int BM, int BN, int BK, int TM, int TN, typename TA, typename TB,
          typename TC>
cudaError_t launch(const Problem& p) {
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM, p.z1 * p.z2);
  const dim3 block((BM / TM) * (BN / TN));
  matmul_kernel<BM, BN, BK, TM, TN, TA, TB, TC><<<grid, block, 0, p.stream>>>(
      p.a, p.b, p.bias, static_cast<TC*>(p.c), p.m, p.n, p.k, p.z2, p.act);
  return cudaGetLastError();
}

// Tile shape by the output's shape.  Every shape accumulates in the same
// order, so the choice changes speed, never results.  A block waits for one
// round of global loads per BK step, so a grid of a few blocks is bound by
// that latency: for a few output columns (rmsnorm's sum of squares is a
// product with one column of ones) the tile takes 16 rows, for more blocks,
// and a deep BK, for fewer rounds.
template <typename TA, typename TB, typename TC>
cudaError_t by_shape(const Problem& p) {
  if (p.n <= 16) return launch<16, 16, 256, 1, 1, TA, TB, TC>(p);
  if (p.m <= 16) return launch<16, 16, 64, 2, 1, TA, TB, TC>(p);
  return launch<64, 64, 16, 4, 4, TA, TB, TC>(p);
}

// The FMA path takes fp32 operands only (bf16 operands go to the tensor
// cores), with an fp32 or bf16 result.
cudaError_t fma_path(const Problem& p, int c_dtype) {
  if (c_dtype == kBF16) return by_shape<float, float, __nv_bfloat16>(p);
  return by_shape<float, float, float>(p);
}

// ---------------------------------------------------------------------------
// Tensor-core paths (bf16 x bf16; fp32 x bf16 split into hi + lo)
// ---------------------------------------------------------------------------

constexpr int kBM = 128;  // rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 64;   // k per stage: one 128-byte swizzle row of bf16
constexpr int kConsumers = 256;  // two consumer warpgroups (warps 0-7)
constexpr int kProducers = 32;   // one producer warp (warp 8)
constexpr int kThreads = kConsumers + kProducers;
constexpr int kGroupM = 8;  // row tiles per group of the CTA order
constexpr int kErrNoEncoder = 10000;     // returned when libcuda lacks TMA
constexpr int kErrEncode = 11000;        // + the CUresult of a refused map

// One operand as the tensor-core kernel sees it: its (rows, k) view in
// bf16 (for A rows are m, for B rows are n), element (z1, z2, r, kk) at
// z1*s0 + z2*s1 + r*s_row + kk*s_k, and on the split path its lo half with
// the same strides.  ``tma`` is 1 where a tensor map loads it, 0 where the
// producer's threads copy it.
struct TcOperand {
  const __nv_bfloat16* hi;
  const __nv_bfloat16* lo;
  long long s0, s1, s_row, s_k;
  int rows;
  int tma;
};

struct TcArgs {
  CUtensorMap a_map, a_lo_map, b_map, b_lo_map;
  TcOperand a, b;
  const float* bias;
  void* c;
  int c_bf16, m, n, k, z2, act;
};

// The stage ring: on the tensor-core path at most 96 KB, so that two CTAs
// share an SM and one's epilogue runs under the other's main loop; on the
// split path, whose stages hold two A or two B tiles, up to 200 KB of the
// 227 KB a CTA may use, one CTA an SM.
template <int BN, int SPLIT>
struct TcShape {
  static constexpr int kBudget = SPLIT == 0 ? 96 * 1024 : 200 * 1024;
  static constexpr int kA = kBM * kBK * 2;  // bytes of one A tile
  static constexpr int kB = BN * kBK * 2;   // bytes of one B tile
  static constexpr int kALo = SPLIT == 1 ? kA : 0;
  static constexpr int kBLo = SPLIT == 2 ? kB : 0;
  static constexpr int kStage = kA + kALo + kB + kBLo;
  static constexpr int kStages = kBudget / kStage > 8 ? 8 : kBudget / kStage;
  // + 1024 to align the ring, + a full and an empty barrier per stage
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
};


// The loader for an operand TMA cannot describe: the producer warp's
// threads copy the R x 64 tile element by element (zeros outside the
// operand) into the swizzled layout a tensor map would have written.
template <int T, int R>
__device__ __forceinline__ void copy_tile(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          const TcOperand& op, int row0,
                                          int k0, int K, int lane) {
  for (int e = lane; e < R * kBK; e += kProducers) {
    // neighbouring threads read along the operand's contiguous axis
    const int r = T == 0 ? e / kBK : e % R;
    const int kk = T == 0 ? e % kBK : e / R;
    const int gr = row0 + r;
    const int gk = k0 + kk;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (gr < op.rows && gk < K) v = src[gr * op.s_row + gk * op.s_k];
    *reinterpret_cast<__nv_bfloat16*>(dst + swizzled<T>(r, kk)) = v;
  }
}

// One R x 64 tile by TMA: one box (64 k, R rows) for a K-major operand,
// R / 64 boxes (64 rows, 64 k) for an MN-major one.
template <int T, int R>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int k0,
                                         int z1, int z2) {
  if (T == 0) {
    tma_load_4d(dst, map, bar, k0, row0, z2, z1);
  } else {
#pragma unroll
    for (int j = 0; j < R / 64; ++j)
      tma_load_4d(dst + j * 8192, map, bar, row0 + 64 * j, k0, z2, z1);
  }
}

__device__ __forceinline__ void store_pair(const TcArgs& p, long long at,
                                           int col, float v0, float v1) {
  if (col >= p.n) return;
  const bool two = col + 1 < p.n;
  if (p.bias != nullptr) {
    v0 += p.bias[col];
    if (two) v1 += p.bias[col + 1];
  }
  v0 = apply_act(v0, p.act);
  v1 = two ? apply_act(v1, p.act) : 0.f;
  const bool paired = two && (p.n % 2 == 0);  // then at + col is even
  if (p.c_bf16) {
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.c) + at + col;
    if (paired) {
      *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(v0, v1);
    } else {
      c[0] = __float2bfloat16_rn(v0);
      if (two) c[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* c = static_cast<float*>(p.c) + at + col;
    if (paired) {
      *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
    } else {
      c[0] = v0;
      if (two) c[1] = v1;
    }
  }
}

// One CTA computes a 128 x BN tile of C.  Warp 8 produces: for each
// 64-deep k block it waits for a free stage, fills A (and A lo), B (and B
// lo) by TMA or by copy, and arrives on the stage's full barrier (32
// arrivals, lane 0's carrying the TMA byte count).  Warpgroups 0 and 1
// consume rows 0-63 and 64-127: wait for the stage, issue its four
// k16 steps (split: hi then lo each), commit, and free the previous stage
// once at most this one is in flight (256 arrivals on its empty barrier).
template <int BN, int TA, int TB, int SPLIT>
__device__ __forceinline__ void tc_body(const TcArgs& p) {
  using S = TcShape<BN, SPLIT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kStages * S::kStage);
  uint64_t* empty = full + S::kStages;
  const int tid = threadIdx.x;
  // tiles in groups of kGroupM row tiles, column by column within a
  // group, so that the CTAs in flight share their B tiles in L2 (the
  // order of the tiles changes no result)
  const int tiles_m = (p.m + kBM - 1) / kBM;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int group = blockIdx.x / (kGroupM * tiles_n);
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % (kGroupM * tiles_n);
  const int m0 = (first_m + in_group % group_m) * kBM;
  const int n0 = (in_group / group_m) * BN;
  const int z1 = blockIdx.z / p.z2;
  const int z2 = blockIdx.z % p.z2;
  const int nk = (p.k + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index through a shuffle, so that the compiler knows it
  // is the same across the warp (wgmma must not sit on a divergent path)
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  if (wg == kConsumers / 128) {
    const int lane = tid - kConsumers;
    const long long a_at = z1 * p.a.s0 + z2 * p.a.s1;
    const long long b_at = z1 * p.b.s0 + z2 * p.b.s1;
    const uint32_t tx = (p.a.tma ? S::kA + S::kALo : 0) +
                        (p.b.tma ? S::kB + S::kBLo : 0);
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S::kStages;
      mbar_wait(&empty[s], ((kb / S::kStages) & 1) ^ 1);
      uint8_t* sa = smem + s * S::kStage;
      uint8_t* sa_lo = sa + S::kA;
      uint8_t* sb = sa_lo + S::kALo;
      uint8_t* sb_lo = sb + S::kB;
      const int k0 = kb * kBK;
      if (!p.a.tma) {
        copy_tile<TA, kBM>(sa, p.a.hi + a_at, p.a, m0, k0, p.k, lane);
        if (SPLIT == 1)
          copy_tile<TA, kBM>(sa_lo, p.a.lo + a_at, p.a, m0, k0, p.k, lane);
      }
      if (!p.b.tma) {
        copy_tile<TB, BN>(sb, p.b.hi + b_at, p.b, n0, k0, p.k, lane);
        if (SPLIT == 2)
          copy_tile<TB, BN>(sb_lo, p.b.lo + b_at, p.b, n0, k0, p.k, lane);
      }
      // copies are generic-proxy writes; wgmma reads through the async proxy
      if (!(p.a.tma && p.b.tma))
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], tx);
        if (p.a.tma) {
          tma_tile<TA, kBM>(sa, &p.a_map, &full[s], m0, k0, z1, z2);
          if (SPLIT == 1)
            tma_tile<TA, kBM>(sa_lo, &p.a_lo_map, &full[s], m0, k0, z1, z2);
        }
        if (p.b.tma) {
          tma_tile<TB, BN>(sb, &p.b_map, &full[s], n0, k0, z1, z2);
          if (SPLIT == 2)
            tma_tile<TB, BN>(sb_lo, &p.b_lo_map, &full[s], n0, k0, z1, z2);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int w = wg;  // which 64 rows of the tile
  const int t = tid % 128;
  // rows all past M: no wgmma, but the stages are still waited for and
  // freed in step with the other warpgroup
  const bool active = m0 + 64 * w < p.m;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % S::kStages;
    mbar_wait(&full[s], (kb / S::kStages) & 1);
    if (!active) {
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t st = smem_u32(smem + s * S::kStage);
    const uint32_t a_hi = st + w * 8192;  // row 64w, in either layout
    const uint32_t a_lo = a_hi + S::kA;
    const uint32_t b_hi = st + S::kA + S::kALo;
    const uint32_t b_lo = b_hi + S::kB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = smem_desc<TA>(a_hi, kk);
      const uint64_t db = smem_desc<TB>(b_hi, kk);
      wgmma_ss<BN, TA, TB>(acc, da, db, 1);
      if (SPLIT == 1)
        wgmma_ss<BN, TA, TB>(acc, smem_desc<TA>(a_lo, kk), db, 1);
      if (SPLIT == 2)
        wgmma_ss<BN, TA, TB>(acc, da, smem_desc<TB>(b_lo, kk), 1);
    }
    wgmma_commit();
    if (kb > 0) {
      wgmma_wait<1>();
      mbar_arrive(&empty[(kb - 1) % S::kStages]);
    }
  }
  if (!active) return;
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);

  // accumulator fragment of m64nNk16: thread t holds, for each 8-column
  // block j, rows 16*(t/32) + (t%32)/4 and +8, columns 2*(t%4) and +1
  const int warp = t / 32;
  const int lane = t % 32;
  const int row = m0 + 64 * w + warp * 16 + lane / 4;
  const long long c_at = static_cast<long long>(blockIdx.z) * p.m * p.n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r < p.m)
        store_pair(p, c_at + static_cast<long long>(r) * p.n, col,
                   acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
    }
  }
}

// Two kernel names, so that a profile tells the paths apart.
template <int BN, int TA, int TB>
__global__ void __launch_bounds__(kThreads, 2)
    matmul_wgmma_kernel(__grid_constant__ const TcArgs p) {
  tc_body<BN, TA, TB, 0>(p);
}

template <int BN, int TA, int TB, int SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_wgmma_split_kernel(__grid_constant__ const TcArgs p) {
  tc_body<BN, TA, TB, SPLIT>(p);
}

// A 4-D map (inner, outer, z2, z1) of an operand's (rows, k) view: inner is
// k for a K-major operand (boxes of 64 k x box_rows rows), the rows for an
// MN-major one (boxes of 64 rows x 64 k).  A dimension of extent 1 is
// never stepped along, so it gets a stride TMA accepts whatever the
// tensor's.  Returns 0 or an error code.
int encode(CUtensorMap* map, const __nv_bfloat16* ptr, int mn_major,
           const TcOperand& op, int k, int z1, int z2, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const long long inner = mn_major ? op.rows : k;
  const long long outer = mn_major ? k : op.rows;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner > 0 ? inner : 1),
                        static_cast<cuuint64_t>(outer > 0 ? outer : 1),
                        static_cast<cuuint64_t>(z2),
                        static_cast<cuuint64_t>(z1)};
  const long long elem_strides[3] = {mn_major ? op.s_k : op.s_row, op.s1,
                                     op.s0};
  cuuint64_t strides[3];
  long long prev = static_cast<long long>(dims[0]) * 2;  // bytes
  for (int i = 0; i < 3; ++i) {
    long long s = elem_strides[i] * 2;
    if (dims[i + 1] == 1) s = (prev + 15) / 16 * 16;
    strides[i] = static_cast<cuuint64_t>(s);
    prev = s * static_cast<long long>(dims[i + 1]);
  }
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(mn_major ? 64 : box_rows),
                       1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<__nv_bfloat16*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

// Launches one instantiation; its shared-memory allowance is raised once
// per device (a bit per device ordinal below 64).
template <int BN, int TA, int TB, int SPLIT>
cudaError_t run_tc(const TcArgs& args, int z, cudaStream_t stream) {
  void (*kernel)(TcArgs);
  if constexpr (SPLIT == 0) {
    kernel = matmul_wgmma_kernel<BN, TA, TB>;
  } else {
    kernel = matmul_wgmma_split_kernel<BN, TA, TB, SPLIT>;
  }
  constexpr int smem = TcShape<BN, SPLIT>::kSmem;
  static unsigned long long allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((allowed >> dev) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed |= 1ull << dev;
  }
  const dim3 grid(((args.n + BN - 1) / BN) * ((args.m + kBM - 1) / kBM), 1, z);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int BN, int TA, int TB>
cudaError_t by_split(const TcArgs& args, int split, int z,
                     cudaStream_t stream) {
  if (split == 1) return run_tc<BN, TA, TB, 1>(args, z, stream);
  if (split == 2) return run_tc<BN, TA, TB, 2>(args, z, stream);
  return run_tc<BN, TA, TB, 0>(args, z, stream);
}

template <int BN>
cudaError_t by_layout(const TcArgs& args, int ta, int tb, int split, int z,
                      cudaStream_t stream) {
  if (ta) {
    return tb ? by_split<BN, 1, 1>(args, split, z, stream)
              : by_split<BN, 1, 0>(args, split, z, stream);
  }
  return tb ? by_split<BN, 0, 1>(args, split, z, stream)
            : by_split<BN, 0, 0>(args, split, z, stream);
}

}  // namespace

// Plain C interface for ctypes.  ``path``: 0 FMA (fp32 operands), 1 tensor
// core (bf16 operands), 2 split (the fp32 operand given as bf16 hi in
// ``a``/``b`` and lo in ``a_lo``/``b_lo``, the other lo null).  Strides are
// in elements, four per operand: (batch outer, batch inner, row, column).
// ``a_mode``/``b_mode`` (tensor-core paths): bit 0 set for an MN-major
// operand (unit stride along m for A, along n for B), else K-major; bit 1
// set where a tensor map can load it.  ``tile_n`` (64 or 128) is the
// caller's, picked from N alone.  Returns cudaGetLastError() after the
// launch, or a code of 10000 and above where a tensor map could not be
// made; the caller raises on anything but 0.  Launches on ``stream`` and
// does not synchronise.
extern "C" int repro_matmul(int path, const void* a, const void* a_lo,
                            const long long* a_strides, int a_dtype,
                            int a_mode, const void* b, const void* b_lo,
                            const long long* b_strides, int b_dtype,
                            int b_mode, const float* bias, void* c,
                            int c_dtype, int z1, int z2, int m, int n, int k,
                            int act, int tile_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == kFma) {
    if (a_dtype != kF32 || b_dtype != kF32)
      return static_cast<int>(cudaErrorInvalidValue);
    Problem p;
    p.a = {a, a_strides[0], a_strides[1], a_strides[2], a_strides[3]};
    p.b = {b, b_strides[0], b_strides[1], b_strides[2], b_strides[3]};
    p.bias = bias;
    p.c = c;
    p.z1 = z1;
    p.z2 = z2;
    p.m = m;
    p.n = n;
    p.k = k;
    p.act = act;
    p.stream = st;
    return static_cast<int>(fma_path(p, c_dtype));
  }
  const int split = a_lo != nullptr ? 1 : (b_lo != nullptr ? 2 : 0);
  if (a_dtype != kBF16 || b_dtype != kBF16 || (tile_n != 64 && tile_n != 128) ||
      (path == kTensorCore) != (split == 0) ||
      (a_lo != nullptr && b_lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TcArgs args = {};
  args.a = {static_cast<const __nv_bfloat16*>(a),
            static_cast<const __nv_bfloat16*>(a_lo),
            a_strides[0], a_strides[1], a_strides[2], a_strides[3], m,
            (a_mode >> 1) & 1};
  // B's (rows, k) view: rows are its columns n
  args.b = {static_cast<const __nv_bfloat16*>(b),
            static_cast<const __nv_bfloat16*>(b_lo),
            b_strides[0], b_strides[1], b_strides[3], b_strides[2], n,
            (b_mode >> 1) & 1};
  args.bias = bias;
  args.c = c;
  args.c_bf16 = c_dtype == kBF16;
  args.m = m;
  args.n = n;
  args.k = k;
  args.z2 = z2;
  args.act = act;
  const int ta = a_mode & 1;
  const int tb = b_mode & 1;
  int err = 0;
  if (args.a.tma) {
    err = encode(&args.a_map, args.a.hi, ta, args.a, k, z1, z2, kBM);
    if (!err && split == 1)
      err = encode(&args.a_lo_map, args.a.lo, ta, args.a, k, z1, z2, kBM);
  }
  if (!err && args.b.tma) {
    err = encode(&args.b_map, args.b.hi, tb, args.b, k, z1, z2, tile_n);
    if (!err && split == 2)
      err = encode(&args.b_lo_map, args.b.lo, tb, args.b, k, z1, z2, tile_n);
  }
  if (err) return err;
  const int z = z1 * z2;
  if (tile_n == 128)
    return static_cast<int>(by_layout<128>(args, ta, tb, split, z, st));
  return static_cast<int>(by_layout<64>(args, ta, tb, split, z, st));
}

namespace {

// Shared memory, stages, registers, local bytes and resident CTAs an SM of
// one tensor-core instantiation (K-major operands), as the runtime has it.
template <int BN, int SPLIT>
cudaError_t tc_info(int* out) {
  using S = TcShape<BN, SPLIT>;
  void (*kernel)(TcArgs);
  if constexpr (SPLIT == 0) {
    kernel = matmul_wgmma_kernel<BN, 0, 0>;
  } else {
    kernel = matmul_wgmma_split_kernel<BN, 0, 0, SPLIT>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, S::kSmem);
  if (err != cudaSuccess) return err;
  const int row[5] = {S::kSmem, S::kStages, attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), ctas};
  for (int i = 0; i < 5; ++i) out[i] = row[i];
  return cudaSuccess;
}

}  // namespace

// The tensor-core kernel at tile width ``tile_n`` (64 or 128) on the
// tensor-core path (split 0) or the split path with A split (1): five
// ints to ``out``: dynamic shared memory bytes, stages of the ring,
// registers a thread, local (spill) bytes a thread, resident CTAs an SM.
// Returns a cudaError_t.
extern "C" int repro_matmul_info(int tile_n, int split, int* out) {
  if (tile_n == 128)
    return static_cast<int>(split ? tc_info<128, 1>(out) : tc_info<128, 0>(out));
  if (tile_n == 64)
    return static_cast<int>(split ? tc_info<64, 1>(out) : tc_info<64, 0>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}
