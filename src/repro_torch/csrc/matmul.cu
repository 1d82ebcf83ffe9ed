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
// (vocab, d) table) and the two contractions of cached attention (batch =
// slot x kv head, B a strided view of the KV cache) all run here without a
// copy.  C is written contiguous.
//
// What bounds it on an H100: the serving shapes are decode (M = slots, a few
// rows) and prefill (M = slots x chunk, a few hundred rows) against weight
// matrices of 0.5 to 23 MB.  At decode the function moves the whole weight
// matrix for a handful of rows, so it is bound by device-memory bytes
// (3.35 TB/s), and the kernel's job is to have enough blocks and loads in
// flight: the small-M tile is 16 x 16 so that N = 2048 already gives 128
// blocks.  At prefill it is bound by operations; this first kernel uses the
// FP32 FMA pipe, not the tensor cores, so it stays far from the bf16 peak
// (wgmma + TMA is later work).
//
// The reduction order is part of the contract: every output element is
// accumulated by ONE thread, with fmaf, over k = 0, 1, ..., K-1 in order.
// Nothing depends on M, on which rows share a tile, on the tile shape or on
// the grid, and there is no split-K.  So a row gives bit-identical results
// whether it is multiplied alone, with 3 other slots or with 7 other
// requests, which is what keeps the continuous and the static serving
// engines token-identical.  Masked edges load zeros, and fmaf(0, 0, acc)
// leaves acc unchanged.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (no fast-math: expf/tanhf stay accurate)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1 };
enum ActCode { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4 };

// Element (z1, z2, r, c) lives at ptr + z1*s0 + z2*s1 + r*s2 + c*s3.
struct Operand {
  const void* ptr;
  long long s0, s1, s2, s3;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename TA, typename TB>
cudaError_t by_out(const Problem& p, int c_dtype) {
  if (c_dtype == kBF16) return by_shape<TA, TB, __nv_bfloat16>(p);
  return by_shape<TA, TB, float>(p);
}

template <typename TA>
cudaError_t by_b(const Problem& p, int b_dtype, int c_dtype) {
  if (b_dtype == kBF16) return by_out<TA, __nv_bfloat16>(p, c_dtype);
  return by_out<TA, float>(p, c_dtype);
}

}  // namespace

// Plain C interface for ctypes.  Strides are in elements, four per operand:
// (batch outer, batch inner, row, column).  Returns cudaGetLastError() after
// the launch; the caller raises on anything but 0.  Launches on ``stream``
// and does not synchronise.
extern "C" int repro_matmul(const void* a, const long long* a_strides,
                            int a_dtype, const void* b,
                            const long long* b_strides, int b_dtype,
                            const float* bias, void* c, int c_dtype, int z1,
                            int z2, int m, int n, int k, int act,
                            void* stream) {
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
  p.stream = static_cast<cudaStream_t>(stream);
  if (a_dtype == kBF16) return static_cast<int>(by_b<__nv_bfloat16>(p, b_dtype, c_dtype));
  return static_cast<int>(by_b<float>(p, b_dtype, c_dtype));
}
