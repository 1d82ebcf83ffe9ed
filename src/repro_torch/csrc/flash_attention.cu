// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
//   O[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / g]) v[b, t, h / g]
//
// over t <= s (causal, aligned top-left) or every t, g = Hq / Hkv query
// heads per kv head (GQA), scale = hd^-0.5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel): the same online softmax,
// (m, l, acc) in fp32, scores masked to -1e30, l floored at 1e-30 and kv
// blocks past the diagonal skipped.  What differs is where the loops go.
// The TPU kernel walks the kv blocks along a sequential grid axis and
// carries (m, l, acc) in VMEM scratch from one grid step to the next; GPU
// blocks run in no order, so here one CTA owns one (batch, query head,
// 64-row query block) and loops over its kv blocks itself, stopping at
// the diagonal.  The reference's wrapper folds heads into the batch and
// repeats K and V g times (ops.py _flash_impl); this kernel reads q, k and
// v (B, S, H, hd) through their strides and indexes kv head h / g, so the
// repeat is never written out.  The ragged edge (S not a multiple of 64)
// is masked, not padded.  The forward also writes lse = m + log(l) per
// query row, which the backward needs.
//
// The TPU kernel has no backward: the reference never differentiates
// through it.  Training in the port runs every no-cache attention on this
// kernel, so the gradient is here too, in closed form from lse:
//   P = exp(scale q.k - lse), D = rowsum(dO * O), dV = P^T dO,
//   dS = P * (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q.
// Two kernels, with no atomics, so the result does not depend on timing:
//   flash_bwd_dq  - one CTA per (b, query head, query block) loops over
//                   the kv blocks up to the diagonal, writes D (read by the
//                   next kernel) and dQ;
//   flash_bwd_dkv - one CTA per (b, kv head, kv block) loops over the g
//                   query heads of its group and the query blocks from the
//                   diagonal down, and writes dK and dV summed over the
//                   group.
//
// What bounds it on an H100: at the training shape (B 2, S 2048, 32 query
// heads, hd 64) attention is a pair of products of 2 B Hq S^2 hd FLOPs
// (halved by causality) against 8 to 34 MB of inputs, so it is bound by
// operations, about 0.035 ms forward at the bf16 tensor-core rate.  This
// first kernel keeps every operand in shared memory as fp32 and runs on
// the FP32 FMA pipe (67 TFLOP/s on the data sheet), each thread owning a
// 4 x 4 tile of scores and a 4 x hd/16 tile of the output, so it stays far
// from that bound; wgmma on bf16 tiles with TMA loads is later work.
// Shared-memory rows are padded by one float so that the transposed reads
// and writes of a warp fall in distinct banks.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC  (no fast-math: expf/logf stay accurate)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 64;            // kv rows per block
constexpr int kTR = 16;             // thread rows
constexpr int kTC = 16;             // thread columns (one half-warp)
constexpr int kThreads = kTR * kTC;
constexpr int kRM = kBQ / kTR;      // rows per thread
constexpr int kCN = kBKV / kTC;     // score columns per thread
constexpr int kKP = kBKV + 1;       // padded row of a (., 64) tile
static_assert(kBQ == kBKV, "the causal loops assume square blocks");

// Element (b, s, h, d) lives at ptr + b*s0 + s*s1 + h*s2 + d*s3.
struct Tensor4 {
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

template <typename T>
__device__ __forceinline__ const T* head(const Tensor4& t, int b, int h) {
  return static_cast<const T*>(t.ptr) + b * t.s0 + h * t.s2;
}

// A (rows, HD) tile of one head, rows [row0, row0 + 64), as fp32 times
// ``mul`` into dst[r * (HD + 1) + d]; rows past ``n`` load zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Tensor4& t, int row0, int n,
                                          float mul) {
  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, gr = row0 + r;
    dst[r * (HD + 1) + d] = gr < n ? to_f32(src[gr * t.s1 + d * t.s3]) * mul
                                   : 0.f;
  }
}

// The same tile transposed: dst[d * 65 + r].
template <typename T, int HD>
__device__ __forceinline__ void load_cols(float* dst, const T* src,
                                          const Tensor4& t, int row0, int n) {
  for (int e = threadIdx.x; e < kBKV * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, gr = row0 + r;
    dst[d * kKP + r] = gr < n ? to_f32(src[gr * t.s1 + d * t.s3]) : 0.f;
  }
}

// Sum (or max) over the 16 threads of a half-warp that share a row.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTC / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kTC / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// acc[i][j] = sum_d A[(tr + 16 i) * (HD + 1) + d] * BT[d * 65 + tc + 16 j]:
// a 64 x 64 block of row-by-row dot products.
template <int HD>
__device__ __forceinline__ void dot_rows(float (&acc)[kRM][kCN],
                                         const float* A, const float* BT,
                                         int tr, int tc) {
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kCN; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[kRM], b[kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) a[i] = A[(tr + i * kTR) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < kCN; ++j) b[j] = BT[d * kKP + tc + j * kTC];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Forward: grid (query blocks, Hq, B).
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(Tensor4 q, Tensor4 k, Tensor4 v, T* __restrict__ o,
              float* __restrict__ lse, int S, int Skv, int Hq, int group,
              float scale, int causal) {
  constexpr int HP = HD + 1;
  constexpr int DN = HD / kTC;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][HP], q * scale
  float* KsT = Qs + kBQ * HP;    // [HD][65]
  float* Vs = KsT + HD * kKP;    // [64][HP]
  float* Ps = Vs + kBKV * HP;    // [64][65]

  const int row0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  const T* K = head<T>(k, b, h / group);
  const T* V = head<T>(v, b, h / group);
  load_rows<T, HD>(Qs, head<T>(q, b, h), q, row0, S, scale);

  float m[kRM], l[kRM], acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(Skv, row0 + kBQ) : Skv;
  for (int c0 = 0; c0 < kv_end; c0 += kBKV) {
    __syncthreads();  // the previous block is done with KsT, Vs and Ps
    load_cols<T, HD>(KsT, K, k, c0, Skv);
    load_rows<T, HD>(Vs, V, v, c0, Skv, 1.f);
    __syncthreads();
    float s[kRM][kCN];
    dot_rows<HD>(s, Qs, KsT, tr, tc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int gr = row0 + tr + i * kTR;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int gc = c0 + tc + j * kTC;
        if (gc >= Skv || (causal && gc > gr)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        Ps[(tr + i * kTR) * kKP + tc + j * kTC] = s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBKV; ++c) {
      float p[kRM], vv[DN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) p[i] = Ps[(tr + i * kTR) * kKP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = Vs[c * HP + tc + j * kTC];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gr = row0 + tr + i * kTR;
    if (gr >= S) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<long long>(b) * S + gr) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) out[tc + j * kTC] = from_f32<T>(acc[i][j] / lf);
    if (tc == 0)
      lse[(static_cast<long long>(b) * Hq + h) * S + gr] = m[i] + logf(lf);
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ (and D): grid (query blocks, Hq, B).
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 o, Tensor4 dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 T* __restrict__ dq, int S, int Skv, int Hq, int group,
                 float scale, int causal) {
  constexpr int HP = HD + 1;
  constexpr int DN = HD / kTC;
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][HP], q * scale
  float* dOs = Qs + kBQ * HP;    // [64][HP]
  float* KsT = dOs + kBQ * HP;   // [HD][65]
  float* VsT = KsT + HD * kKP;   // [HD][65]
  float* dSs = VsT + HD * kKP;   // [64][65]

  const int row0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  const T* K = head<T>(k, b, h / group);
  const T* V = head<T>(v, b, h / group);
  const T* O = head<T>(o, b, h);
  load_rows<T, HD>(Qs, head<T>(q, b, h), q, row0, S, scale);
  load_rows<T, HD>(dOs, head<T>(dout, b, h), dout, row0, S, 1.f);
  __syncthreads();

  // D = rowsum(dO * O) and lse for this thread's rows
  const long long rows_at = (static_cast<long long>(b) * Hq + h) * S;
  float dd[kRM], ls[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = tr + i * kTR, gr = row0 + r;
    float part = 0.f;
    if (gr < S) {
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = tc + j * kTC;
        part += dOs[r * HP + d] * to_f32(O[gr * o.s1 + d * o.s3]);
      }
    }
    dd[i] = row_sum(part);
    ls[i] = gr < S ? lse[rows_at + gr] : 0.f;
    if (gr < S && tc == 0) delta[rows_at + gr] = dd[i];
  }

  float acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(Skv, row0 + kBQ) : Skv;
  for (int c0 = 0; c0 < kv_end; c0 += kBKV) {
    __syncthreads();  // the previous block is done with KsT, VsT and dSs
    load_cols<T, HD>(KsT, K, k, c0, Skv);
    load_cols<T, HD>(VsT, V, v, c0, Skv);
    __syncthreads();
    float s[kRM][kCN], dp[kRM][kCN];
    dot_rows<HD>(s, Qs, KsT, tr, tc);
    dot_rows<HD>(dp, dOs, VsT, tr, tc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int gr = row0 + tr + i * kTR;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const int gc = c0 + tc + j * kTC;
        const bool keep = gr < S && gc < Skv && !(causal && gc > gr);
        const float p = keep ? expf(s[i][j] - ls[i]) : 0.f;
        dSs[(tr + i * kTR) * kKP + tc + j * kTC] = p * (dp[i][j] - dd[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBKV; ++c) {
      float ds[kRM], kk[DN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) ds[i] = dSs[(tr + i * kTR) * kKP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) kk[j] = KsT[(tc + j * kTC) * kKP + c];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gr = row0 + tr + i * kTR;
    if (gr >= S) continue;
    T* out = dq + ((static_cast<long long>(b) * S + gr) * Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) out[tc + j * kTC] = from_f32<T>(scale * acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: grid (kv blocks, Hkv, B).
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int Skv, int Hq, int group,
                  float scale, int causal) {
  constexpr int HP = HD + 1;
  constexpr int DN = HD / kTC;
  extern __shared__ float smem[];
  float* KsT = smem;             // [HD][65]
  float* VsT = KsT + HD * kKP;   // [HD][65]
  float* Qs = VsT + HD * kKP;    // [64][HP], q * scale
  float* dOs = Qs + kBQ * HP;    // [64][HP]
  float* Ps = dOs + kBQ * HP;    // [64][65]
  float* dSs = Ps + kBQ * kKP;   // [64][65]
  float* lse_s = dSs + kBQ * kKP;  // [64]
  float* dd_s = lse_s + kBQ;       // [64]

  const int c0 = blockIdx.x * kBKV, hk = blockIdx.y, b = blockIdx.z;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  load_cols<T, HD>(KsT, head<T>(k, b, hk), k, c0, Skv);
  load_cols<T, HD>(VsT, head<T>(v, b, hk), v, c0, Skv);

  // rows tr + 16 i of this kv block, columns tc + 16 j of the head
  float dk_acc[kRM][DN], dv_acc[kRM][DN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query blocks at or below the diagonal of this kv block
  const int r_begin = causal ? c0 : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* Q = head<T>(q, b, h);
    const T* dO = head<T>(dout, b, h);
    const long long rows_at = (static_cast<long long>(b) * Hq + h) * S;
    for (int row0 = r_begin; row0 < S; row0 += kBQ) {
      __syncthreads();  // the previous block is done with Qs, dOs, Ps, dSs
      load_rows<T, HD>(Qs, Q, q, row0, S, scale);
      load_rows<T, HD>(dOs, dO, dout, row0, S, 1.f);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const int gr = row0 + r;
        lse_s[r] = gr < S ? lse[rows_at + gr] : 0.f;
        dd_s[r] = gr < S ? delta[rows_at + gr] : 0.f;
      }
      __syncthreads();
      float s[kRM][kCN], dp[kRM][kCN];
      dot_rows<HD>(s, Qs, KsT, tr, tc);
      dot_rows<HD>(dp, dOs, VsT, tr, tc);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int r = tr + i * kTR, gr = row0 + r;
#pragma unroll
        for (int j = 0; j < kCN; ++j) {
          const int gc = c0 + tc + j * kTC;
          const bool keep = gr < S && gc < Skv && !(causal && gc > gr);
          const float p = keep ? expf(s[i][j] - lse_s[r]) : 0.f;
          Ps[r * kKP + tc + j * kTC] = p;
          dSs[r * kKP + tc + j * kTC] = p * (dp[i][j] - dd_s[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T (q * scale) over this block's rows
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float p[kRM], ds[kRM], g[DN], qq[DN];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          p[i] = Ps[r * kKP + tr + i * kTR];
          ds[i] = dSs[r * kKP + tr + i * kTR];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          g[j] = dOs[r * HP + tc + j * kTC];
          qq[j] = Qs[r * HP + tc + j * kTC];
        }
#pragma unroll
        for (int i = 0; i < kRM; ++i)
#pragma unroll
          for (int j = 0; j < DN; ++j) {
            dv_acc[i][j] = fmaf(p[i], g[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qq[j], dk_acc[i][j]);
          }
      }
    }
  }

  const int hkv = Hq / group;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gc = c0 + tr + i * kTR;
    if (gc >= Skv) continue;
    const long long at = ((static_cast<long long>(b) * Skv + gc) * hkv + hk) * HD;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      dk[at + tc + j * kTC] = from_f32<T>(dk_acc[i][j]);
      dv[at + tc + j * kTC] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Problem {
  Tensor4 q, k, v, o, dout;
  void *out, *lse, *delta, *dq, *dk, *dv;
  int B, S, Skv, Hq, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kBQ * (HD + 1) + HD * kKP + kBQ * kKP);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBQ * (HD + 1) + 2 * HD * kKP + kBQ * kKP);
}
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * HD * kKP + 2 * kBQ * (HD + 1) + 2 * kBQ * kKP + 2 * kBQ);
}

// Every kernel here takes more than the default 48 KB of shared memory at
// hd = 64, so each launch first raises the kernel's dynamic limit.
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int HD>
cudaError_t forward(const Problem& p) {
  const int group = p.Hq / p.Hkv;
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  cudaError_t err = raise_smem(flash_fwd<T, HD>, fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  flash_fwd<T, HD><<<grid, kThreads, fwd_smem<HD>(), p.stream>>>(
      p.q, p.k, p.v, static_cast<T*>(p.out), static_cast<float*>(p.lse), p.S,
      p.Skv, p.Hq, group, p.scale, p.causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t backward(const Problem& p) {
  const int group = p.Hq / p.Hkv;
  cudaError_t err = raise_smem(flash_bwd_dq<T, HD>, dq_smem<HD>());
  if (err != cudaSuccess) return err;
  err = raise_smem(flash_bwd_dkv<T, HD>, dkv_smem<HD>());
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  flash_bwd_dq<T, HD><<<grid_q, kThreads, dq_smem<HD>(), p.stream>>>(
      p.q, p.k, p.v, p.o, p.dout, static_cast<const float*>(p.lse),
      static_cast<float*>(p.delta), static_cast<T*>(p.dq), p.S, p.Skv, p.Hq,
      group, p.scale, p.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.Skv + kBKV - 1) / kBKV, p.Hkv, p.B);
  flash_bwd_dkv<T, HD><<<grid_kv, kThreads, dkv_smem<HD>(), p.stream>>>(
      p.q, p.k, p.v, p.dout, static_cast<const float*>(p.lse),
      static_cast<const float*>(p.delta), static_cast<T*>(p.dk),
      static_cast<T*>(p.dv), p.S, p.Skv, p.Hq, group, p.scale, p.causal);
  return cudaGetLastError();
}

template <bool kBackward, typename T>
cudaError_t by_head_dim(const Problem& p, int hd) {
  switch (hd) {
    case 16: return kBackward ? backward<T, 16>(p) : forward<T, 16>(p);
    case 32: return kBackward ? backward<T, 32>(p) : forward<T, 32>(p);
    case 64: return kBackward ? backward<T, 64>(p) : forward<T, 64>(p);
    case 128: return kBackward ? backward<T, 128>(p) : forward<T, 128>(p);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward>
cudaError_t dispatch(const Problem& p, int dtype, int hd) {
  if (dtype == kBF16) return by_head_dim<kBackward, __nv_bfloat16>(p, hd);
  if (dtype == kF32) return by_head_dim<kBackward, float>(p, hd);
  return cudaErrorInvalidValue;
}

Tensor4 tensor4(const void* ptr, const long long* st) {
  return {ptr, st[0], st[1], st[2], st[3]};
}

}  // namespace

// Plain C interface for ctypes.  q (B, S, Hq, hd), k and v (B, Skv, Hkv,
// hd), each with four element strides; o (B, S, Hq, hd) contiguous in the
// inputs' dtype; lse (B, Hq, S) fp32.  Launches on ``stream``, does not
// synchronise, returns cudaGetLastError() (the caller raises on anything
// but 0).  hd must be 16, 32, 64 or 128.
extern "C" int repro_flash_fwd(const void* q, const long long* q_st,
                               const void* k, const long long* k_st,
                               const void* v, const long long* v_st, void* o,
                               float* lse, int dtype, int B, int S, int Skv,
                               int Hq, int Hkv, int hd, float scale,
                               int causal, void* stream) {
  Problem p{};
  p.q = tensor4(q, q_st);
  p.k = tensor4(k, k_st);
  p.v = tensor4(v, v_st);
  p.out = o;
  p.lse = lse;
  p.B = B;
  p.S = S;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  p.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<false>(p, dtype, hd));
}

// The backward: o and dout (B, S, Hq, hd) strided, lse (B, Hq, S) from the
// forward, delta (B, Hq, S) fp32 scratch; writes dq (B, S, Hq, hd), dk and
// dv (B, Skv, Hkv, hd), contiguous in the inputs' dtype.  Two launches.
extern "C" int repro_flash_bwd(const void* q, const long long* q_st,
                               const void* k, const long long* k_st,
                               const void* v, const long long* v_st,
                               const void* o, const long long* o_st,
                               const void* dout, const long long* do_st,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int dtype, int B, int S,
                               int Skv, int Hq, int Hkv, int hd, float scale,
                               int causal, void* stream) {
  Problem p{};
  p.q = tensor4(q, q_st);
  p.k = tensor4(k, k_st);
  p.v = tensor4(v, v_st);
  p.o = tensor4(o, o_st);
  p.dout = tensor4(dout, do_st);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.S = S;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.scale = scale;
  p.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<true>(p, dtype, hd));
}
