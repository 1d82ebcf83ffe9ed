// Causal flash attention, forward and backward, for Hopper (sm_90a).
//
//   O[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h / g]) v[b, t, h / g]
//
// over t <= s (causal, aligned top-left) or every t, g = Hq / Hkv query
// heads per kv head (GQA), scale = hd^-0.5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel): the same online softmax,
// (m, l, acc) in fp32, l floored at 1e-30, kv blocks past the diagonal
// skipped.  What differs is where the loops go.  The TPU kernel walks the
// kv blocks along a sequential grid axis and carries (m, l, acc) in VMEM
// scratch from one grid step to the next; GPU blocks run in no order, so
// here a CTA owns a query block and loops over its kv blocks itself.  The
// reference's wrapper folds heads into the batch and repeats K and V g
// times (ops.py _flash_impl); these kernels read q, k and v (B, S, H, hd)
// through their strides and index kv head h / g, so the repeat is never
// written out.  The ragged edge (S not a multiple of the block) is masked,
// not padded.  The forward also writes lse = m + log(l) per query row,
// which the backward needs.
//
// The TPU kernel has no backward: the reference never differentiates
// through it.  Training in the port runs every no-cache attention on these
// kernels, so the gradient is here too, in closed form from lse:
//   P = exp(scale q.k - lse), D = rowsum(dO * O), dV = P^T dO,
//   dS = P * (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q,
// with no atomics, so the result's bits do not depend on timing.
//
// Two paths, chosen from the dtype and hd alone (tensor_core_path below;
// kernels/flash_attention.py choose_path states the same rule), never
// from B, S or the heads:
//   * tensor core (bf16 at hd 64, 96, 128 and 256): repro_flash_tc_fwd,
//     then for the backward repro_flash_tc_dq (which writes D),
//     repro_flash_tc_dkv and repro_flash_tc_group_sum;
//   * FMA (fp32 at every head dim, bf16 at hd 16 and 32): flash_fwd,
//     flash_bwd_dq and flash_bwd_dkv, the first port's kernels: every
//     operand in shared memory as fp32 on the FP32 pipe (67 TFLOP/s on
//     the data sheet), one CTA per (batch, head, 64-row block); the fp32
//     gates hold them.  bf16 is instantiated only at hd 16 and 32, where
//     no tensor-core kernel runs, so no unreachable kernel is built.  The
//     forward's three tiles and score tile take 89 KiB at hd 96 and 210
//     KiB at hd 256 of the 227 KiB (232,448 bytes) a CTA may have, the
//     backward's 113.5 KiB (dQ) and 130.3 KiB (dK/dV) at hd 96.  At hd 256
//     with 64-row tiles both backward kernels would be over the limit (dQ
//     274.8 KiB, dK/dV 291.5 KiB), so there the kv side of the backward
//     takes 32-row tiles (kBwdKV below): dQ 207,616 bytes, dK/dV 216,576.
//     The sums keep their fixed order (the group's query heads in head
//     order, no atomics), so a backward's bits repeat at every head dim.
//
// What bounds it on an H100: at tinyllama-1.1b's training shape (B 2, S
// 2048, 32 query heads, 4 kv heads, hd 64) the forward is two products of
// 2 B Hq S^2 hd FLOPs halved by causality (34 GFLOP), the backward 2.5x
// that, against 8 to 34 MB of operands: bound by operations, 0.122 ms for
// forward + backward at the 989 TFLOP/s of bf16 tensor cores; phi3-mini's
// (2, 2048, 32, 32, 96) 0.182 ms, gemma-2b's (2, 2048, 8, 1, 256) 0.122.
// What the tensor-core path does about it:
//   - every product is a wgmma (bf16 in, fp32 accumulators in registers)
//     from 128-byte-swizzled shared memory.  A CTA is three warpgroups:
//     a producer warpgroup, of which one warp loads with TMA through a
//     ring of mbarrier-guarded stages (4-D tensor maps over (hd, heads,
//     rows, batch), kv head h / g in the coordinate, boxes past the rows
//     read as zeros), and two consumer warpgroups of 64 rows each.  The
//     producers hand their registers to the consumers with setmaxnreg,
//     40 a thread to 232 (a CTA launches at 168 a thread);
//   - the softmax runs on the accumulator fragment in registers (row max
//     and sum over the four threads of a quad, exp2 of the scores times
//     scale log2 e), and P (forward), dS (dQ), Pᵀ and dSᵀ (dK/dV) go to the
//     next wgmma as its register A operand: nothing goes back through
//     shared memory.  Each is split into bf16 hi = bf16(x) and lo =
//     bf16(x - hi), issued as two wgmmas, because one bf16 rounding put
//     dQ past the bf16 gate of chip_smoke.py; hi + lo leaves 2^-16 of
//     each term, where the plain versions run fp32 throughout;
//   - V, K, dO and Q as the B operand of P V, dS K, Pᵀ dO and dSᵀ Q are
//     read MN-major through the transpose bit: no tile is transposed;
//   - only a block crossing the diagonal or the ragged edge is masked, and
//     the longest query blocks are scheduled first;
//   - the dK/dV kernel runs one CTA per (batch, query head, kv block):
//     1,024 CTAs at tinyllama's training shape, where one per kv head (the
//     FMA path's design) gives 256 of very unequal length (the causal
//     triangle) for 132 SMs.  Each writes its head's scale dK and dV as
//     fp32 partials (67 MB at the training shape); repro_flash_tc_group_sum
//     adds each kv head's g partials in head order and casts to bf16.
//     That costs about 134 MB of traffic, some 40 us at 3.35 TB/s, and
//     keeps the backward deterministic;
//   - at hd 96, 128 and 256 the dK/dV kernel takes 32 query rows a stage
//     (64 at hd 64), so its two accumulators (128 registers a thread), Sᵀ
//     and dPᵀ (16 each) and their bf16 halves (32) fit in a consumer's 232
//     registers, without spills;
//   - hd 96 runs on the hd-128 tiles (pad64): the tensor maps take hd as
//     their innermost extent with 64-column boxes, so the second box reads
//     columns 64-95 and TMA writes zeros in 96-127 (the copy loader writes
//     them itself).  Q Kᵀ, dO Vᵀ and their transposes contract over 6 of
//     the 8 k steps; P V, dS K, Pᵀ dO and dSᵀ Q run at N = 128 (a 96-wide
//     MN-major B would cut a 64-column swizzle panel in half), their zero
//     columns never stored: 7/6 of the forward's hd-96 work, 8/7 of the
//     backward's;
//   - hd 256: for a warpgroup's 64 rows the O or dQ accumulator alone is
//     128 fp32 registers a thread, so the forward's kv stages are 64 rows
//     (S 32 registers, P's halves 16 each; Q 64 KiB + two stages of K and
//     V 128 KiB = 197,672 bytes with barriers) and dQ's 32 rows (S and dP
//     16 each; Q and dO 128 KiB + three stages 96 KiB = 230,968 bytes).
//     P V and dS K go as two m64n128 wgmmas, one per 128-column half.
//     Two 64 x 256 dK and dV accumulators would be 256 registers a thread,
//     so the dK/dV kernel splits hd: both consumer warpgroups take the same
//     64 kv rows and each accumulates one 128-column half of dK and dV
//     (K, V 64 KiB + four stages of 32 query rows 128 KiB = 198,728
//     bytes).  Sᵀ and dPᵀ contract over the whole hd, and both warpgroups
//     compute them.  Handing them over through shared memory instead
//     would put two named-barrier waits a stage between warpgroups that
//     now run free, and 16 KiB of fp32 traffic a stage; computing them
//     twice makes the backward's 7 products (S and dP in each kernel, dQ,
//     dV, dK) 9, 9/7 of the work, with the register budget of hd 128's
//     dK/dV kernel.  One CTA per (batch, query head, 64 kv rows): 8x the
//     CTAs of the FMA kernel's one per kv head at gemma's MQA shape;
//   - every wgmma sits on a path the compiler can prove warp-uniform (the
//     warpgroup index through a shuffle, the barrier's retry loop inside
//     its asm): otherwise ptxas serializes them (its C7520 notice).
// An operand a tensor map cannot describe (hd not contiguous, a base or a
// stride not 16-byte aligned) is copied by the producer's lanes into the
// same swizzled layout: the loader differs, the wgmma sequence does not.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -Xptxas -v  (no fast-math: expf/logf stay
//             accurate).  hopper.cuh holds the Hopper primitives shared
//             with matmul.cu.

#include <type_traits>

#include "hopper.cuh"

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// FMA path (fp32; bf16 at hd 16 and 32).  Shared-memory rows are
// padded by one float so that the transposed reads and writes of a warp
// fall in distinct banks.
// ---------------------------------------------------------------------------

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBKV = 64;            // kv rows per block (forward)
constexpr int kTR = 16;             // thread rows
constexpr int kTC = 16;             // thread columns (one half-warp)
constexpr int kThreads = kTR * kTC;
constexpr int kRM = kBQ / kTR;      // query rows per thread

// kv rows per block of the backward: 64, and 32 at hd 256, where two
// 64-row kv tiles and the query tiles would not fit (header note).  The
// query blocks stay at kBQ; a causal loop over one side runs to the other
// side's diagonal and the mask inside a block does the rest, so the two
// sides need not be equal.
template <int HD>
constexpr int kBwdKV = HD > 128 ? 32 : 64;

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

// A tile of BR rows, transposed: dst[d * (BR + 1) + r].
template <typename T, int HD, int BR>
__device__ __forceinline__ void load_cols(float* dst, const T* src,
                                          const Tensor4& t, int row0, int n) {
  for (int e = threadIdx.x; e < BR * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, gr = row0 + r;
    dst[d * (BR + 1) + r] = gr < n ? to_f32(src[gr * t.s1 + d * t.s3]) : 0.f;
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

// acc[i][j] = sum_d A[(tr + 16 i) * (HD + 1) + d] * BT[d * (BN + 1) + tc +
// 16 j]: a 64 x BN block of row-by-row dot products.
template <int HD, int BN>
__device__ __forceinline__ void dot_rows(float (&acc)[kRM][BN / kTC],
                                         const float* A, const float* BT,
                                         int tr, int tc) {
  constexpr int CN = BN / kTC;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[kRM], b[CN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) a[i] = A[(tr + i * kTR) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = BT[d * (BN + 1) + tc + j * kTC];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
  constexpr int KP = kBKV + 1;
  constexpr int CN = kBKV / kTC;  // score columns per thread
  constexpr int DN = HD / kTC;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][HP], q * scale
  float* KsT = Qs + kBQ * HP;    // [HD][65]
  float* Vs = KsT + HD * KP;     // [64][HP]
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
    load_cols<T, HD, kBKV>(KsT, K, k, c0, Skv);
    load_rows<T, HD>(Vs, V, v, c0, Skv, 1.f);
    __syncthreads();
    float s[kRM][CN];
    dot_rows<HD, kBKV>(s, Qs, KsT, tr, tc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int gr = row0 + tr + i * kTR;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int gc = c0 + tc + j * kTC;
        if (gc >= Skv || (causal && gc > gr)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        Ps[(tr + i * kTR) * KP + tc + j * kTC] = s[i][j];
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
      for (int i = 0; i < kRM; ++i) p[i] = Ps[(tr + i * kTR) * KP + c];
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
// Backward, dQ (and D): grid (query blocks, Hq, B); kv blocks of BKV rows.
// ---------------------------------------------------------------------------

template <typename T, int HD, int BKV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 o, Tensor4 dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 T* __restrict__ dq, int S, int Skv, int Hq, int group,
                 float scale, int causal) {
  constexpr int HP = HD + 1;
  constexpr int KP = BKV + 1;
  constexpr int CN = BKV / kTC;
  constexpr int DN = HD / kTC;
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][HP], q * scale
  float* dOs = Qs + kBQ * HP;    // [64][HP]
  float* KsT = dOs + kBQ * HP;   // [HD][KP]
  float* VsT = KsT + HD * KP;    // [HD][KP]
  float* dSs = VsT + HD * KP;    // [64][KP]

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
  for (int c0 = 0; c0 < kv_end; c0 += BKV) {
    __syncthreads();  // the previous block is done with KsT, VsT and dSs
    load_cols<T, HD, BKV>(KsT, K, k, c0, Skv);
    load_cols<T, HD, BKV>(VsT, V, v, c0, Skv);
    __syncthreads();
    float s[kRM][CN], dp[kRM][CN];
    dot_rows<HD, BKV>(s, Qs, KsT, tr, tc);
    dot_rows<HD, BKV>(dp, dOs, VsT, tr, tc);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int gr = row0 + tr + i * kTR;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int gc = c0 + tc + j * kTC;
        const bool keep = gr < S && gc < Skv && !(causal && gc > gr);
        const float p = keep ? expf(s[i][j] - ls[i]) : 0.f;
        dSs[(tr + i * kTR) * KP + tc + j * kTC] = p * (dp[i][j] - dd[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BKV; ++c) {
      float ds[kRM], kk[DN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) ds[i] = dSs[(tr + i * kTR) * KP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) kk[j] = KsT[(tc + j * kTC) * KP + c];
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
// Backward, dK and dV: grid (kv blocks of BKV rows, Hkv, B).
// ---------------------------------------------------------------------------

template <typename T, int HD, int BKV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int Skv, int Hq, int group,
                  float scale, int causal) {
  constexpr int HP = HD + 1;
  constexpr int KP = BKV + 1;
  constexpr int CN = BKV / kTC;  // score columns per thread
  constexpr int KM = BKV / kTR;  // kv rows per thread
  constexpr int DN = HD / kTC;
  extern __shared__ float smem[];
  float* KsT = smem;             // [HD][KP]
  float* VsT = KsT + HD * KP;    // [HD][KP]
  float* Qs = VsT + HD * KP;     // [64][HP], q * scale
  float* dOs = Qs + kBQ * HP;    // [64][HP]
  float* Ps = dOs + kBQ * HP;    // [64][KP]
  float* dSs = Ps + kBQ * KP;    // [64][KP]
  float* lse_s = dSs + kBQ * KP;   // [64]
  float* dd_s = lse_s + kBQ;       // [64]

  const int c0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int tr = threadIdx.x / kTC, tc = threadIdx.x % kTC;
  load_cols<T, HD, BKV>(KsT, head<T>(k, b, hk), k, c0, Skv);
  load_cols<T, HD, BKV>(VsT, head<T>(v, b, hk), v, c0, Skv);

  // rows tr + 16 i of this kv block, columns tc + 16 j of the head
  float dk_acc[KM][DN], dv_acc[KM][DN];
#pragma unroll
  for (int i = 0; i < KM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query blocks from this kv block's first row on (causal)
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
      float s[kRM][CN], dp[kRM][CN];
      dot_rows<HD, BKV>(s, Qs, KsT, tr, tc);
      dot_rows<HD, BKV>(dp, dOs, VsT, tr, tc);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int r = tr + i * kTR, gr = row0 + r;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int gc = c0 + tc + j * kTC;
          const bool keep = gr < S && gc < Skv && !(causal && gc > gr);
          const float p = keep ? expf(s[i][j] - lse_s[r]) : 0.f;
          Ps[r * KP + tc + j * kTC] = p;
          dSs[r * KP + tc + j * kTC] = p * (dp[i][j] - dd_s[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T (q * scale) over this block's rows
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float p[KM], ds[KM], g[DN], qq[DN];
#pragma unroll
        for (int i = 0; i < KM; ++i) {
          p[i] = Ps[r * KP + tr + i * kTR];
          ds[i] = dSs[r * KP + tr + i * kTR];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          g[j] = dOs[r * HP + tc + j * kTC];
          qq[j] = Qs[r * HP + tc + j * kTC];
        }
#pragma unroll
        for (int i = 0; i < KM; ++i)
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
  for (int i = 0; i < KM; ++i) {
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
  return sizeof(float) *
         (2 * kBQ * (HD + 1) + HD * (kBKV + 1) + kBQ * (kBKV + 1));
}
template <int HD, int BKV>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * kBQ * (HD + 1) + 2 * HD * (BKV + 1) + kBQ * (BKV + 1));
}
template <int HD, int BKV>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * HD * (BKV + 1) + 2 * kBQ * (HD + 1) +
                          2 * kBQ * (BKV + 1) + 2 * kBQ);
}
constexpr size_t kMaxSmem = 232448;  // bytes a CTA may have on sm_90
static_assert(fwd_smem<256>() <= kMaxSmem, "forward tiles at hd 256");
static_assert(dq_smem<256, kBwdKV<256>>() <= kMaxSmem, "dQ tiles at hd 256");
static_assert(dkv_smem<256, kBwdKV<256>>() <= kMaxSmem,
              "dK/dV tiles at hd 256");
static_assert(dkv_smem<128, kBwdKV<128>>() <= kMaxSmem,
              "dK/dV tiles at hd 128");

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
  constexpr int BKV = kBwdKV<HD>;
  constexpr size_t dq_bytes = dq_smem<HD, BKV>(), dkv_bytes = dkv_smem<HD, BKV>();
  const int group = p.Hq / p.Hkv;
  cudaError_t err = raise_smem(flash_bwd_dq<T, HD, BKV>, dq_bytes);
  if (err != cudaSuccess) return err;
  err = raise_smem(flash_bwd_dkv<T, HD, BKV>, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.S + kBQ - 1) / kBQ, p.Hq, p.B);
  flash_bwd_dq<T, HD, BKV><<<grid_q, kThreads, dq_bytes, p.stream>>>(
      p.q, p.k, p.v, p.o, p.dout, static_cast<const float*>(p.lse),
      static_cast<float*>(p.delta), static_cast<T*>(p.dq), p.S, p.Skv, p.Hq,
      group, p.scale, p.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((p.Skv + BKV - 1) / BKV, p.Hkv, p.B);
  flash_bwd_dkv<T, HD, BKV><<<grid_kv, kThreads, dkv_bytes, p.stream>>>(
      p.q, p.k, p.v, p.dout, static_cast<const float*>(p.lse),
      static_cast<const float*>(p.delta), static_cast<T*>(p.dk),
      static_cast<T*>(p.dv), p.S, p.Skv, p.Hq, group, p.scale, p.causal);
  return cudaGetLastError();
}

// fp32 at every head dim; bf16 only at hd 16 and 32, the head dims the
// tensor-core kernels leave to this path (tensor_core_path), so that no
// unreachable kernel is built
template <bool kBackward, typename T>
cudaError_t by_head_dim(const Problem& p, int hd) {
  switch (hd) {
    case 16: return kBackward ? backward<T, 16>(p) : forward<T, 16>(p);
    case 32: return kBackward ? backward<T, 32>(p) : forward<T, 32>(p);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (hd) {
      case 64: return kBackward ? backward<T, 64>(p) : forward<T, 64>(p);
      case 96: return kBackward ? backward<T, 96>(p) : forward<T, 96>(p);
      case 128: return kBackward ? backward<T, 128>(p) : forward<T, 128>(p);
      case 256: return kBackward ? backward<T, 256>(p) : forward<T, 256>(p);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 at hd 64, 96, 128 and 256)
// ---------------------------------------------------------------------------

constexpr int kTcConsumers = 256;  // two consumer warpgroups (warps 0-7)
constexpr int kTcProducers = 32;   // the loading warp (warp 8) of
constexpr int kTcThreads = 384;    // a producer warpgroup (warps 8-11)
// Registers a thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers (40 x 128 + 232 x 256 = the 168 x 384 a CTA is
// launched with), whose accumulators, scores and bf16 operands need it.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kErrNoEncoder = 10000;  // returned when libcuda lacks TMA
constexpr int kErrEncode = 11000;     // + the CUresult of a refused map

// One (B, rows, heads, hd) bf16 operand: element (b, r, h, d) at
// ptr + b*s0 + r*s1 + h*s2 + d*s3.  ``tma`` is 1 where a tensor map loads
// it, 0 where the producer's threads copy it.
struct TcTensor {
  const __nv_bfloat16* ptr;
  long long s0, s1, s2, s3;
  int rows, heads, tma;
};

// hd rounded up to whole 64-column panels: 128 at hd 96, whose tiles
// carry 32 zero columns (TMA fills past the map's hd extent with zeros)
__host__ __device__ constexpr int pad64(int hd) { return (hd + 63) / 64 * 64; }

// An R-row tile of HD columns in shared memory: pad64(HD) / 64 panels of
// R rows of 128 bytes (64 bf16), each row swizzled as TMA's 128-byte
// swizzle writes it; panel p starts p * R * 128 bytes in.
template <int R, int HD>
__host__ __device__ constexpr int tile_bytes() {
  return R * pad64(HD) * 2;
}

// The copy loader, for an operand no tensor map can describe: the producer
// warp's lanes copy rows [row0, row0 + R) of head h, element by element,
// into the layout TMA would have written: zeros past the operand's rows
// and, at hd 96, in columns 96-127 of the padded tile (TMA's fill there).
template <int R, int HD>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const TcTensor& t,
                                          int row0, int h, int b, int lane) {
  constexpr int HP = pad64(HD);
  const __nv_bfloat16* src = t.ptr + b * t.s0 + h * t.s2;
  for (int e = lane; e < R * HP; e += kTcProducers) {
    const int r = e / HP, d = e % HP, gr = row0 + r;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (gr < t.rows && d < HD) v = src[gr * t.s1 + d * t.s3];
    *reinterpret_cast<__nv_bfloat16*>(dst + (d >> 6) * (R * 128) +
                                      swizzled<0>(r, d & 63)) = v;
  }
}

// One tile a stage fills: where it goes, what it holds (head ``h``).
struct Tile {
  uint8_t* dst;
  const TcTensor* t;
  const CUtensorMap* map;
  int h;
};

// The producer warp fills N tiles (rows [row0, row0 + R) of batch b) and
// arrives on ``bar``: the copies first, then lane 0's expected byte count
// and its TMA loads (one 64-column box per panel); the other lanes arrive
// after their copies.  ``bar`` expects 32 arrivals.
template <int R, int HD, int N>
__device__ __forceinline__ void fill(const Tile (&tiles)[N], uint64_t* bar,
                                     int row0, int b, int lane) {
  bool copied = false;
  uint32_t tx = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (tiles[i].t->tma) {
      tx += tile_bytes<R, HD>();
    } else {
      copy_tile<R, HD>(tiles[i].dst, *tiles[i].t, row0, tiles[i].h, b, lane);
      copied = true;
    }
  }
  // copies are generic-proxy writes; wgmma reads through the async proxy
  if (copied) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (lane == 0) {
    mbar_arrive_expect_tx(bar, tx);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!tiles[i].t->tma) continue;
#pragma unroll
      for (int p = 0; p < pad64(HD) / 64; ++p)
        tma_load_4d(tiles[i].dst + p * R * 128, tiles[i].map, bar, 64 * p,
                    tiles[i].h, row0, b);
    }
  } else {
    mbar_arrive(bar);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// An m64nN accumulator fragment (N / 2 fp32 a thread: for each 8-column
// block j, rows 16*warp + lane/4 and +8, columns 2*(lane%4) and +1) as the
// register A operand of the next wgmma: k step kk takes column blocks 2kk
// and 2kk+1, which is the same order, two values a register, the lower
// column in the low half.  Split in two bf16 halves, hi = bf16(x) and
// lo = bf16(x - hi), which the next product issues one after the other:
// one bf16 rounding of P or dS (up to 2^-8 of each term) puts the tail of
// a large call's outputs more than a bf16 step of their row's largest
// element off the plain version's; hi + lo leaves 2^-16.
template <int N>
__device__ __forceinline__ void to_a_split(const float* d, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    const float2 back = __bfloat1622float2(h);
    __nv_bfloat162 l =
        __floats2bfloat162_rn(d[2 * i] - back.x, d[2 * i + 1] - back.y);
    hi[i] = *reinterpret_cast<uint32_t*>(&h);
    lo[i] = *reinterpret_cast<uint32_t*>(&l);
  }
}

// D = A Bᵀ over hd, HD / 16 k steps, the first overwriting D: A the 64
// rows at ``a`` of a K-major RA-row tile, B a K-major N-row tile at ``b``.
// At hd 96 that is 6 of the padded tile's 8 steps: its zero columns
// are never read.
template <int N, int HD, int RA>
__device__ __forceinline__ void gemm_rows(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 bf16 along a 128-byte row
    const uint64_t da = desc_sw128(a + (kk >> 2) * RA * 128 + off, 16);
    const uint64_t db = desc_sw128(b + (kk >> 2) * N * 128 + off, 16);
    wgmma_ss<N, 0, 0>(d, da, db, kk > 0);
  }
}

// D += A B: A in registers (64 rows x KR, the hi and lo bf16 halves from
// to_a_split, hi first at each k step), B the N columns from the panel at
// ``b`` of a KR-row tile, read MN-major (hd contiguous) through the
// transpose bit: 64-column panels KR * 128 bytes apart (LBO), a k step 16
// rows (2048 bytes).  N = 256 goes as two wgmmas of 128 columns, whose
// fragments lie one after the other in D.
template <int N, int KR>
__device__ __forceinline__ void gemm_acc(float* d, const uint32_t* hi,
                                         const uint32_t* lo, uint32_t b) {
  constexpr int NC = N > 128 ? 128 : N;
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk)
#pragma unroll
    for (int c = 0; c < N / NC; ++c) {
      const uint64_t db =
          desc_sw128(b + c * (NC / 64) * KR * 128 + kk * 2048, KR * 128);
      wgmma_rs<NC, 1>(d + c * NC / 2, hi + 4 * kk, db, 1);
      wgmma_rs<NC, 1>(d + c * NC / 2, lo + 4 * kk, db, 1);
    }
}

// Block x of a 1-D grid of tiles x Hq x B: its tile (reversed, longest
// first, where ``reverse``), query head and batch.  Neighbouring blocks
// take neighbouring heads, which share their kv head in L2.
__device__ __forceinline__ void block_coords(int tiles, int Hq, int B,
                                             bool reverse, int& tile, int& h,
                                             int& b) {
  const int i = blockIdx.x / (Hq * B);
  tile = reverse ? tiles - 1 - i : i;
  h = blockIdx.x % Hq;
  b = (blockIdx.x / Hq) % B;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              int stages, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kTcProducers);
      mbar_init(&empty[s], kTcConsumers);
    }
    mbar_init(once, kTcProducers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ----------------------------------------------------------------- forward

template <int HD>
struct FwdTc {
  static constexpr int kHP = pad64(HD);  // columns of O a thread holds
  static constexpr int kBQ = 128;   // query rows a CTA: two warpgroups of 64
  // kv rows a stage: at hd 256 O alone takes 128 registers a thread, so
  // S gets 32 (and P's halves 16 each), not 64
  static constexpr int kBKV = HD > 128 ? 64 : 128;
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kQ = tile_bytes<kBQ, HD>();
  static constexpr int kKV = tile_bytes<kBKV, HD>();  // K, and V
  // + 1024 to align, + a full and an empty barrier a stage and Q's
  static constexpr int kSmem =
      1024 + kQ + kStages * 2 * kKV + (2 * kStages + 1) * 8;
};

struct FwdArgs {
  CUtensorMap q_map, k_map, v_map;
  TcTensor q, k, v;
  __nv_bfloat16* o;
  float* lse;
  int B, S, Skv, Hq, group, causal, tiles;
  float scale;
};

// One CTA: 128 query rows of one (batch, query head).  Warp 8 loads Q
// once, then K and V tiles of 128 rows into the ring.  Warpgroup w owns
// rows 64w..64w+63: S = Q Kᵀ (wgmma from shared memory), the online softmax
// on the fragment in fp32 (exp2 of the scores times scale·log2 e), P
// rounded to bf16 in registers, O += P V (V MN-major).  Scores are masked
// only in a block that crosses the diagonal or the ragged kv edge.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    repro_flash_tc_fwd(__grid_constant__ const FwdArgs p) {
  using F = FwdTc<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem + F::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + F::kStages * 2 * F::kKV);
  uint64_t* empty = full + F::kStages;
  uint64_t* once = empty + F::kStages;
  int tile, h, b;
  block_coords(p.tiles, p.Hq, p.B, p.causal, tile, h, b);
  const int m0 = tile * F::kBQ;
  const int kv_end = p.causal ? min(p.Skv, m0 + F::kBQ) : p.Skv;
  const int nkv = (kv_end + F::kBKV - 1) / F::kBKV;
  init_barriers(full, empty, F::kStages, once);

  // the warpgroup index through a shuffle, so that the compiler knows it
  // is the same across the warp (wgmma must not sit on a divergent path)
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == kTcConsumers / 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kTcConsumers + kTcProducers) return;
    const int lane = threadIdx.x - kTcConsumers;
    const Tile q[1] = {{smem, &p.q, &p.q_map, h}};
    fill<F::kBQ, HD>(q, once, m0, b, lane);
    for (int n = 0; n < nkv; ++n) {
      const int s = n % F::kStages;
      mbar_wait(&empty[s], ((n / F::kStages) & 1) ^ 1);
      uint8_t* st = ring + s * 2 * F::kKV;
      const Tile kv[2] = {{st, &p.k, &p.k_map, h / p.group},
                          {st + F::kKV, &p.v, &p.v_map, h / p.group}};
      fill<F::kBKV, HD>(kv, &full[s], n * F::kBKV, b, lane);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row = m0 + 64 * wg + 16 * warp + lane / 4;  // and row + 8
  const float sl2 = p.scale * kLog2e;
  float o[F::kHP / 2], sc[F::kBKV / 2];
  uint32_t pa[F::kBKV / 4], pl[F::kBKV / 4];
#pragma unroll
  for (int i = 0; i < F::kHP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < F::kBKV / 2; ++i) sc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(once, 0);
  const uint32_t q_at = smem_u32(smem) + wg * 64 * 128;
  for (int n = 0; n < nkv; ++n) {
    const int s = n % F::kStages;
    const int c0 = n * F::kBKV;
    mbar_wait(&full[s], (n / F::kStages) & 1);
    const uint32_t k_at = smem_u32(ring + s * 2 * F::kKV);
    const uint32_t v_at = k_at + F::kKV;
    wgmma_fence();
    gemm_rows<F::kBKV, HD, F::kBQ>(sc, q_at, k_at);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<F::kBKV / 2>(sc);
    if ((p.causal && c0 + F::kBKV - 1 > m0 + 64 * wg) ||
        c0 + F::kBKV > p.Skv) {
#pragma unroll
      for (int i = 0; i < F::kBKV / 2; ++i) {
        const int col = c0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int r = row + 8 * ((i / 2) % 2);
        if (col >= p.Skv || (p.causal && col > r)) sc[i] = -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < F::kBKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = quad_max(mx);
      // a row with every score masked so far keeps m = -inf: p = 0
      const float base = mx == -INFINITY ? 0.f : mx * sl2;
      corr[hh] = exp2f(m[hh] * sl2 - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < F::kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          sc[i] = exp2f(fmaf(sc[i], sl2, -base));
          rs += sc[i];
        }
      // each thread sums its own columns; the quad's sums meet at the end
      l[hh] = l[hh] * corr[hh] + rs;
      m[hh] = mx;
    }
#pragma unroll
    for (int i = 0; i < F::kHP / 2; ++i) o[i] *= corr[(i / 2) % 2];
    to_a_split<F::kBKV>(sc, pa, pl);
    wgmma_fence();
    gemm_acc<F::kHP, F::kBKV>(o, pa, pl, v_at);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<F::kHP / 2>(o);
    fence_regs<F::kBKV / 4>(pa);
    fence_regs<F::kBKV / 4>(pl);
    mbar_arrive(&empty[s]);
  }

  const long long lse_at = (static_cast<long long>(b) * p.Hq + h) * p.S;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    const float lf = fmaxf(quad_sum(l[hh]), 1e-30f);
    if (r >= p.S) continue;
    __nv_bfloat16* out =
        p.o + ((static_cast<long long>(b) * p.S + r) * p.Hq + h) * HD +
        2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * hh] / lf, o[4 * j + 2 * hh + 1] / lf);
    if (lane % 4 == 0)
      p.lse[lse_at + r] =
          (m[hh] == -INFINITY ? kNegInf : m[hh] * p.scale) + logf(lf);
  }
}

// ---------------------------------------------------------------- backward

struct BwdArgs {
  CUtensorMap q_map, k_map, v_map, do_map;
  TcTensor q, k, v, dout, o;  // o is read by plain loads, for D
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
  float* part;  // (2, B, Skv, Hq, hd) fp32: dK and dV of each query head
  int B, S, Skv, Hq, group, causal, q_tiles, kv_tiles;
  float scale;
};

template <int HD>
struct DqTc {
  static constexpr int kHP = pad64(HD);  // columns of dQ a thread holds
  static constexpr int kBQ = 128;  // query rows a CTA: two warpgroups of 64
  // kv rows a stage: at hd 256 dQ takes 128 registers a thread, so S and
  // dP get 16 each, not 32
  static constexpr int kBKV = HD > 128 ? 32 : 64;
  static constexpr int kStages = HD == 64 ? 4 : 3;
  static constexpr int kQ = tile_bytes<kBQ, HD>();    // Q, and dO
  static constexpr int kKV = tile_bytes<kBKV, HD>();  // K, and V
  static constexpr int kSmem =
      1024 + 2 * kQ + kStages * 2 * kKV + kBQ * 4 + (2 * kStages + 1) * 8;
};

// dQ and D: one CTA per (batch, query head, 128 query rows), as the
// forward.  D = rowsum(dO * O) first (two threads a row, from device
// memory; written to ``delta`` for the dK/dV kernel), then per 64-row kv
// block: S = Q Kᵀ and dP = dO Vᵀ (wgmma), P = exp(scale S - lse) and
// dS = P (dP - D) in fp32, dS rounded to bf16 in registers, dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    repro_flash_tc_dq(__grid_constant__ const BwdArgs p) {
  using F = DqTc<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem + 2 * F::kQ;
  float* dsm = reinterpret_cast<float*>(ring + F::kStages * 2 * F::kKV);
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm + F::kBQ);
  uint64_t* empty = full + F::kStages;
  uint64_t* once = empty + F::kStages;
  int tile, h, b;
  block_coords(p.q_tiles, p.Hq, p.B, p.causal, tile, h, b);
  const int m0 = tile * F::kBQ;
  const int kv_end = p.causal ? min(p.Skv, m0 + F::kBQ) : p.Skv;
  const int nkv = (kv_end + F::kBKV - 1) / F::kBKV;
  init_barriers(full, empty, F::kStages, once);

  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == kTcConsumers / 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kTcConsumers + kTcProducers) return;
    const int lane = threadIdx.x - kTcConsumers;
    const Tile qdo[2] = {{smem, &p.q, &p.q_map, h},
                         {smem + F::kQ, &p.dout, &p.do_map, h}};
    fill<F::kBQ, HD>(qdo, once, m0, b, lane);
    for (int n = 0; n < nkv; ++n) {
      const int s = n % F::kStages;
      mbar_wait(&empty[s], ((n / F::kStages) & 1) ^ 1);
      uint8_t* st = ring + s * 2 * F::kKV;
      const Tile kv[2] = {{st, &p.k, &p.k_map, h / p.group},
                          {st + F::kKV, &p.v, &p.v_map, h / p.group}};
      fill<F::kBKV, HD>(kv, &full[s], n * F::kBKV, b, lane);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const long long rows_at = (static_cast<long long>(b) * p.Hq + h) * p.S;
  {
    const int rl = 64 * wg + t / 2, r = m0 + rl, half = t % 2;
    float part = 0.f;
    if (r < p.S) {
      const __nv_bfloat16* go = p.o.ptr + b * p.o.s0 + r * p.o.s1 + h * p.o.s2;
      const __nv_bfloat16* gd =
          p.dout.ptr + b * p.dout.s0 + r * p.dout.s1 + h * p.dout.s2;
#pragma unroll 8
      for (int d = half * HD / 2; d < (half + 1) * HD / 2; ++d)
        part += __bfloat162float(gd[d * p.dout.s3]) *
                __bfloat162float(go[d * p.o.s3]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      dsm[rl] = part;
      if (r < p.S) p.delta[rows_at + r] = part;
    }
  }
  // this warpgroup's D rows are written by its own threads
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  const int row = m0 + 64 * wg + 16 * warp + lane / 4;  // and row + 8
  const float sl2 = p.scale * kLog2e;
  float dd[2], ls[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    dd[hh] = dsm[row - m0 + 8 * hh];
    ls[hh] = row + 8 * hh < p.S ? p.lse[rows_at + row + 8 * hh] * kLog2e : 0.f;
  }
  float dq[F::kHP / 2], sc[F::kBKV / 2], dp[F::kBKV / 2];
  uint32_t da[F::kBKV / 4], dl[F::kBKV / 4];
#pragma unroll
  for (int i = 0; i < F::kHP / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < F::kBKV / 2; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(once, 0);
  const uint32_t q_at = smem_u32(smem) + wg * 64 * 128;
  const uint32_t do_at = q_at + F::kQ;
  for (int n = 0; n < nkv; ++n) {
    const int s = n % F::kStages;
    const int c0 = n * F::kBKV;
    mbar_wait(&full[s], (n / F::kStages) & 1);
    const uint32_t k_at = smem_u32(ring + s * 2 * F::kKV);
    const uint32_t v_at = k_at + F::kKV;
    wgmma_fence();
    gemm_rows<F::kBKV, HD, F::kBQ>(sc, q_at, k_at);
    gemm_rows<F::kBKV, HD, F::kBQ>(dp, do_at, v_at);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<F::kBKV / 2>(sc);
    fence_regs<F::kBKV / 2>(dp);
    const bool edge = (p.causal && c0 + F::kBKV - 1 > m0 + 64 * wg) ||
                      c0 + F::kBKV > p.Skv;
#pragma unroll
    for (int i = 0; i < F::kBKV / 2; ++i) {
      const int hh = (i / 2) % 2;
      const int col = c0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      float pr = exp2f(fmaf(sc[i], sl2, -ls[hh]));
      if (edge && (col >= p.Skv || (p.causal && col > row + 8 * hh)))
        pr = 0.f;
      sc[i] = pr * (dp[i] - dd[hh]);  // dS
    }
    to_a_split<F::kBKV>(sc, da, dl);
    wgmma_fence();
    gemm_acc<F::kHP, F::kBKV>(dq, da, dl, k_at);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<F::kHP / 2>(dq);
    fence_regs<F::kBKV / 4>(da);
    fence_regs<F::kBKV / 4>(dl);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= p.S) continue;
    __nv_bfloat16* out =
        p.dq + ((static_cast<long long>(b) * p.S + r) * p.Hq + h) * HD +
        2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          p.scale * dq[4 * j + 2 * hh], p.scale * dq[4 * j + 2 * hh + 1]);
  }
}

template <int HD>
struct DkvTc {
  // at hd 256 the two warpgroups split hd, not the kv rows: one 64 x 256
  // dK and dV pair would be 256 registers a thread
  static constexpr bool kSplitHd = HD > 128;
  // kv rows a CTA: two warpgroups of 64, or both on the same 64 rows
  static constexpr int kBKV = kSplitHd ? 64 : 128;
  // columns of dK and dV a warpgroup accumulates (at hd 96 the padded 128)
  static constexpr int kCols = kSplitHd ? pad64(HD) / 2 : pad64(HD);
  // query rows a stage: at hd 96 and up the two accumulators take 128
  // registers a thread, so Sᵀ and dPᵀ get 16 each, not 32
  static constexpr int kBQ = HD == 64 ? 64 : 32;
  static constexpr int kStages = 4;
  static constexpr int kKV = tile_bytes<kBKV, HD>();  // K, and V
  static constexpr int kQ = tile_bytes<kBQ, HD>();    // Q, and dO
  // + lse·log2 e and D of each stage's query rows
  static constexpr int kSmem = 1024 + 2 * kKV + kStages * 2 * kQ +
                               kStages * 2 * kBQ * 4 + (2 * kStages + 1) * 8;
};

// dK and dV of one query head: one CTA per (batch, query head, 128 kv
// rows), so 8x the CTAs of one per kv head.  K and V are loaded once; the
// ring brings Q, dO, lse and D for each query block from the diagonal
// down.  Warpgroup w owns kv rows 64w..64w+63: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
// (wgmma), Pᵀ and dSᵀ in fp32, both rounded to bf16 in registers, dV += Pᵀ
// dO and dK += dSᵀ Q (dO and Q MN-major).  The head's scale·dK and dV go to
// fp32 partials, which repro_flash_tc_group_sum adds up per kv head.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    repro_flash_tc_dkv(__grid_constant__ const BwdArgs p) {
  using F = DkvTc<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem + 2 * F::kKV;
  float* stats = reinterpret_cast<float*>(ring + F::kStages * 2 * F::kQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + F::kStages * 2 * F::kBQ);
  uint64_t* empty = full + F::kStages;
  uint64_t* once = empty + F::kStages;
  int tile, h, b;
  block_coords(p.kv_tiles, p.Hq, p.B, false, tile, h, b);  // kv 0 longest
  const int c0 = tile * F::kBKV;
  const int r_begin = p.causal ? c0 : 0;  // query rows above it see none
  const int nq = p.S > r_begin ? (p.S - r_begin + F::kBQ - 1) / F::kBQ : 0;
  const long long rows_at = (static_cast<long long>(b) * p.Hq + h) * p.S;
  init_barriers(full, empty, F::kStages, once);

  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == kTcConsumers / 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kTcConsumers + kTcProducers) return;
    const int lane = threadIdx.x - kTcConsumers;
    const Tile kv[2] = {{smem, &p.k, &p.k_map, h / p.group},
                        {smem + F::kKV, &p.v, &p.v_map, h / p.group}};
    fill<F::kBKV, HD>(kv, once, c0, b, lane);
    for (int i = 0; i < nq; ++i) {
      const int s = i % F::kStages;
      const int r0 = r_begin + i * F::kBQ;
      mbar_wait(&empty[s], ((i / F::kStages) & 1) ^ 1);
      float* st = stats + s * 2 * F::kBQ;
      for (int e = lane; e < F::kBQ; e += kTcProducers) {
        const int gr = r0 + e;
        st[e] = gr < p.S ? p.lse[rows_at + gr] * kLog2e : 0.f;
        st[F::kBQ + e] = gr < p.S ? p.delta[rows_at + gr] : 0.f;
      }
      uint8_t* sq = ring + s * 2 * F::kQ;
      const Tile qdo[2] = {{sq, &p.q, &p.q_map, h},
                           {sq + F::kQ, &p.dout, &p.do_map, h}};
      fill<F::kBQ, HD>(qdo, &full[s], r0, b, lane);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // this warpgroup's first kv row, and its first column of dK and dV
  const int kv0 = F::kSplitHd ? c0 : c0 + 64 * wg;
  const int col0 = F::kSplitHd ? wg * F::kCols : 0;
  const int row = kv0 + 16 * warp + lane / 4;  // kv; and row + 8
  const float sl2 = p.scale * kLog2e;
  float dk[F::kCols / 2], dv[F::kCols / 2], sc[F::kBQ / 2], dp[F::kBQ / 2];
  uint32_t pa[F::kBQ / 4], pl[F::kBQ / 4], da[F::kBQ / 4], dl[F::kBQ / 4];
#pragma unroll
  for (int i = 0; i < F::kCols / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < F::kBQ / 2; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(once, 0);
  const uint32_t k_at = smem_u32(smem) + (kv0 - c0) * 128;
  const uint32_t v_at = k_at + F::kKV;
  const uint32_t cols_at = (col0 / 64) * F::kBQ * 128;  // its Q, dO panels
  for (int i = 0; i < nq; ++i) {
    const int s = i % F::kStages;
    const int r0 = r_begin + i * F::kBQ;
    mbar_wait(&full[s], (i / F::kStages) & 1);
    const uint32_t q_at = smem_u32(ring + s * 2 * F::kQ);
    const uint32_t do_at = q_at + F::kQ;
    const float* st = stats + s * 2 * F::kBQ;
    wgmma_fence();
    gemm_rows<F::kBQ, HD, F::kBKV>(sc, k_at, q_at);
    gemm_rows<F::kBQ, HD, F::kBKV>(dp, v_at, do_at);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<F::kBQ / 2>(sc);
    fence_regs<F::kBQ / 2>(dp);
    const bool edge = (p.causal && r0 < kv0 + 63) || r0 + F::kBQ > p.S;
#pragma unroll
    for (int j = 0; j < F::kBQ / 8; ++j) {
      const int cl = 8 * j + 2 * (lane % 4);  // query row in the block
      const float2 l2 = *reinterpret_cast<const float2*>(st + cl);
      const float2 d2 = *reinterpret_cast<const float2*>(st + F::kBQ + cl);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i2 = 4 * j + 2 * hh + e;
          const int col = r0 + cl + e;
          float pr = exp2f(fmaf(sc[i2], sl2, -(e ? l2.y : l2.x)));
          if (edge && (col >= p.S || (p.causal && row + 8 * hh > col)))
            pr = 0.f;
          dp[i2] = pr * (dp[i2] - (e ? d2.y : d2.x));  // dSᵀ
          sc[i2] = pr;                                  // Pᵀ
        }
    }
    to_a_split<F::kBQ>(sc, pa, pl);
    to_a_split<F::kBQ>(dp, da, dl);
    wgmma_fence();
    gemm_acc<F::kCols, F::kBQ>(dv, pa, pl, do_at + cols_at);
    gemm_acc<F::kCols, F::kBQ>(dk, da, dl, q_at + cols_at);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<F::kCols / 2>(dv);
    fence_regs<F::kCols / 2>(dk);
    fence_regs<F::kBQ / 4>(pa);
    fence_regs<F::kBQ / 4>(pl);
    fence_regs<F::kBQ / 4>(da);
    fence_regs<F::kBQ / 4>(dl);
    mbar_arrive(&empty[s]);
  }

  const long long half =
      static_cast<long long>(p.B) * p.Skv * p.Hq * HD;  // dK's, then dV's
  // the columns this warpgroup stores: not the zero padding at hd 96
  constexpr int kStored = F::kCols < HD ? F::kCols : HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r >= p.Skv) continue;
    float* pk = p.part +
                ((static_cast<long long>(b) * p.Skv + r) * p.Hq + h) * HD +
                col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kStored / 8; ++j) {
      const int i = 4 * j + 2 * hh;
      *reinterpret_cast<float2*>(pk + 8 * j) =
          make_float2(p.scale * dk[i], p.scale * dk[i + 1]);
      *reinterpret_cast<float2*>(pk + half + 8 * j) =
          make_float2(dv[i], dv[i + 1]);
    }
  }
}

// dK and dV (B, Skv, Hkv, hd) bf16: each kv head's group of per-query-head
// partials summed in head order, a fixed order, so the bits do not depend
// on timing.  One thread per 4 columns of a (batch, position, kv head).
__global__ void __launch_bounds__(256)
    repro_flash_tc_group_sum(const float* __restrict__ part,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, long long n4,
                             int group, int hkv, int hd4, long long half) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bs = i / (hkv * hd4);
    const int rem = static_cast<int>(i % (hkv * hd4));
    const int hk = rem / hd4, c = rem % hd4;
    const float* src = part + ((bs * hkv + hk) * group * hd4 + c) * 4;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* at = src + which * half;
      float4 acc = *reinterpret_cast<const float4*>(at);
      for (int j = 1; j < group; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(at + j * hd4 * 4);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      __nv_bfloat16* dst = (which ? dv : dk) + i * 4;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc.x, acc.y);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
          __floats2bfloat162_rn(acc.z, acc.w);
    }
  }
}

// Every tensor-core kernel's shared memory within a CTA's 227 KiB; at hd
// 256 the forward takes 197,672 bytes, dQ 230,968 and dK/dV 198,728.
template <int HD>
constexpr bool tc_fits() {
  return FwdTc<HD>::kSmem <= kMaxSmem && DqTc<HD>::kSmem <= kMaxSmem &&
         DkvTc<HD>::kSmem <= kMaxSmem;
}
static_assert(tc_fits<64>() && tc_fits<96>() && tc_fits<128>() &&
                  tc_fits<256>(),
              "tensor-core tiles within a CTA's shared memory");

// ------------------------------------------------------------------ launch

// A 4-D map (hd, heads, rows, B) of a (B, rows, heads, hd) operand, boxes
// of 64 columns x 1 head x box_rows rows, 128-byte swizzle, rows past the
// operand read as zeros.  A dimension of extent 1 is never stepped along,
// so it gets a stride TMA accepts whatever the tensor's.  Returns 0 or an
// error code.
int encode_rows(CUtensorMap* map, const TcTensor& t, int B, int hd,
                int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                        static_cast<cuuint64_t>(t.heads),
                        static_cast<cuuint64_t>(t.rows > 0 ? t.rows : 1),
                        static_cast<cuuint64_t>(B)};
  const long long elem_strides[3] = {t.s2, t.s1, t.s0};
  cuuint64_t strides[3];
  long long prev = static_cast<long long>(hd) * 2;  // bytes
  for (int i = 0; i < 3; ++i) {
    long long s = elem_strides[i] * 2;
    if (dims[i + 1] == 1) s = (prev + 15) / 16 * 16;
    strides[i] = static_cast<cuuint64_t>(s);
    prev = s * static_cast<long long>(dims[i + 1]);
  }
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<__nv_bfloat16*>(t.ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

int encode_if(CUtensorMap* map, const TcTensor& t, int B, int hd, int rows) {
  return t.tma ? encode_rows(map, t, B, hd, rows) : 0;
}

template <typename K, typename A>
cudaError_t launch_tc(K kernel, long long blocks, int smem, const A& args,
                      cudaStream_t stream) {
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = raise_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int HD>
int tc_forward(FwdArgs a, cudaStream_t stream) {
  using F = FwdTc<HD>;
  int err = encode_if(&a.q_map, a.q, a.B, HD, F::kBQ);
  if (!err) err = encode_if(&a.k_map, a.k, a.B, HD, F::kBKV);
  if (!err) err = encode_if(&a.v_map, a.v, a.B, HD, F::kBKV);
  if (err) return err;
  a.tiles = (a.S + F::kBQ - 1) / F::kBQ;
  return static_cast<int>(
      launch_tc(repro_flash_tc_fwd<HD>,
                static_cast<long long>(a.tiles) * a.Hq * a.B, F::kSmem, a,
                stream));
}

template <int HD>
int tc_backward(BwdArgs a, __nv_bfloat16* dk, __nv_bfloat16* dv, int Hkv,
                cudaStream_t stream) {
  using Q = DqTc<HD>;
  using K = DkvTc<HD>;
  BwdArgs d = a;  // the dK/dV kernel's maps: other boxes
  int err = encode_if(&a.q_map, a.q, a.B, HD, Q::kBQ);
  if (!err) err = encode_if(&a.do_map, a.dout, a.B, HD, Q::kBQ);
  if (!err) err = encode_if(&a.k_map, a.k, a.B, HD, Q::kBKV);
  if (!err) err = encode_if(&a.v_map, a.v, a.B, HD, Q::kBKV);
  if (!err) err = encode_if(&d.q_map, d.q, d.B, HD, K::kBQ);
  if (!err) err = encode_if(&d.do_map, d.dout, d.B, HD, K::kBQ);
  if (!err) err = encode_if(&d.k_map, d.k, d.B, HD, K::kBKV);
  if (!err) err = encode_if(&d.v_map, d.v, d.B, HD, K::kBKV);
  if (err) return err;
  a.q_tiles = d.q_tiles = (a.S + Q::kBQ - 1) / Q::kBQ;
  a.kv_tiles = d.kv_tiles = (a.Skv + K::kBKV - 1) / K::kBKV;
  cudaError_t e = launch_tc(repro_flash_tc_dq<HD>,
                            static_cast<long long>(a.q_tiles) * a.Hq * a.B,
                            Q::kSmem, a, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_tc(repro_flash_tc_dkv<HD>,
                static_cast<long long>(d.kv_tiles) * d.Hq * d.B, K::kSmem, d,
                stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long half = static_cast<long long>(a.B) * a.Skv * a.Hq * HD;
  const long long n4 = static_cast<long long>(a.B) * a.Skv * Hkv * (HD / 4);
  const long long want = (n4 + 255) / 256;
  const long long blocks = want < 132 * 16 ? want : 132 * 16;
  repro_flash_tc_group_sum<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      a.part, dk, dv, n4, a.group, Hkv, HD / 4, half);
  return static_cast<int>(cudaGetLastError());
}

// The path by dtype and hd alone, never B, S or the heads: the tensor
// cores for bf16 at hd 64, 96, 128 and 256, the FMA kernels for the rest
// (kernels/flash_attention.py choose_path states the same rule, to count
// the calls by path and to allocate the backward's partials).
bool tensor_core_path(int dtype, int hd) {
  return dtype == kBF16 && (hd == 64 || hd == 96 || hd == 128 || hd == 256);
}

// Seven ints of one tensor-core kernel at out: dynamic shared memory bytes,
// rows a CTA owns, rows a stage brings, stages, registers a thread at
// launch (setmaxnreg moves them later), local (spill) bytes a thread and
// resident CTAs an SM, as the CUDA runtime reports them on this card.
template <typename K>
cudaError_t info_of(K kernel, int smem, int rows, int stage_rows, int stages,
                    int* out) {
  cudaError_t err = raise_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kTcThreads, smem);
  if (err != cudaSuccess) return err;
  const int row[7] = {smem, rows, stage_rows, stages, attr.numRegs,
                      static_cast<int>(attr.localSizeBytes), ctas};
  for (int i = 0; i < 7; ++i) out[i] = row[i];
  return cudaSuccess;
}

template <int HD>
cudaError_t tc_info(int* out) {
  using F = FwdTc<HD>;
  using Q = DqTc<HD>;
  using K = DkvTc<HD>;
  cudaError_t err = info_of(repro_flash_tc_fwd<HD>, F::kSmem, F::kBQ,
                            F::kBKV, F::kStages, out);
  if (err == cudaSuccess)
    err = info_of(repro_flash_tc_dq<HD>, Q::kSmem, Q::kBQ, Q::kBKV,
                  Q::kStages, out + 7);
  if (err == cudaSuccess)
    err = info_of(repro_flash_tc_dkv<HD>, K::kSmem, K::kBKV, K::kBQ,
                  K::kStages, out + 14);
  return err;
}

TcTensor tc_tensor(const void* ptr, const long long* st, int rows, int heads,
                   int tma) {
  return {static_cast<const __nv_bfloat16*>(ptr), st[0], st[1], st[2], st[3],
          rows, heads, tma};
}

}  // namespace

// Plain C interface for ctypes; the path follows from dtype and hd
// (tensor_core_path).  q (B, S, Hq, hd), k and v (B, Skv, Hkv, hd), each with four
// element strides; o (B, S, Hq, hd) contiguous in the inputs' dtype; lse
// (B, Hq, S) fp32.  ``tma`` (tensor-core path): bit 0 for q, 1 for k, 2
// for v, set where a tensor map can load the operand; the producer's lanes
// copy the others.  Launches on ``stream``, does not synchronise, returns
// cudaGetLastError() after the launch, or a code of 10000 and above where
// a tensor map could not be made (the caller raises on anything but 0).
// hd must be 16, 32, 64, 96, 128 or 256.
extern "C" int repro_flash_fwd(const void* q, const long long* q_st,
                               const void* k, const long long* k_st,
                               const void* v, const long long* v_st, void* o,
                               float* lse, int dtype, int B, int S, int Skv,
                               int Hq, int Hkv, int hd, float scale,
                               int causal, int tma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_core_path(dtype, hd)) {
    if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
    FwdArgs a = {};
    a.q = tc_tensor(q, q_st, S, Hq, tma & 1);
    a.k = tc_tensor(k, k_st, Skv, Hkv, (tma >> 1) & 1);
    a.v = tc_tensor(v, v_st, Skv, Hkv, (tma >> 2) & 1);
    a.o = static_cast<__nv_bfloat16*>(o);
    a.lse = lse;
    a.B = B;
    a.S = S;
    a.Skv = Skv;
    a.Hq = Hq;
    a.group = Hq / Hkv;
    a.causal = causal;
    a.scale = scale;
    switch (hd) {
      case 64: return tc_forward<64>(a, st);
      case 96: return tc_forward<96>(a, st);
      case 128: return tc_forward<128>(a, st);
      default: return tc_forward<256>(a, st);
    }
  }
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
  p.stream = st;
  return static_cast<int>(dispatch<false>(p, dtype, hd));
}

// The backward: o and dout (B, S, Hq, hd) strided, lse (B, Hq, S) from the
// forward, delta (B, Hq, S) fp32 scratch; writes dq (B, S, Hq, hd), dk and
// dv (B, Skv, Hkv, hd), contiguous in the inputs' dtype.  The FMA path
// launches two kernels; the tensor-core path three, with ``part`` (2, B,
// Skv, Hq, hd) fp32 scratch for the per-query-head dK and dV (null on the
// FMA path) and ``tma`` bit 3 for dout.
extern "C" int repro_flash_bwd(const void* q, const long long* q_st,
                               const void* k, const long long* k_st,
                               const void* v, const long long* v_st,
                               const void* o, const long long* o_st,
                               const void* dout, const long long* do_st,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, float* part, int dtype,
                               int B, int S, int Skv, int Hq, int Hkv, int hd,
                               float scale, int causal, int tma,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_core_path(dtype, hd)) {
    if (Hkv <= 0 || Hq % Hkv || part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    BwdArgs a = {};
    a.q = tc_tensor(q, q_st, S, Hq, tma & 1);
    a.k = tc_tensor(k, k_st, Skv, Hkv, (tma >> 1) & 1);
    a.v = tc_tensor(v, v_st, Skv, Hkv, (tma >> 2) & 1);
    a.dout = tc_tensor(dout, do_st, S, Hq, (tma >> 3) & 1);
    a.o = tc_tensor(o, o_st, S, Hq, 0);
    a.lse = lse;
    a.delta = delta;
    a.dq = static_cast<__nv_bfloat16*>(dq);
    a.part = part;
    a.B = B;
    a.S = S;
    a.Skv = Skv;
    a.Hq = Hq;
    a.group = Hq / Hkv;
    a.causal = causal;
    a.scale = scale;
    auto* dk16 = static_cast<__nv_bfloat16*>(dk);
    auto* dv16 = static_cast<__nv_bfloat16*>(dv);
    switch (hd) {
      case 64: return tc_backward<64>(a, dk16, dv16, Hkv, st);
      case 96: return tc_backward<96>(a, dk16, dv16, Hkv, st);
      case 128: return tc_backward<128>(a, dk16, dv16, Hkv, st);
      default: return tc_backward<256>(a, dk16, dv16, Hkv, st);
    }
  }
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
  p.stream = st;
  return static_cast<int>(dispatch<true>(p, dtype, hd));
}

// The tensor-core kernels at head dim hd (64, 96, 128 or 256): seven ints
// each (info_of) for the forward, dQ and dK/dV, 21 in all.  Returns a
// cudaError_t.
extern "C" int repro_flash_tc_info(int hd, int* out) {
  switch (hd) {
    case 64: return static_cast<int>(tc_info<64>(out));
    case 96: return static_cast<int>(tc_info<96>(out));
    case 128: return static_cast<int>(tc_info<128>(out));
    case 256: return static_cast<int>(tc_info<256>(out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
