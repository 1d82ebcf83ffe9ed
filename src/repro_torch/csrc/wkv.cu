// Chunked RWKV6 WKV, forward and backward, for Hopper (sm_90a).
//
// Per (batch b, head h), from a zero (N, N) state S, over positions t:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t.
// In chunks of L positions (cw = cumsum(logw) over the chunk's rows, cwe
// its exclusive form, all fp32):
//   A[t, s] = sum_n r[t, n] k[s, n] exp(cwe[t, n] - cw[s, n])  (s < t),
//   A[t, t] = sum_n r[t, n] u[n] k[t, n],
//   o       = A v + (r exp(cwe)) S_c,
//   S_{c+1} = exp(cw_L) S_c + (k exp(cw_L - cw))^T v.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv.py::wkv_pallas
// (body _wkv_kernel), which walks the chunks along a sequential grid axis
// with S carried in VMEM.  Only the N x N state forces an order, so each
// direction is two launches:
//   wkv_state      one CTA per (b, h, 16 value columns of S), 128 threads,
//                  sequential over the chunks: the state pass.  It keeps
//                  its N x 16 slice of S in registers, loads the next
//                  chunk's k, v, logw into a second shared-memory stage
//                  with 16-byte cp.async while it works on this one, and
//                  writes S at every chunk's start to (B, H, nc, N, N)
//                  (the forward's kept chunk-start states, or scratch).
//                  The backward runs it in reverse on
//                  dS <- (r e^{cwe})^T dO + e^{cw_L} dS and writes the
//                  gradient of every chunk's end state.
//   wkv_fwd_out    one CTA per (b, h, chunk), 256 threads, independent of
//                  each other: A and o from the chunk's start state.
//   wkv_bwd_chunk  one CTA per (b, h, chunk): dr, dk, dv, dlogw and the
//                  chunk's share of du from its start state and its end
//                  state's gradient.  du is summed by the wrapper over
//                  (b, chunk) in a fixed order; nothing here uses atomics,
//                  so the bits repeat from run to run.
//
// The pairwise decay factored by sub-chunk.  A chunk is cut into sub-chunks
// of 16 rows; c_i = cwe at sub-chunk i's first row (= cw at the row before
// it).  For t in sub-chunk i and s in an earlier sub-chunk j < i,
//   e^{cwe_t - cw_s} = e^{cwe_t - c_i} * e^{c_i - cw_s},
// and cw never increases (logw <= 0), so
//   cwe_t <= c_i <= cw_s:   both exponents are <= 0,
// and neither factor overflows, however strong the decay; a factor that
// underflows does so only where the true term is below fp32's range.  cwe
// is cw shifted down a row (0 at the first), not cw - logw: at decays of
// ~-1000 a chunk, cw - logw rounds an ulp above the cw before it and an
// exponent turns positive.  Below the diagonal sub-blocks A, dr and dk are
// then products of scaled tiles, qf = r e^{cwe - c_i} (rows of sub-chunk
// i) and kf_i = k e^{c_i - cw} (rows before it), computed once a chunk and
// shared by A, dA's products, dr and dk; within a diagonal 16 x 16 block
// the decay stays elementwise, one exponential per (t, s, n) with s < t,
// taken over the pairs alone (no divergent branch).  At L = 64 a chunk of
// the forward takes ~44k exponentials (the first kernel 129k, and its
// backward three times that).
//
// What bounds it on an H100 (132 SMs, 3.35 TB/s, 67 TFLOP/s fp32 FMA): at
// rwkv6-3b's training shape (B 2, S 2048, H 40, N 64, L 64, bf16 r/k/v)
// the forward moves ~190 MB with the chunk-start states (0.057 ms) and
// does ~5.4 GFLOP of tile products (0.08 ms on the FP32 pipe); the
// backward ~294 MB and ~12 GFLOP.  The products run on the FP32 pipe from
// fp32 shared-memory tiles whose rows are padded by one word (conflict-free
// along either axis); each thread holds an (L/16) x (N/16) register tile,
// 4 x 4 at the training shape, two FMAs a shared-memory load, so shared
// memory, not the FMA rate, bounds the products.  Tensor cores would need
// a bf16 hi + lo or 3xTF32 split to hold the fp32 limit (1e-4 x
// max|plain|); plain TF32 keeps three digits.  The forward's per-chunk CTA
// takes ~101 KB of shared memory and at most 128 registers a thread, so
// two run on an SM; the backward's takes ~217 KB, one an SM.  cw is summed
// one thread a channel in the row order of the plain version
// (torch.cumsum), so the two agree bit for bit on it: at strong decays a
// parallel scan's other rounding moves the near-diagonal terms by ~1e-4,
// the whole fp32 limit.  dlogw's reverse sums are a two-level parallel
// scan.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1 };

constexpr int kSub = 16;            // rows of a sub-chunk
constexpr int kStateThreads = 128;  // state pass: threads a CTA
constexpr int kStateCols = 16;      // state pass: value columns of S a CTA
constexpr int kChunkThreads = 256;  // per-chunk kernels: threads a CTA

// Element (b, t, h, n) lives at ptr + b*s0 + t*s1 + h*s2 + n*s3.
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

// 16 bytes of fp32 or bf16 as fp32 (a bf16 is the top half of an fp32)
__device__ __forceinline__ void unpack16(const uint4& q, float* o,
                                         const float*) {
  o[0] = __uint_as_float(q.x);
  o[1] = __uint_as_float(q.y);
  o[2] = __uint_as_float(q.z);
  o[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16(const uint4& q, float* o,
                                         const __nv_bfloat16*) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// K consecutive floats from shared memory, as one access where aligned
template <int K>
__device__ __forceinline__ void lds(float (&v)[K], const float* p) {
  if constexpr (K == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = p[i];
  }
}

// ----------------------------------------------------------------- state

// One stage of the state pass: x (L x N), logw (L x N, fp32), y (L x 16),
// rows unpadded (every access walks a row across the lanes).
template <typename XT, typename YT, int L, int N>
struct StateLayout {
  static constexpr int kXBytes = L * N * int(sizeof(XT));
  static constexpr int kWBytes = L * N * 4;
  static constexpr int kYBytes = L * kStateCols * int(sizeof(YT));
  static constexpr int kStage = kXBytes + kWBytes + kYBytes;
  static constexpr size_t kSmem = 2 * size_t(kStage) + N * 4;
  static_assert(kXBytes % 16 == 0 && kYBytes % 16 == 0, "stage alignment");
};

// Rows [t0, t0 + ROWS) x columns [0, COLS) of one head into dst[row * COLS
// + col], zeros past S: 16-byte cp.async where ``vec`` (columns contiguous,
// rows 16-byte aligned), else element by element.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long s1, long long s3,
                                           int t0, int S, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), PER = COLS / V;
    for (int e = threadIdx.x; e < ROWS * PER; e += kStateThreads) {
      const int row = e / PER, col = (e % PER) * V, gt = t0 + row;
      cp_async16(dst + row * COLS + col,
                 src + static_cast<long long>(gt < S ? gt : 0) * s1 + col,
                 gt < S);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kStateThreads) {
      const int row = e / COLS, col = e % COLS, gt = t0 + row;
      dst[e] = gt < S ? src[gt * s1 + col * s3] : from_f32<T>(0.f);
    }
  }
}

// The state pass.  Forward (kRev false): x = k, y = v, from S = 0; per
// chunk write S to states[c] (its start), then
// S <- e^{cw_L} S + (x e^{cw_L - cw})^T y; S_final gets the last.
// Backward (kRev true): x = r, y = dO, from S = s_init (dstate, or 0);
// per chunk in reverse write S to states[c] (the gradient of its end
// state), then S <- e^{cw_L} S + (x e^{cwe})^T y.  CTA (b h, column block)
// owns S[:, j0 : j0 + 16]; thread (tn, tj) owns rows n0..n0+N/16-1 and
// columns jj, jj+1 of it.
template <typename XT, typename YT, int L, int N, bool kRev>
__global__ void __launch_bounds__(kStateThreads)
    wkv_state(Tensor4 x, Tensor4 w, Tensor4 y, const float* s_init,
              float* states, float* s_final, int S, int H, int nc, int vec) {
  using Lay = StateLayout<XT, YT, L, N>;
  constexpr int TNS = N / 16;
  static_assert(kStateThreads == 16 * (kStateCols / 2), "thread grid");
  extern __shared__ __align__(16) unsigned char smem[];
  float* DL = reinterpret_cast<float*>(smem + 2 * Lay::kStage);  // cw_L
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * kStateCols;
  const int tid = threadIdx.x, n0 = (tid % 16) * TNS, jj = (tid / 16) * 2;
  const XT* xp = head<XT>(x, b, h);
  const float* wp = head<float>(w, b, h);
  const YT* yp = head<YT>(y, b, h) + j0 * y.s3;
  float st[TNS][2];
#pragma unroll
  for (int a = 0; a < TNS; ++a)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      st[a][q] = s_init != nullptr
                     ? s_init[(static_cast<long long>(bh) * N + n0 + a) * N +
                              j0 + jj + q]
                     : 0.f;
  auto issue = [&](int it) {
    const int t0 = (kRev ? nc - 1 - it : it) * L;
    unsigned char* base = smem + (it & 1) * Lay::kStage;
    stage_rows<XT, L, N>(reinterpret_cast<XT*>(base), xp, x.s1, x.s3, t0, S,
                         vec);
    stage_rows<float, L, N>(reinterpret_cast<float*>(base + Lay::kXBytes),
                            wp, w.s1, w.s3, t0, S, vec);
    stage_rows<YT, L, kStateCols>(
        reinterpret_cast<YT*>(base + Lay::kXBytes + Lay::kWBytes), yp, y.s1,
        y.s3, t0, S, vec);
    cp_async_commit();
  };
  issue(0);
  for (int it = 0; it < nc; ++it) {
    const int c = kRev ? nc - 1 - it : it;
    if (it + 1 < nc) {
      issue(it + 1);  // the stage read in iteration it - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* base = smem + (it & 1) * Lay::kStage;
    const XT* X = reinterpret_cast<const XT*>(base);
    float* W = reinterpret_cast<float*>(base + Lay::kXBytes);
    const YT* Y = reinterpret_cast<const YT*>(base + Lay::kXBytes +
                                              Lay::kWBytes);
    if (tid < N) {  // W <- cw (forward) or cwe (backward), in row order
      float wv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) wv[t] = W[t * N + tid];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        if (kRev) W[t * N + tid] = acc;
        acc += wv[t];
        if (!kRev) W[t * N + tid] = acc;
      }
      DL[tid] = acc;
    }
    __syncthreads();
    // W <- x e^{cw_L - cw} (forward) or x e^{cwe} (backward); both <= 0
    for (int e = tid; e < L * N; e += kStateThreads) {
      const float ex = kRev ? W[e] : DL[e % N] - W[e];
      W[e] = to_f32(X[e]) * __expf(ex);
    }
    __syncthreads();
    float* dst = states + (static_cast<long long>(bh) * nc + c) * N * N +
                 j0 + jj;
#pragma unroll
    for (int a = 0; a < TNS; ++a) {
      *reinterpret_cast<float2*>(dst + (n0 + a) * N) =
          make_float2(st[a][0], st[a][1]);
      const float d = __expf(DL[n0 + a]);
      st[a][0] *= d;
      st[a][1] *= d;
    }
#pragma unroll 8
    for (int t = 0; t < L; ++t) {
      float xv[TNS];
      lds<TNS>(xv, W + t * N + n0);
      const float y0 = to_f32(Y[t * kStateCols + jj]);
      const float y1 = to_f32(Y[t * kStateCols + jj + 1]);
#pragma unroll
      for (int a = 0; a < TNS; ++a) {
        st[a][0] = fmaf(xv[a], y0, st[a][0]);
        st[a][1] = fmaf(xv[a], y1, st[a][1]);
      }
    }
    __syncthreads();  // the next issue() overwrites this stage
  }
  if (s_final != nullptr) {
#pragma unroll
    for (int a = 0; a < TNS; ++a)
      *reinterpret_cast<float2*>(
          s_final + (static_cast<long long>(bh) * N + n0 + a) * N + j0 + jj) =
          make_float2(st[a][0], st[a][1]);
  }
}

// ------------------------------------------------------------- per chunk

// Tiles of the per-chunk kernels: D x (D + 1) fp32, D = max(L, N), one pad
// word a row.  Thread (ty, tx) = (tid / 16, tid % 16) owns rows m0 = ty *
// TM .. m0 + TM - 1 (one sub-chunk, ib = m0 / 16) and columns tx + 16 c of
// an L x N (TN columns) or L x L (TL columns, column c in sub-chunk c)
// output.  Elementwise work: element q of a thread is row q * RQ + tid / N,
// column tid % N.
template <int L, int N>
struct Chunk {
  static constexpr int D = L > N ? L : N;
  static constexpr int P = D + 1;
  static constexpr int kTile = D * P;
  static constexpr int NB = L / kSub;
  static constexpr int TM = L / 16, TN = N / 16, TL = L / 16;
  static constexpr int EL = L * N / kChunkThreads;
  static constexpr int RQ = kChunkThreads / N;
  // kf_i (rows 0 .. 16 i - 1) for i = 1 .. NB - 1, stacked
  __host__ __device__ static constexpr int kf_row(int i) {
    return kSub * i * (i - 1) / 2;
  }
  static constexpr int KF_ROWS = kf_row(NB);
  static_assert(L % kSub == 0 && kChunkThreads == 256 && EL >= 1 &&
                    (kSub % RQ) == 0,
                "chunk shape");
};

// acc[a][c] += sum_{k in [k0, k1)} X[(m0 + a) XM + k XK] Y[(n0 + 16 c) YN
// + k YK], for the first NC of the thread's columns.
template <int NC, int XM, int XK, int YN, int YK, int TM, int TC>
__device__ __forceinline__ void mac(float (&acc)[TM][TC], const float* X,
                                    const float* Y, int m0, int n0, int k0,
                                    int k1) {
  static_assert(NC >= 1 && NC <= TC, "columns");
  const float* xb = X + m0 * XM;
  const float* yb = Y + n0 * YN;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float xv[TM], yv[NC];
#pragma unroll
    for (int a = 0; a < TM; ++a) xv[a] = xb[a * XM + k * XK];
#pragma unroll
    for (int c = 0; c < NC; ++c) yv[c] = yb[c * 16 * YN + k * YK];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(xv[a], yv[c], acc[a][c]);
  }
}

// mac over the first ``cols`` columns (warp-uniform, 1 .. TC)
template <int XM, int XK, int YN, int YK, int TM, int TC>
__device__ __forceinline__ void mac_cols(int cols, float (&acc)[TM][TC],
                                         const float* X, const float* Y,
                                         int m0, int n0, int k0, int k1) {
  switch (cols) {
    case 1: mac<1, XM, XK, YN, YK>(acc, X, Y, m0, n0, k0, k1); break;
    case 2:
      if constexpr (TC >= 2) mac<2, XM, XK, YN, YK>(acc, X, Y, m0, n0, k0, k1);
      break;
    case 3:
      if constexpr (TC >= 3) mac<3, XM, XK, YN, YK>(acc, X, Y, m0, n0, k0, k1);
      break;
    case 4:
      if constexpr (TC >= 4) mac<4, XM, XK, YN, YK>(acc, X, Y, m0, n0, k0, k1);
      break;
    default: break;
  }
}

// Chunk rows [t0, t0 + ROWS) x COLS columns of one head as fp32 into
// dst[row * P + col]; rows at or past S load zeros (the mask that makes the
// padding a no-op).  ``vec``: 16 bytes a thread.
template <typename T, int ROWS, int COLS, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s1, long long s3, int t0,
                                          int S, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), PER = COLS / V;
    for (int e = threadIdx.x; e < ROWS * PER; e += kChunkThreads) {
      const int row = e / PER, col = (e % PER) * V, gt = t0 + row;
      float vals[V];
      if (gt < S) {
        unpack16(*reinterpret_cast<const uint4*>(src + gt * s1 + col), vals,
                 src);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) vals[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) dst[row * P + col + i] = vals[i];
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kChunkThreads) {
      const int row = e / COLS, col = e % COLS, gt = t0 + row;
      dst[row * P + col] = gt < S ? to_f32(src[gt * s1 + col * s3]) : 0.f;
    }
  }
}

// An N x N fp32 state (contiguous, 16-byte aligned) into dst[n * P + j]
template <int N, int P>
__device__ __forceinline__ void load_state(float* dst, const float* src) {
  for (int e = threadIdx.x; e < N * N / 4; e += kChunkThreads) {
    const float4 q = reinterpret_cast<const float4*>(src)[e];
    const int row = 4 * e / N, col = 4 * e % N;
    float* d = dst + row * P + col;
    d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
  }
}

// In place over the logw tile CW, one thread a channel, in row order (the
// plain version's): CW <- cw, CWE <- cw shifted down a row (0 at row 0),
// CB[i * N + n] <- c_i = cwe at sub-chunk i's first row.
template <int L, int N, int P>
__device__ __forceinline__ void cumsums(float* CW, float* CWE, float* CB) {
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float wv[L];
#pragma unroll
    for (int t = 0; t < L; ++t) wv[t] = CW[t * P + n];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      CWE[t * P + n] = acc;
      if (t % kSub == 0 && t > 0) CB[(t / kSub) * N + n] = acc;
      acc += wv[t];
      CW[t * P + n] = acc;
    }
  }
}

// A's diagonal 16 x 16 blocks: the strictly-lower pairs, one thread a pair,
// the decay e^{cwe_t - cw_s} taken per n; then the u-weighted diagonal.
template <int L, int N>
__device__ __forceinline__ void diag_blocks_a(float* A, const float* R,
                                              const float* K, const float* CW,
                                              const float* CWE,
                                              const float* U) {
  using C = Chunk<L, N>;
  constexpr int P = C::P, kPairs = kSub * (kSub - 1) / 2;
  for (int p = threadIdx.x; p < kPairs * C::NB; p += kChunkThreads) {
    const int i = p / kPairs, q = p % kPairs;  // q = t (t - 1) / 2 + s
    int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * q)) * 0.5f);
    if (t * (t - 1) / 2 > q) --t;
    else if (t * (t + 1) / 2 <= q) ++t;
    const int tt = kSub * i + t, ss = kSub * i + q - t * (t - 1) / 2;
    const float *rt = R + tt * P, *et = CWE + tt * P;
    const float *ks = K + ss * P, *cs = CW + ss * P;
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n)
      acc = fmaf(rt[n] * ks[n], __expf(et[n] - cs[n]), acc);
    A[tt * P + ss] = acc;
  }
  for (int t = threadIdx.x; t < L; t += kChunkThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n)
      acc = fmaf(R[t * P + n] * U[n], K[t * P + n], acc);
    A[t * P + t] = acc;
  }
}

// A below the diagonal blocks for the thread's rows (sub-chunk ib >= 1):
// A[t][s] = sum_n qf[t][n] kf_ib[s][n] for s < 16 ib.
template <int L, int N>
__device__ __forceinline__ void lower_blocks_a(float* A, const float* QF,
                                               const float* KF, int m0,
                                               int tx, int ib) {
  using C = Chunk<L, N>;
  constexpr int P = C::P;
  float acc[C::TM][C::TL] = {};
  mac_cols<P, 1, P, 1>(ib, acc, QF, KF, m0, tx, 0, N);
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int c = 0; c < C::TL; ++c)
      if (c < ib) A[(m0 + a) * P + tx + 16 * c] = acc[a][c];
}

template <int L, int N>
constexpr size_t fwd_out_smem() {
  using C = Chunk<L, N>;
  // R K V CW CWE A, u, c_i
  return sizeof(float) * (6 * C::kTile + N + C::NB * N);
}

// The forward's output pass: CTA (b h, chunk c).
template <typename T, int L, int N>
__global__ void __launch_bounds__(kChunkThreads, 2)
    wkv_fwd_out(Tensor4 r, Tensor4 k, Tensor4 v, Tensor4 w, const float* u,
                const float* starts, float* out, int S, int H, int nc,
                int vec) {
  using C = Chunk<L, N>;
  constexpr int P = C::P, TM = C::TM, TN = C::TN, NB = C::NB;
  constexpr int SQ = N * N / kChunkThreads;
  extern __shared__ __align__(16) float sm[];
  float* R = sm;              // r, then qf = r e^{cwe - c_i}
  float* K = R + C::kTile;    // k, then kf_{NB-1}, then S_c
  float* V = K + C::kTile;
  float* CW = V + C::kTile;   // logw, cw, then kf_1 .. kf_{NB-2}
  float* CWE = CW + C::kTile; // cwe, then r e^{cwe}
  float* A = CWE + C::kTile;
  float* U = A + C::kTile;
  float* CB = U + N;          // c_i
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, t0 = c * L, tid = threadIdx.x;
  const int m0 = (tid / 16) * TM, tx = tid % 16, ib = m0 / kSub;

  float sreg[SQ];  // S_c, read now, stored once K is free
  const float* sg = starts + (static_cast<long long>(bh) * nc + c) * N * N;
#pragma unroll
  for (int q = 0; q < SQ; ++q) sreg[q] = sg[q * kChunkThreads + tid];
  for (int e = tid; e < L * P; e += kChunkThreads) A[e] = 0.f;
  load_tile<T, L, N, P>(R, head<T>(r, b, h), r.s1, r.s3, t0, S, vec);
  load_tile<T, L, N, P>(K, head<T>(k, b, h), k.s1, k.s3, t0, S, vec);
  load_tile<T, L, N, P>(V, head<T>(v, b, h), v.s1, v.s3, t0, S, vec);
  load_tile<float, L, N, P>(CW, head<float>(w, b, h), w.s1, w.s3, t0, S,
                            vec);
  if (tid < N) U[tid] = u[h * N + tid];
  __syncthreads();
  cumsums<L, N, P>(CW, CWE, CB);
  __syncthreads();
  diag_blocks_a<L, N>(A, R, K, CW, CWE, U);
  __syncthreads();
  {  // the factors, each element by its own thread; kf_m for m < NB - 1
     // goes to CW rows that other threads still read, so after a barrier
    float kfd[NB > 2 ? NB - 2 : 1][C::EL];
#pragma unroll
    for (int q = 0; q < C::EL; ++q) {
      const int x = q * C::RQ + tid / N, n = tid % N, i = x / kSub;
      const float rv = R[x * P + n], kv = K[x * P + n];
      const float cw = CW[x * P + n], cwe = CWE[x * P + n];
      if (i >= 1) R[x * P + n] = rv * __expf(cwe - CB[i * N + n]);
      CWE[x * P + n] = rv * __expf(cwe);
      if (NB > 1 && x < kSub * (NB - 1))
        K[x * P + n] = kv * __expf(CB[(NB - 1) * N + n] - cw);
#pragma unroll
      for (int m = 1; m <= NB - 2; ++m)
        if (q * C::RQ < kSub * m)
          kfd[m - 1][q] = kv * __expf(CB[m * N + n] - cw);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < C::EL; ++q) {
      const int x = q * C::RQ + tid / N, n = tid % N;
#pragma unroll
      for (int m = 1; m <= NB - 2; ++m)
        if (q * C::RQ < kSub * m)
          CW[(C::kf_row(m) + x) * P + n] = kfd[m - 1][q];
    }
  }
  __syncthreads();
  if (NB > 1 && ib >= 1)
    lower_blocks_a<L, N>(A, R, ib == NB - 1 ? K : CW + C::kf_row(ib) * P, m0,
                         tx, ib);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < SQ; ++q) {
    const int e = q * kChunkThreads + tid;
    K[(e / N) * P + e % N] = sreg[q];
  }
  __syncthreads();
  float acc[TM][TN] = {};
  mac<TN, P, 1, 1, P>(acc, A, V, m0, tx, 0, m0 + TM);    // A v
  mac<TN, P, 1, 1, P>(acc, CWE, K, m0, tx, 0, N);        // (r e^{cwe}) S_c
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int gt = t0 + m0 + a;
    if (gt < S) {
      float* o = out + ((static_cast<long long>(b) * S + gt) * H + h) * N + tx;
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) o[16 * cc] = acc[a][cc];
    }
  }
}

template <int L, int N>
constexpr size_t bwd_chunk_smem() {
  using C = Chunk<L, N>;
  // R K V DO CW CWE X6 X7 DA A QF, KF, u, c_i, rowsum(S0 dS), 2 x (16, N)
  return sizeof(float) * (11 * C::kTile + C::KF_ROWS * C::P + N +
                          C::NB * N + N + 2 * 16 * N);
}

// The backward's per-chunk gradients: CTA (b h, chunk c), from the chunk's
// start state (starts) and the gradient of its end state (dends).
template <typename T, int L, int N>
__global__ void __launch_bounds__(kChunkThreads, 1)
    wkv_bwd_chunk(Tensor4 r, Tensor4 k, Tensor4 v, Tensor4 w, const float* u,
                  Tensor4 dout, const float* starts, const float* dends,
                  T* dr, T* dk, T* dv, float* dw, float* du_part, int S,
                  int H, int nc, int vec) {
  using C = Chunk<L, N>;
  constexpr int P = C::P, TM = C::TM, TN = C::TN, TL = C::TL, NB = C::NB;
  extern __shared__ __align__(16) float sm[];
  float* R = sm;
  float* K = R + C::kTile;
  float* V = K + C::kTile;
  float* DO = V + C::kTile;
  float* CW = DO + C::kTile;
  float* CWE = CW + C::kTile;
  float* X6 = CWE + C::kTile;  // S0, then kd, then dr's diagonal blocks
  float* X7 = X6 + C::kTile;   // dS, then dk's diagonal blocks
  float* DA = X7 + C::kTile;   // dA = dO v^T, s <= t
  float* A = DA + C::kTile;
  float* QF = A + C::kTile;    // r e^{cwe - c_i} (sub-chunks 1 ..)
  float* KF = QF + C::kTile;   // k e^{c_i - cw} (rows before sub-chunk i)
  float* U = KF + C::KF_ROWS * P;
  float* CB = U + N;
  float* SD = CB + NB * N;     // rowsum(S0 dS)
  float* PA = SD + N;          // (16, N) partial sums
  float* PB = PA + 16 * N;
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, t0 = c * L, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16, m0 = ty * TM, ib = m0 / kSub;
  const long long bhc = static_cast<long long>(bh) * nc + c;

  for (int e = tid; e < L * P; e += kChunkThreads) A[e] = 0.f;
  load_tile<T, L, N, P>(R, head<T>(r, b, h), r.s1, r.s3, t0, S, vec);
  load_tile<T, L, N, P>(K, head<T>(k, b, h), k.s1, k.s3, t0, S, vec);
  load_tile<T, L, N, P>(V, head<T>(v, b, h), v.s1, v.s3, t0, S, vec);
  load_tile<float, L, N, P>(DO, head<float>(dout, b, h), dout.s1, dout.s3,
                            t0, S, vec);
  load_tile<float, L, N, P>(CW, head<float>(w, b, h), w.s1, w.s3, t0, S,
                            vec);
  load_state<N, P>(X6, starts + bhc * N * N);
  load_state<N, P>(X7, dends + bhc * N * N);
  if (tid < N) U[tid] = u[h * N + tid];
  __syncthreads();

  // cw, cwe; rowsum(S0 dS); dO S0^T, v dS^T; dA
  cumsums<L, N, P>(CW, CWE, CB);
  if (tid >= N && tid < 2 * N) {
    const int n = tid - N;
    float sd = 0.f;
    for (int j = 0; j < N; ++j) sd = fmaf(X6[n * P + j], X7[n * P + j], sd);
    SD[n] = sd;
  }
  float drd[TM][TN] = {}, dkd[TM][TN] = {};
  mac<TN, P, 1, P, 1>(drd, DO, X6, m0, tx, 0, N);
  mac<TN, P, 1, P, 1>(dkd, V, X7, m0, tx, 0, N);
  {
    float acc[TM][TL] = {};
    mac_cols<P, 1, P, 1>(ib + 1, acc, DO, V, m0, tx, 0, N);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int cc = 0; cc < TL; ++cc) {
        const int t = m0 + a, s = tx + 16 * cc;
        DA[t * P + s] = (cc <= ib && s <= t) ? acc[a][cc] : 0.f;
      }
  }
  __syncthreads();

  // kd, qf, kf_i; A's diagonal blocks
#pragma unroll
  for (int q = 0; q < C::EL; ++q) {
    const int x = q * C::RQ + tid / N, n = tid % N, i = x / kSub;
    const float rv = R[x * P + n], kv = K[x * P + n];
    const float cw = CW[x * P + n], cwe = CWE[x * P + n];
    X6[x * P + n] = kv * __expf(CW[(L - 1) * P + n] - cw);
    QF[x * P + n] = i >= 1 ? rv * __expf(cwe - CB[i * N + n]) : 0.f;
#pragma unroll
    for (int m = 1; m < NB; ++m)
      if (q * C::RQ < kSub * m)
        KF[(C::kf_row(m) + x) * P + n] = kv * __expf(CB[m * N + n] - cw);
  }
  diag_blocks_a<L, N>(A, R, K, CW, CWE, U);
  __syncthreads();

  // dv's state part kd dS; A below the diagonal blocks
  float dvv[TM][TN] = {};
  mac<TN, P, 1, 1, P>(dvv, X6, X7, m0, tx, 0, N);
  if (NB > 1 && ib >= 1)
    lower_blocks_a<L, N>(A, QF, KF + C::kf_row(ib) * P, m0, tx, ib);
  __syncthreads();

  // dv += A^T dO
  mac<TN, 1, P, 1, P>(dvv, A, DO, m0, tx, m0, L);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int gt = t0 + m0 + a;
    if (gt < S) {
      T* o = dv + ((static_cast<long long>(b) * S + gt) * H + h) * N + tx;
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) o[16 * cc] = from_f32<T>(dvv[a][cc]);
    }
  }
  // dr and dk within the diagonal blocks, one thread a (sub-chunk,
  // channel): dr_t += dA_ts k_s e, dk_s += dA_ts r_t e, e = e^{cwe_t - cw_s}
  if (tid < NB * N) {
    const int n = tid % N, base = kSub * (tid / N);
    float rv[kSub], kv[kSub], cwv[kSub], cwev[kSub];
    float drv[kSub] = {}, dkv[kSub] = {};
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      const int x = (base + t) * P + n;
      rv[t] = R[x], kv[t] = K[x], cwv[t] = CW[x], cwev[t] = CWE[x];
    }
#pragma unroll
    for (int t = 1; t < kSub; ++t)
#pragma unroll
      for (int s = 0; s < t; ++s) {
        const float e =
            __expf(cwev[t] - cwv[s]) * DA[(base + t) * P + base + s];
        drv[t] = fmaf(e, kv[s], drv[t]);
        dkv[s] = fmaf(e, rv[t], dkv[s]);
      }
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      X6[(base + t) * P + n] = drv[t];
      X7[(base + t) * P + n] = dkv[t];
    }
  }
  // dr and dk below the diagonal blocks: dr = qe (dA kf_ib) for the rows'
  // sub-chunk; dk = sum over later sub-chunks ip of ke_ip (dA^T qf)
  float dro[TM][TN] = {}, dko[TM][TN] = {};
  if (ib >= 1) {
    mac<TN, P, 1, 1, P>(dro, DA, KF + C::kf_row(ib) * P, m0, tx, 0,
                        kSub * ib);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) {
        const int t = m0 + a, n = tx + 16 * cc;
        dro[a][cc] *= __expf(CWE[t * P + n] - CB[ib * N + n]);
      }
  }
  for (int ip = ib + 1; ip < NB; ++ip) {
    float part[TM][TN] = {};
    mac<TN, 1, P, 1, P>(part, DA, QF, m0, tx, kSub * ip, kSub * (ip + 1));
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) {
        const int s = m0 + a, n = tx + 16 * cc;
        dko[a][cc] = fmaf(part[a][cc], __expf(CB[ip * N + n] - CW[s * P + n]),
                          dko[a][cc]);
      }
  }
  __syncthreads();

  // dr, dk; the exponents' gradients dcwe, dcw; du's and dcw_L's sums
  float dul[TN] = {}, cll[TN] = {};
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int t = m0 + a, gt = t0 + t;
    const float dda = DA[t * P + t];
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) {
      const int n = tx + 16 * cc, x = t * P + n;
      const float rv = R[x], kv = K[x], un = U[n];
      const float ecwe = __expf(CWE[x]);
      const float edk = __expf(CW[(L - 1) * P + n] - CW[x]), kd = kv * edk;
      const float dri = dro[a][cc] + X6[x], dki = dko[a][cc] + X7[x];
      const float rs = drd[a][cc] * ecwe;
      if (gt < S) {
        const long long o =
            ((static_cast<long long>(b) * S + gt) * H + h) * N + n;
        dr[o] = from_f32<T>(dri + dda * un * kv + rs);
        dk[o] = from_f32<T>(dki + dda * un * rv + dkd[a][cc] * edk);
      }
      dul[cc] = fmaf(dda * rv, kv, dul[cc]);
      cll[cc] = fmaf(dkd[a][cc], kd, cll[cc]);
      dro[a][cc] = rv * (dri + rs);                    // dcwe
      dko[a][cc] = -kv * dki - dkd[a][cc] * kd;        // dcw
    }
  }
#pragma unroll
  for (int cc = 0; cc < TN; ++cc) {
    PA[ty * N + tx + 16 * cc] = dul[cc];
    PB[ty * N + tx + 16 * cc] = cll[cc];
  }
  __syncthreads();
  float suf[TM][TN];
#pragma unroll
  for (int cc = 0; cc < TN; ++cc) {
    const int n = tx + 16 * cc;
    if (m0 + TM == L) {  // dcw_L, added to dcw at the chunk's last row
      float cl = 0.f;
      for (int q = 0; q < 16; ++q) cl += PB[q * N + n];
      dko[TM - 1][cc] += fmaf(__expf(CW[(L - 1) * P + n]), SD[n], cl);
    }
    if (ty == 0) {
      float du = 0.f;
      for (int q = 0; q < 16; ++q) du += PA[q * N + n];
      du_part[bhc * N + n] = du;
    }
    float run = 0.f;  // reverse sums of dcw + dcwe over the thread's rows
#pragma unroll
    for (int a = TM - 1; a >= 0; --a) {
      run += dko[a][cc] + dro[a][cc];
      suf[a][cc] = run;
    }
  }
  __syncthreads();
#pragma unroll
  for (int cc = 0; cc < TN; ++cc) PA[ty * N + tx + 16 * cc] = suf[0][cc];
  __syncthreads();
#pragma unroll
  for (int cc = 0; cc < TN; ++cc) {
    const int n = tx + 16 * cc;
    float later = 0.f;  // the row groups after this thread's
    for (int q = 15; q > ty; --q) later += PA[q * N + n];
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int gt = t0 + m0 + a;
      if (gt < S)
        dw[((static_cast<long long>(b) * S + gt) * H + h) * N + n] =
            (suf[a][cc] + later) - dro[a][cc];
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename F>
cudaError_t raise_smem(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Problem {
  Tensor4 r, k, v, w, dout;
  const float* u;
  float* out;
  float* state;
  float* starts;
  const float* dstate;
  float* dends;
  void *dr, *dk, *dv;
  float* dw;
  float* du_part;
  int B, S, H, nc, vec;
  cudaStream_t stream;
};

// Dynamic shared memory of the four kernels of one instantiation.
template <typename T, int L, int N>
struct Smem {
  static constexpr size_t kStateFwd = StateLayout<T, T, L, N>::kSmem;
  static constexpr size_t kStateBwd = StateLayout<T, float, L, N>::kSmem;
  static constexpr size_t kFwdOut = fwd_out_smem<L, N>();
  static constexpr size_t kBwdChunk = bwd_chunk_smem<L, N>();
  static_assert(kBwdChunk <= 232448 && kFwdOut <= 232448, "shared memory");
};

template <typename T, int L, int N>
cudaError_t forward(const Problem& p) {
  using M = Smem<T, L, N>;
  cudaError_t err = raise_smem(wkv_state<T, T, L, N, false>, M::kStateFwd);
  if (err == cudaSuccess) err = raise_smem(wkv_fwd_out<T, L, N>, M::kFwdOut);
  if (err != cudaSuccess) return err;
  wkv_state<T, T, L, N, false>
      <<<dim3(p.B * p.H, N / kStateCols), kStateThreads, M::kStateFwd,
         p.stream>>>(p.k, p.w, p.v, nullptr, p.starts, p.state, p.S, p.H,
                     p.nc, p.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_fwd_out<T, L, N><<<p.B * p.H * p.nc, kChunkThreads, M::kFwdOut,
                         p.stream>>>(p.r, p.k, p.v, p.w, p.u, p.starts,
                                     p.out, p.S, p.H, p.nc, p.vec);
  return cudaGetLastError();
}

template <typename T, int L, int N>
cudaError_t backward(const Problem& p) {
  using M = Smem<T, L, N>;
  cudaError_t err = raise_smem(wkv_state<T, float, L, N, true>, M::kStateBwd);
  if (err == cudaSuccess)
    err = raise_smem(wkv_bwd_chunk<T, L, N>, M::kBwdChunk);
  if (err != cudaSuccess) return err;
  wkv_state<T, float, L, N, true>
      <<<dim3(p.B * p.H, N / kStateCols), kStateThreads, M::kStateBwd,
         p.stream>>>(p.r, p.w, p.dout, p.dstate, p.dends, nullptr, p.S, p.H,
                     p.nc, p.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_chunk<T, L, N><<<p.B * p.H * p.nc, kChunkThreads, M::kBwdChunk,
                           p.stream>>>(
      p.r, p.k, p.v, p.w, p.u, p.dout, p.starts, p.dends,
      static_cast<T*>(p.dr), static_cast<T*>(p.dk), static_cast<T*>(p.dv),
      p.dw, p.du_part, p.S, p.H, p.nc, p.vec);
  return cudaGetLastError();
}

// Per kernel (state forward, forward output, state backward, backward
// chunk): threads, dynamic shared memory, registers a thread, local
// (spill) bytes a thread, resident CTAs an SM.
template <typename F>
cudaError_t info_of(F kernel, int threads, size_t smem, int* out) {
  cudaError_t err = raise_smem(kernel, smem);
  cudaFuncAttributes a{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, smem);
  out[0] = threads;
  out[1] = static_cast<int>(smem);
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = ctas;
  return err;
}

template <typename T, int L, int N>
cudaError_t info(int* out) {
  using M = Smem<T, L, N>;
  const cudaError_t e[4] = {
      info_of(wkv_state<T, T, L, N, false>, kStateThreads, M::kStateFwd, out),
      info_of(wkv_fwd_out<T, L, N>, kChunkThreads, M::kFwdOut, out + 5),
      info_of(wkv_state<T, float, L, N, true>, kStateThreads, M::kStateBwd,
              out + 10),
      info_of(wkv_bwd_chunk<T, L, N>, kChunkThreads, M::kBwdChunk, out + 15)};
  for (cudaError_t x : e)
    if (x != cudaSuccess) return x;
  return cudaSuccess;
}

enum Op { kForward, kBackward, kInfo };

template <Op op, typename T, int L, int N>
cudaError_t run(const Problem& p, int* out) {
  if constexpr (op == kForward) return forward<T, L, N>(p);
  else if constexpr (op == kBackward) return backward<T, L, N>(p);
  else return info<T, L, N>(out);
}

template <Op op, typename T, int L>
cudaError_t by_head_size(const Problem& p, int n, int* out) {
  switch (n) {
    case 16: return run<op, T, L, 16>(p, out);
    case 32: return run<op, T, L, 32>(p, out);
    case 64: return run<op, T, L, 64>(p, out);
    default: return cudaErrorInvalidValue;
  }
}

template <Op op, typename T>
cudaError_t by_chunk(const Problem& p, int chunk, int n, int* out) {
  switch (chunk) {
    case 16: return by_head_size<op, T, 16>(p, n, out);
    case 32: return by_head_size<op, T, 32>(p, n, out);
    case 64: return by_head_size<op, T, 64>(p, n, out);
    default: return cudaErrorInvalidValue;
  }
}

template <Op op>
cudaError_t dispatch(const Problem& p, int dtype, int chunk, int n,
                     int* out = nullptr) {
  if (dtype == kBF16) return by_chunk<op, __nv_bfloat16>(p, chunk, n, out);
  if (dtype == kF32) return by_chunk<op, float>(p, chunk, n, out);
  return cudaErrorInvalidValue;
}

Tensor4 tensor4(const void* ptr, const long long* st) {
  return {ptr, st[0], st[1], st[2], st[3]};
}

// Rows of 16-byte aligned, contiguous columns: every 16-byte load in reach
bool aligned16(const Tensor4& t, int esz) {
  const long long per = 16 / esz;
  return t.s3 == 1 && reinterpret_cast<uintptr_t>(t.ptr) % 16 == 0 &&
         t.s0 % per == 0 && t.s1 % per == 0 && t.s2 % per == 0;
}

}  // namespace

// Plain C interface for ctypes.  r, k, v (B, S, H, N) in ``dtype``, logw
// (B, S, H, N) fp32, each with four element strides; u (H, N) fp32
// contiguous.  Writes out (B, S, H, N) and state (B, H, N, N), fp32
// contiguous, and the state at the start of each chunk to ``chunk_states``
// (B, H, ceil(S / chunk), N, N) (kept for the backward, or scratch).  Two
// launches on ``stream`` (the state pass, the output pass), no
// synchronisation; returns cudaGetLastError() (the caller raises on
// anything but 0).  chunk and N must be 16, 32 or 64.
extern "C" int repro_wkv_fwd(const void* r, const long long* r_st,
                             const void* k, const long long* k_st,
                             const void* v, const long long* v_st,
                             const float* w, const long long* w_st,
                             const float* u, float* out, float* state,
                             float* chunk_states, int dtype, int B, int S,
                             int H, int N, int chunk, void* stream) {
  Problem p{};
  p.r = tensor4(r, r_st);
  p.k = tensor4(k, k_st);
  p.v = tensor4(v, v_st);
  p.w = tensor4(w, w_st);
  p.u = u;
  p.out = out;
  p.state = state;
  p.starts = chunk_states;
  p.B = B;
  p.S = S;
  p.H = H;
  p.nc = (S + chunk - 1) / chunk;
  const int esz = dtype == kBF16 ? 2 : 4;
  p.vec = aligned16(p.r, esz) && aligned16(p.k, esz) &&
          aligned16(p.v, esz) && aligned16(p.w, 4);
  p.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<kForward>(p, dtype, chunk, N));
}

// The backward: the forward's inputs, dout (B, S, H, N) fp32 strided, the
// forward's chunk-start states, dstate (B, H, N, N) fp32 contiguous or
// null (zero), and scratch ``chunk_dends`` (B, H, nc, N, N) fp32 for the
// gradient of each chunk's end state.  Writes dr, dk, dv (B, S, H, N)
// contiguous in ``dtype``, dlogw (B, S, H, N) fp32 contiguous and du_part
// (B, H, nc, N) fp32, each (b, h, chunk)'s share of du.  Two launches (the
// reverse state pass, the per-chunk gradients).
extern "C" int repro_wkv_bwd(const void* r, const long long* r_st,
                             const void* k, const long long* k_st,
                             const void* v, const long long* v_st,
                             const float* w, const long long* w_st,
                             const float* u, const float* dout,
                             const long long* do_st,
                             const float* chunk_states, const float* dstate,
                             float* chunk_dends, void* dr, void* dk, void* dv,
                             float* dw, float* du_part, int dtype, int B,
                             int S, int H, int N, int chunk, void* stream) {
  Problem p{};
  p.r = tensor4(r, r_st);
  p.k = tensor4(k, k_st);
  p.v = tensor4(v, v_st);
  p.w = tensor4(w, w_st);
  p.dout = tensor4(dout, do_st);
  p.u = u;
  p.starts = const_cast<float*>(chunk_states);
  p.dstate = dstate;
  p.dends = chunk_dends;
  p.dr = dr;
  p.dk = dk;
  p.dv = dv;
  p.dw = dw;
  p.du_part = du_part;
  p.B = B;
  p.S = S;
  p.H = H;
  p.nc = (S + chunk - 1) / chunk;
  const int esz = dtype == kBF16 ? 2 : 4;
  p.vec = aligned16(p.r, esz) && aligned16(p.k, esz) &&
          aligned16(p.v, esz) && aligned16(p.w, 4) && aligned16(p.dout, 4);
  p.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<kBackward>(p, dtype, chunk, N));
}

// The design's constants: sub-chunk rows, value columns and threads of a
// state-pass CTA, threads of a per-chunk CTA.
extern "C" void repro_wkv_design(int* out) {
  out[0] = kSub;
  out[1] = kStateCols;
  out[2] = kStateThreads;
  out[3] = kChunkThreads;
}

// For the instantiation (dtype, chunk, N), five ints per kernel (state
// forward, forward output, state backward, backward chunk): threads,
// dynamic shared memory bytes, registers a thread, local (spill) bytes a
// thread, resident CTAs an SM.
extern "C" int repro_wkv_info(int dtype, int chunk, int N, int* out) {
  Problem p{};
  return static_cast<int>(dispatch<kInfo>(p, dtype, chunk, N, out));
}
