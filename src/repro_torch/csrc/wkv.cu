// Chunked RWKV6 WKV, forward and backward, for Hopper (sm_90a).
//
// Per (batch b, head h), from a zero (N, N) state S, over positions t:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t.
// In chunks of L positions (cw = cumsum(logw), cwe = cw - logw in the
// chunk, all fp32):
//   A[t, s] = sum_n r[t, n] k[s, n] exp(cwe[t, n] - cw[s, n])  (s < t),
//   A[t, t] = sum_n r[t, n] u[n] k[t, n],
//   o       = A v + (r exp(cwe)) S,
//   S      <- exp(cw_L) S + (k exp(cw_L - cw))^T v.
// Every exponent taken is <= 0, so no decay, however strong, overflows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv.py::wkv_pallas
// (body _wkv_kernel): the same chunked form, the same order of operations.
// The TPU kernel walks the chunks along a sequential grid axis and carries
// S in VMEM scratch from one grid step to the next; GPU blocks run in no
// order, so here one CTA owns one (b, h) and loops over the chunks itself,
// S resident in shared memory.  The reference's wrapper folds heads into
// the batch and pads S to a multiple of L (ops.py _wkv_impl); this kernel
// reads r, k, v and logw (B, S, H, N) through their strides and masks the
// ragged last chunk (logw = 0, k = 0 past S), so neither copy is written.
// The forward can also write the state at the start of every chunk, which
// the backward reads.
//
// The TPU kernel has no backward: the reference trains rwkv by autodiff of
// its XLA chunked form.  The port trains through this kernel, so the
// gradient is here too, in closed form (kernels/ref.py::wkv_bwd_plain):
// one CTA per (b, h) sweeps the chunks in reverse with dS, the gradient of
// the chunk's final state, in shared memory, recomputes A and the decays
// from the saved chunk-start state, and writes dr, dk, dv, dlogw and its
// (b, h) share of du (the wrapper sums du over b).  No atomics, so the
// result does not depend on timing.
//
// What bounds it on an H100: at the training shape (B 2, S 2048, H 40,
// N 64, L 64) the forward moves 148 MB (bf16 r/k/v, fp32 logw and out):
// 0.044 ms at 3.35 TB/s, against ~6 GFLOP of dense L x L and N x N tile
// products and ~6.7e8 exponentials, so bytes bound it.  This first kernel
// runs the tile products on the FP32 FMA pipe from padded shared-memory
// tiles, one CTA of 256 threads per (b, h): 80 CTAs at the training shape,
// so 52 of the 132 SMs idle, and the pairwise decay takes one __expf per
// (t, s, n) below the diagonal (three times that in the backward, which
// recomputes it for A, dr and dk).  A CTA per (b, h, block of value
// columns) and tensor-core tiles are later work.  Shared-memory rows are
// padded by one float so that a warp reading a tile along either axis
// hits 32 distinct banks.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

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

// Chunk rows [t0, t0 + L) of one head as fp32 into dst[t * (N + 1) + n];
// rows at or past S load zeros (the mask that makes the padding a no-op).
template <typename T, int L, int N>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Tensor4& t, int t0, int S) {
  for (int e = threadIdx.x; e < L * N; e += kThreads) {
    const int row = e / N, n = e % N, gt = t0 + row;
    dst[row * (N + 1) + n] = gt < S ? to_f32(src[gt * t.s1 + n * t.s3]) : 0.f;
  }
}

// In place over a tile of logw: cw = inclusive cumsum over the chunk's
// rows, cwe = cw - logw, one thread per channel.
template <int L, int N>
__device__ __forceinline__ void cumsum_rows(float* cw, float* cwe) {
  constexpr int NP = N + 1;
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float c = 0.f;
    for (int t = 0; t < L; ++t) {
      const float w = cw[t * NP + n];
      c += w;
      cw[t * NP + n] = c;
      cwe[t * NP + n] = c - w;
    }
  }
}

// A[t * (L + 1) + s] for one chunk: the pairwise-decayed r.k below the
// diagonal, the u-weighted r.k on it, zero above.  Thread (s, g) owns the
// rows g, g + L/..., so a warp reads r and cwe as broadcasts and k and cw
// along s.
template <int L, int N>
__device__ __forceinline__ void build_a(float* A, const float* R,
                                        const float* K, const float* CW,
                                        const float* CWE, const float* U) {
  constexpr int NP = N + 1, LP = L + 1;
  constexpr int RG = kThreads / L, RA = L / RG;
  const int s = threadIdx.x % L, g = threadIdx.x / L;
  float acc[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) acc[i] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float ks = K[s * NP + n], cs = CW[s * NP + n], un = U[n];
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int t = g + i * RG;
      const float rt = R[t * NP + n];
      if (s < t)
        acc[i] += rt * __expf(CWE[t * NP + n] - cs) * ks;
      else if (s == t)
        acc[i] += rt * un * ks;
    }
  }
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int t = g + i * RG;
    A[t * LP + s] = s <= t ? acc[i] : 0.f;
  }
}

template <int L, int N>
constexpr size_t fwd_smem() {
  // R K V CW CWE (L x N+1), A (L x L+1), S (N x N+1), u (N)
  return sizeof(float) *
         (5 * L * (N + 1) + L * (L + 1) + N * (N + 1) + N);
}

template <typename T, int L, int N>
__global__ void __launch_bounds__(kThreads)
    wkv_fwd(Tensor4 r, Tensor4 k, Tensor4 v, Tensor4 w, const float* u,
            float* out, float* state_out, float* chunk_states, int S, int H) {
  static_assert(kThreads % L == 0 && L % (kThreads / L) == 0, "chunk");
  static_assert(kThreads % N == 0 && N % (kThreads / N) == 0 &&
                    L % (kThreads / N) == 0,
                "head size");
  constexpr int NP = N + 1, LP = L + 1;
  constexpr int OG = kThreads / N;  // row groups of an (., N) output
  extern __shared__ float sm[];
  float* R = sm;              // r, then r * exp(cwe)
  float* K = R + L * NP;      // k, then k * exp(cw_L - cw)
  float* V = K + L * NP;
  float* CW = V + L * NP;     // logw, then its cumsum
  float* CWE = CW + L * NP;
  float* A = CWE + L * NP;    // (L, L + 1)
  float* St = A + L * LP;     // (N, N + 1)
  float* U = St + N * NP;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int j = tid % N, g = tid / N;  // (row group, column) of N-wide work
  const T* rp = head<T>(r, b, h);
  const T* kp = head<T>(k, b, h);
  const T* vp = head<T>(v, b, h);
  const float* wp = head<float>(w, b, h);
  for (int e = tid; e < N * NP; e += kThreads) St[e] = 0.f;
  for (int e = tid; e < N; e += kThreads) U[e] = u[h * N + e];
  const int nc = (S + L - 1) / L;
  const long long bh = static_cast<long long>(blockIdx.x);
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    if (chunk_states != nullptr) {
      float* dst = chunk_states + (bh * nc + c) * N * N;
      for (int e = tid; e < N * N; e += kThreads)
        dst[e] = St[(e / N) * NP + e % N];
    }
    load_tile<T, L, N>(R, rp, r, t0, S);
    load_tile<T, L, N>(K, kp, k, t0, S);
    load_tile<T, L, N>(V, vp, v, t0, S);
    load_tile<float, L, N>(CW, wp, w, t0, S);
    __syncthreads();
    cumsum_rows<L, N>(CW, CWE);
    __syncthreads();
    build_a<L, N>(A, R, K, CW, CWE, U);
    __syncthreads();
    for (int e = tid; e < L * N; e += kThreads) {
      const int t = e / N, n = e % N;
      R[t * NP + n] *= __expf(CWE[t * NP + n]);
      K[t * NP + n] *= __expf(CW[(L - 1) * NP + n] - CW[t * NP + n]);
    }
    __syncthreads();
    // o[t][j] = sum_s A[t][s] v[s][j] + sum_n rd[t][n] S[n][j]
    {
      constexpr int RO = L / OG;
      float acc[RO];
#pragma unroll
      for (int i = 0; i < RO; ++i) acc[i] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float vs = V[s * NP + j];
#pragma unroll
        for (int i = 0; i < RO; ++i) acc[i] += A[(g + i * OG) * LP + s] * vs;
      }
      for (int n = 0; n < N; ++n) {
        const float sn = St[n * NP + j];
#pragma unroll
        for (int i = 0; i < RO; ++i) acc[i] += R[(g + i * OG) * NP + n] * sn;
      }
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const int gt = t0 + g + i * OG;
        if (gt < S) out[((static_cast<long long>(b) * S + gt) * H + h) * N + j] =
            acc[i];
      }
    }
    __syncthreads();
    // S[n][j] = exp(cw_L[n]) S[n][j] + sum_t kd[t][n] v[t][j]
    {
      constexpr int RS = N / OG;
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int n = g + i * OG;
        float acc = __expf(CW[(L - 1) * NP + n]) * St[n * NP + j];
        for (int t = 0; t < L; ++t) acc += K[t * NP + n] * V[t * NP + j];
        St[n * NP + j] = acc;
      }
    }
    __syncthreads();
  }
  float* so = state_out + bh * N * N;
  for (int e = tid; e < N * N; e += kThreads) so[e] = St[(e / N) * NP + e % N];
}

template <int L, int N>
constexpr size_t bwd_smem() {
  // R K V DO CW CWE RD KD GC (L x N+1), A/GE (L x max(L, N)+1),
  // dA (L x L+1), S0 dS (N x N+1), u, dcw_L (N), partial sums (256)
  return sizeof(float) *
         (9 * L * (N + 1) + L * ((L > N ? L : N) + 1) + L * (L + 1) +
          2 * N * (N + 1) + 2 * N + kThreads);
}

template <typename T, int L, int N>
__global__ void __launch_bounds__(kThreads)
    wkv_bwd(Tensor4 r, Tensor4 k, Tensor4 v, Tensor4 w, const float* u,
            Tensor4 dout, const float* chunk_states, const float* dstate,
            T* dr, T* dk, T* dv, float* dw, float* du_part, int S, int H) {
  constexpr int NP = N + 1, LP = L + 1;
  constexpr int OG = kThreads / N, RO = L / OG, RS = N / OG;
  extern __shared__ float sm[];
  float* R = sm;
  float* K = R + L * NP;
  float* V = K + L * NP;
  float* DO = V + L * NP;
  float* CW = DO + L * NP;
  float* CWE = CW + L * NP;
  float* RD = CWE + L * NP;   // r * exp(cwe)
  float* KD = RD + L * NP;    // k * exp(cw_L - cw)
  float* GC = KD + L * NP;    // d loss / d cw (without the cw_L term)
  float* A = GC + L * NP;     // A, then d loss / d cwe (stride N + 1)
  float* DA = A + L * ((L > N ? L : N) + 1);
  float* S0 = DA + L * LP;    // state at the chunk's start
  float* DS = S0 + N * NP;    // gradient of the state at the chunk's end
  float* U = DS + N * NP;
  float* DCWL = U + N;
  float* PART = DCWL + N;     // (OG, N) partial sums of dcw_L
  float* GE = A;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int col = tid % N, g = tid / N;
  const T* rp = head<T>(r, b, h);
  const T* kp = head<T>(k, b, h);
  const T* vp = head<T>(v, b, h);
  const float* wp = head<float>(w, b, h);
  const float* dop = head<float>(dout, b, h);
  const long long bh = static_cast<long long>(blockIdx.x);
  const int nc = (S + L - 1) / L;
  for (int e = tid; e < N * N; e += kThreads)
    DS[(e / N) * NP + e % N] = dstate != nullptr ? dstate[bh * N * N + e] : 0.f;
  for (int e = tid; e < N; e += kThreads) U[e] = u[h * N + e];
  float du_acc = 0.f;  // thread n < N: this (b, h)'s share of du[h][n]
  __syncthreads();

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * L;
    load_tile<T, L, N>(R, rp, r, t0, S);
    load_tile<T, L, N>(K, kp, k, t0, S);
    load_tile<T, L, N>(V, vp, v, t0, S);
    load_tile<float, L, N>(DO, dop, dout, t0, S);
    load_tile<float, L, N>(CW, wp, w, t0, S);
    {
      const float* src = chunk_states + (bh * nc + c) * N * N;
      for (int e = tid; e < N * N; e += kThreads)
        S0[(e / N) * NP + e % N] = src[e];
    }
    __syncthreads();
    cumsum_rows<L, N>(CW, CWE);
    __syncthreads();
    // RD, KD; A; dA[t][s] = sum_j dO[t][j] v[s][j] for s <= t
    for (int e = tid; e < L * N; e += kThreads) {
      const int t = e / N, n = e % N;
      RD[t * NP + n] = R[t * NP + n] * __expf(CWE[t * NP + n]);
      KD[t * NP + n] =
          K[t * NP + n] * __expf(CW[(L - 1) * NP + n] - CW[t * NP + n]);
    }
    build_a<L, N>(A, R, K, CW, CWE, U);
    {
      constexpr int RG = kThreads / L, RA = L / RG;
      const int s = tid % L, gs = tid / L;
      float acc[RA];
#pragma unroll
      for (int i = 0; i < RA; ++i) acc[i] = 0.f;
      for (int jj = 0; jj < N; ++jj) {
        const float vs = V[s * NP + jj];
#pragma unroll
        for (int i = 0; i < RA; ++i) acc[i] += DO[(gs + i * RG) * NP + jj] * vs;
      }
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int t = gs + i * RG;
        DA[t * LP + s] = s <= t ? acc[i] : 0.f;
      }
    }
    __syncthreads();
    // dv[s][j] = sum_{t >= s} A[t][s] dO[t][j] + sum_n kd[s][n] dS[n][j]
    {
      float acc[RO];
#pragma unroll
      for (int i = 0; i < RO; ++i) acc[i] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float dot = DO[t * NP + col];
#pragma unroll
        for (int i = 0; i < RO; ++i) acc[i] += A[t * LP + g + i * OG] * dot;
      }
      for (int n = 0; n < N; ++n) {
        const float dsn = DS[n * NP + col];
#pragma unroll
        for (int i = 0; i < RO; ++i) acc[i] += KD[(g + i * OG) * NP + n] * dsn;
      }
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const int gt = t0 + g + i * OG;
        if (gt < S)
          dv[((static_cast<long long>(b) * S + gt) * H + h) * N + col] =
              from_f32<T>(acc[i]);
      }
    }
    __syncthreads();  // A is read for the last time above; GE reuses it
    // dr (thread (t, n)): the pairwise part through k, the bonus part, the
    // state part through dO S0^T; and dcwe, the gradient of cwe
    {
      const int n = col;
      float intra[RO], drd[RO], cwe_t[RO];
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        intra[i] = 0.f;
        drd[i] = 0.f;
        cwe_t[i] = CWE[(g + i * OG) * NP + n];
      }
      for (int s = 0; s < L; ++s) {
        const float ks = K[s * NP + n], cs = CW[s * NP + n];
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          const int t = g + i * OG;
          if (s < t) intra[i] += DA[t * LP + s] * ks * __expf(cwe_t[i] - cs);
        }
      }
      for (int jj = 0; jj < N; ++jj) {
        const float s0 = S0[n * NP + jj];
#pragma unroll
        for (int i = 0; i < RO; ++i) drd[i] += DO[(g + i * OG) * NP + jj] * s0;
      }
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const int t = g + i * OG;
        const float state_part = drd[i] * __expf(cwe_t[i]);
        GE[t * NP + n] = R[t * NP + n] * (intra[i] + state_part);
        const int gt = t0 + t;
        if (gt < S)
          dr[((static_cast<long long>(b) * S + gt) * H + h) * N + n] =
              from_f32<T>(intra[i] + DA[t * LP + t] * U[n] * K[t * NP + n] +
                          state_part);
      }
    }
    // dk (thread (s, n)): the pairwise part through r, the bonus part, the
    // state part through v dS^T; and dcw, the gradient of cw
    {
      const int n = col;
      float intra[RO], dkd[RO], cw_s[RO];
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        intra[i] = 0.f;
        dkd[i] = 0.f;
        cw_s[i] = CW[(g + i * OG) * NP + n];
      }
      for (int t = 0; t < L; ++t) {
        const float rt = R[t * NP + n], ct = CWE[t * NP + n];
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          const int s = g + i * OG;
          if (s < t) intra[i] += DA[t * LP + s] * rt * __expf(ct - cw_s[i]);
        }
      }
      for (int jj = 0; jj < N; ++jj) {
        const float dsn = DS[n * NP + jj];
#pragma unroll
        for (int i = 0; i < RO; ++i) dkd[i] += V[(g + i * OG) * NP + jj] * dsn;
      }
      const float cwl = CW[(L - 1) * NP + n];
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const int s = g + i * OG;
        const float kd = KD[s * NP + n];
        GC[s * NP + n] = -K[s * NP + n] * intra[i] - dkd[i] * kd;
        part += dkd[i] * kd;
        const int gt = t0 + s;
        if (gt < S)
          dk[((static_cast<long long>(b) * S + gt) * H + h) * N + n] =
              from_f32<T>(intra[i] + DA[s * LP + s] * U[n] * R[s * NP + n] +
                          dkd[i] * __expf(cwl - cw_s[i]));
      }
      PART[g * N + n] = part;
    }
    // du and the state term of dcw_L, one thread per channel
    if (tid < N) {
      const int n = tid;
      for (int t = 0; t < L; ++t)
        du_acc += DA[t * LP + t] * R[t * NP + n] * K[t * NP + n];
      float sd = 0.f;
      for (int jj = 0; jj < N; ++jj) sd += S0[n * NP + jj] * DS[n * NP + jj];
      DCWL[n] = __expf(CW[(L - 1) * NP + n]) * sd;
    }
    __syncthreads();
    // dlogw by reverse cumulative sums (thread n < N), and the state
    // gradient carried to the previous chunk (thread (n, j))
    if (tid < N) {
      const int n = tid;
      float acc_c = DCWL[n];
      for (int q = 0; q < OG; ++q) acc_c += PART[q * N + n];
      float acc_e = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        acc_c += GC[t * NP + n];
        const int gt = t0 + t;
        if (gt < S)
          dw[((static_cast<long long>(b) * S + gt) * H + h) * N + n] =
              acc_c + acc_e;
        acc_e += GE[t * NP + n];
      }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int n = g + i * OG;
      float acc = __expf(CW[(L - 1) * NP + n]) * DS[n * NP + col];
      for (int t = 0; t < L; ++t) acc += RD[t * NP + n] * DO[t * NP + col];
      DS[n * NP + col] = acc;
    }
    __syncthreads();
  }
  if (tid < N) du_part[bh * N + tid] = du_acc;
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Problem {
  Tensor4 r, k, v, w, dout;
  const float* u;
  float* out;
  float* state;
  float* chunk_states;
  const float* dstate;
  void *dr, *dk, *dv;
  float* dw;
  float* du_part;
  int B, S, H;
  cudaStream_t stream;
};

template <typename T, int L, int N>
cudaError_t forward(const Problem& p) {
  cudaError_t err = raise_smem(wkv_fwd<T, L, N>, fwd_smem<L, N>());
  if (err != cudaSuccess) return err;
  wkv_fwd<T, L, N><<<p.B * p.H, kThreads, fwd_smem<L, N>(), p.stream>>>(
      p.r, p.k, p.v, p.w, p.u, p.out, p.state, p.chunk_states, p.S, p.H);
  return cudaGetLastError();
}

template <typename T, int L, int N>
cudaError_t backward(const Problem& p) {
  cudaError_t err = raise_smem(wkv_bwd<T, L, N>, bwd_smem<L, N>());
  if (err != cudaSuccess) return err;
  wkv_bwd<T, L, N><<<p.B * p.H, kThreads, bwd_smem<L, N>(), p.stream>>>(
      p.r, p.k, p.v, p.w, p.u, p.dout, p.chunk_states, p.dstate,
      static_cast<T*>(p.dr), static_cast<T*>(p.dk), static_cast<T*>(p.dv),
      p.dw, p.du_part, p.S, p.H);
  return cudaGetLastError();
}

template <bool kBackward, typename T, int L>
cudaError_t by_head_size(const Problem& p, int n) {
  switch (n) {
    case 16: return kBackward ? backward<T, L, 16>(p) : forward<T, L, 16>(p);
    case 32: return kBackward ? backward<T, L, 32>(p) : forward<T, L, 32>(p);
    case 64: return kBackward ? backward<T, L, 64>(p) : forward<T, L, 64>(p);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward, typename T>
cudaError_t by_chunk(const Problem& p, int chunk, int n) {
  switch (chunk) {
    case 16: return by_head_size<kBackward, T, 16>(p, n);
    case 32: return by_head_size<kBackward, T, 32>(p, n);
    case 64: return by_head_size<kBackward, T, 64>(p, n);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward>
cudaError_t dispatch(const Problem& p, int dtype, int chunk, int n) {
  if (dtype == kBF16) return by_chunk<kBackward, __nv_bfloat16>(p, chunk, n);
  if (dtype == kF32) return by_chunk<kBackward, float>(p, chunk, n);
  return cudaErrorInvalidValue;
}

Tensor4 tensor4(const void* ptr, const long long* st) {
  return {ptr, st[0], st[1], st[2], st[3]};
}

}  // namespace

// Plain C interface for ctypes.  r, k, v (B, S, H, N) in ``dtype``, logw
// (B, S, H, N) fp32, each with four element strides; u (H, N) fp32
// contiguous.  Writes out (B, S, H, N) and state (B, H, N, N), fp32
// contiguous, and, where ``chunk_states`` is not null, the state at the
// start of each chunk (B, H, ceil(S / chunk), N, N).  Launches on
// ``stream``, does not synchronise, returns cudaGetLastError() (the caller
// raises on anything but 0).  chunk and N must be 16, 32 or 64.
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
  p.chunk_states = chunk_states;
  p.B = B;
  p.S = S;
  p.H = H;
  p.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<false>(p, dtype, chunk, N));
}

// The backward: the forward's inputs, dout (B, S, H, N) fp32 strided, the
// forward's chunk-start states, and dstate (B, H, N, N) fp32 contiguous or
// null (zero).  Writes dr, dk, dv (B, S, H, N) contiguous in ``dtype``,
// dlogw (B, S, H, N) fp32 contiguous and du_part (B, H, N) fp32, each
// (b, h)'s share of du.  One launch.
extern "C" int repro_wkv_bwd(const void* r, const long long* r_st,
                             const void* k, const long long* k_st,
                             const void* v, const long long* v_st,
                             const float* w, const long long* w_st,
                             const float* u, const float* dout,
                             const long long* do_st,
                             const float* chunk_states, const float* dstate,
                             void* dr, void* dk, void* dv, float* dw,
                             float* du_part, int dtype, int B, int S, int H,
                             int N, int chunk, void* stream) {
  Problem p{};
  p.r = tensor4(r, r_st);
  p.k = tensor4(k, k_st);
  p.v = tensor4(v, v_st);
  p.w = tensor4(w, w_st);
  p.dout = tensor4(dout, do_st);
  p.u = u;
  p.chunk_states = const_cast<float*>(chunk_states);
  p.dstate = dstate;
  p.dr = dr;
  p.dk = dk;
  p.dv = dv;
  p.dw = dw;
  p.du_part = du_part;
  p.B = B;
  p.S = S;
  p.H = H;
  p.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<true>(p, dtype, chunk, N));
}
