// Kernel B6: the Mamba-2 SSD chunked scan (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` of the reference
// (src/repro/kernels/ssd_scan.py:28) and computes what it computes, with
// the chain axis the models fold in: x [C, b, S, H, P] (float32 or bf16),
// dt [C, b, S, H], A [C, H], B and C [C, b, S, N] (float32; B and C shared
// by the heads, one group).  For each (chain, batch row, head) the state
// starts at zero and
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t (x) B_t,    y_t = C_t . h_t,
// accumulated in float32; y comes out in x's type.  Row r of the b rows of
// chain c reads A[c], as B7 finds its weight's chain.
//
// The chunk algebra (chunks of L <= 64 steps, cum the running sum of A dt
// inside a chunk):
//   y   = ((C B^T) o M) x + exp(cum) o (C h0^T),
//         M[t, s] = exp(cum_t - cum_s) dt_s for s <= t, else 0;
//   h1  = h0 exp(cum_last) + (x o w)^T B,   w_s = exp(cum_last - cum_s) dt_s.
// Above the diagonal cum_t - cum_s is positive and its exponent may be
// +inf; it is never computed (a select, as the reference's `where`), so no
// inf * 0 = NaN.  The TPU route pads S to a multiple of L with zeros: a
// padded step has dt = 0, decays by 1 and carries nothing, so the last
// chunk here is simply shorter and nothing is padded.
//
// Design (a simple kernel, right first): one CTA of 256 threads (a 16 x 16
// grid) per (chain * batch row, head), walking the chunks in order.  The
// [P, N] state (64 x 128 float32, 32 KB at mamba2-1.3b) stays in shared
// memory across chunks; each chunk's x (as float32), dt, B and C are
// staged in shared memory; the L x L decayed score matrix is formed there
// for s <= t.  Each thread computes a 4 x 4 tile of the score matrix and
// of y, and a 4 x 8 tile of the state update, from shared memory, rows
// padded by one float (no bank conflicts across a warp's 16 columns).
// Products accumulate through explicit fmaf (the build's --fmad=false
// leaves explicit fmaf alone).  About 130 KB of shared memory at N = 128,
// dynamic, its limit raised on every launch (it belongs to the device).
//
// Bound: the chunk algebra's float32 operations on CUDA cores, at
// mamba2-1.3b about 2.4 MFLOP per full chunk and head plus 0.53 MFLOP per
// chunk and row for G = C B^T, which the heads share; the bytes (x and y,
// B, C, dt) take a tenth of that time.  This kernel forms G again in every
// head's CTA.  Tensor cores (wgmma), TMA staging, and computing G once per
// (batch row, chunk) rather than once per head are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGrid = 16;                  // threads along each tile axis
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxChunk = 64;              // L
constexpr int kMaxHeadDim = 64;            // P
constexpr int kMaxState = 128;             // N
constexpr int kTL = kMaxChunk / kGrid;     // rows of t (or s) a thread
constexpr int kTP = kMaxHeadDim / kGrid;   // rows of p a thread
constexpr int kTN = kMaxState / kGrid;     // columns of n a thread
constexpr int kMs = kMaxChunk + 1;         // score row stride

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

size_t smem_floats(int N) {
  return static_cast<size_t>(kMaxChunk) * kMaxHeadDim       // xs
         + 2 * static_cast<size_t>(kMaxChunk) * (N + 1)     // bs, cs
         + static_cast<size_t>(kMaxChunk) * kMs             // ms
         + static_cast<size_t>(kMaxHeadDim) * (N + 1)       // hs
         + 3 * kMaxChunk;                                   // dt, cum, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, T* __restrict__ y, int batch,
                int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int NS = N + 1;                     // B, C and state row stride
  float* xs = smem;                         // [L][kMaxHeadDim]
  float* bs = xs + kMaxChunk * kMaxHeadDim; // [L][N + 1]
  float* cs = bs + kMaxChunk * NS;          // [L][N + 1]
  float* ms = cs + kMaxChunk * NS;          // [L][L + 1]
  float* hs = ms + kMaxChunk * kMs;         // [kMaxHeadDim][N + 1]
  float* dts = hs + kMaxHeadDim * NS;       // [L]
  float* cum = dts + kMaxChunk;             // [L]
  float* ws = cum + kMaxChunk;              // [L]

  const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
  const long row = blockIdx.x;              // chain * batch + batch row
  const int h = blockIdx.y;
  const float a = A[(row / batch) * H + h];

  for (int i = tid; i < kMaxHeadDim * NS; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);
    const long step0 = row * S + t0;        // this chunk's first step
    __syncthreads();                        // the last chunk is read
    for (int i = tid; i < Lc * P; i += kThreads) {
      const int l = i / P, p = i - l * P;
      xs[l * kMaxHeadDim + p] = to_f(x[((step0 + l) * H + h) * P + p]);
    }
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int l = i / N, n = i - l * N;
      bs[l * NS + n] = B[step0 * N + i];
      cs[l * NS + n] = C[step0 * N + i];
    }
    for (int l = tid; l < Lc; l += kThreads) dts[l] = dt[(step0 + l) * H + h];
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int l = 0; l < Lc; ++l) {
        c += a * dts[l];
        cum[l] = c;
      }
    }
    __syncthreads();
    const float cum_last = cum[Lc - 1];
    for (int l = tid; l < Lc; l += kThreads)
      ws[l] = expf(cum_last - cum[l]) * dts[l];

    // scores: ms[t][s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t
    {
      float g[kTL][kTL];
#pragma unroll
      for (int i = 0; i < kTL; ++i)
#pragma unroll
        for (int j = 0; j < kTL; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kTL], bv[kTL];
#pragma unroll
        for (int i = 0; i < kTL; ++i) cv[i] = cs[(ty + kGrid * i) * NS + n];
#pragma unroll
        for (int j = 0; j < kTL; ++j) bv[j] = bs[(tx + kGrid * j) * NS + n];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTL; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTL; ++i) {
        const int t = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kTL; ++j) {
          const int s = tx + kGrid * j;
          if (t < Lc && s < Lc)
            ms[t * kMs + s] =
                s <= t ? g[i][j] * (expf(cum[t] - cum[s]) * dts[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_s ms[t][s] x[s][p] + exp(cum_t) * (C_t . h0[p])
    {
      float y1[kTL][kTP], y2[kTL][kTP];
#pragma unroll
      for (int i = 0; i < kTL; ++i)
#pragma unroll
        for (int j = 0; j < kTP; ++j) y1[i][j] = y2[i][j] = 0.f;
      for (int s = 0; s < Lc; ++s) {
        float mv[kTL], xv[kTP];
#pragma unroll
        for (int i = 0; i < kTL; ++i) mv[i] = ms[(ty + kGrid * i) * kMs + s];
#pragma unroll
        for (int j = 0; j < kTP; ++j)
          xv[j] = xs[s * kMaxHeadDim + tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTP; ++j)
            y1[i][j] = fmaf(mv[i], xv[j], y1[i][j]);
      }
      if (t0 > 0) {                         // h0 = 0 in the first chunk
        for (int n = 0; n < N; ++n) {
          float cv[kTL], hv[kTP];
#pragma unroll
          for (int i = 0; i < kTL; ++i) cv[i] = cs[(ty + kGrid * i) * NS + n];
#pragma unroll
          for (int j = 0; j < kTP; ++j) hv[j] = hs[(tx + kGrid * j) * NS + n];
#pragma unroll
          for (int i = 0; i < kTL; ++i)
#pragma unroll
            for (int j = 0; j < kTP; ++j)
              y2[i][j] = fmaf(cv[i], hv[j], y2[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTL; ++i) {
        const int t = ty + kGrid * i;
        if (t >= Lc) continue;
        const float e = expf(cum[t]);
        T* yr = y + ((step0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kTP; ++j) {
          const int p = tx + kGrid * j;
          if (p < P) store(yr + p, y1[i][j] + e * y2[i][j]);
        }
      }
    }
    __syncthreads();                        // h0 is read

    // h1[p][n] = h0[p][n] exp(cum_last) + sum_s (x[s][p] w_s) B[s][n]
    {
      float acc[kTP][kTN];
#pragma unroll
      for (int i = 0; i < kTP; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < Lc; ++s) {
        const float w = ws[s];
        float xv[kTP], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTP; ++i)
          xv[i] = xs[s * kMaxHeadDim + ty + kGrid * i] * w;
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[s * NS + tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kTP; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        const int p = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int n = tx + kGrid * j;
          if (p < P && n < N) {
            float* hp = hs + p * NS + n;
            *hp = *hp * decay + acc[i][j];
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const float* B, const float* C, void* y, int chains,
                   int batch, int S, int H, int P, int N, int L,
                   cudaStream_t st) {
  auto kernel = ssd_scan_kernel<T>;
  const size_t bytes = smem_floats(N) * sizeof(float);
  // above 48 KB only as dynamic shared memory, after raising the limit;
  // the limit belongs to the current device, so it is raised every launch
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(chains) * batch, H);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), dt, A, B, C, static_cast<T*>(y), batch, S, H,
      P, N, L);
  return cudaGetLastError();
}

}  // namespace

// x, y [chains, batch, S, H, P] (bf16 != 0: __nv_bfloat16, else float);
// dt [chains, batch, S, H], A [chains, H], B, C [chains, batch, S, N],
// float, contiguous; 1 <= chunk <= 64, P <= 64, N <= 128.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const float* B, const float* C, void* y,
                               int chains, int batch, int S, int H, int P,
                               int N, int chunk, int bf16, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || P > kMaxHeadDim || N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(x, dt, A, B, C, y, chains, batch, S, H, P,
                                   N, chunk, st)
           : launch<float>(x, dt, A, B, C, y, chains, batch, S, H, P, N,
                           chunk, st);
  return static_cast<int>(e);
}

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
