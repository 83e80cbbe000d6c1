// Kernel B5: causal GQA attention with an online softmax (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the reference
// (src/repro/kernels/flash_attention.py:26) and computes what the oracle
// `ref_attention` defines at every shape: q [B, Hq, Sq, Dh], k/v
// [B, Hkv, Sk, Dh] (float32 or bf16, Dh <= 128), query head h reads KV
// head h / (Hq / Hkv); row i of a causal call sees keys j <= i + Sk - Sq
// (the queries are the last Sq positions) and, with kv_len, keys
// j < kv_len[b].  Scores, the running max and sum and the output
// accumulator are float32; the output is cast to q's type.  A row with no
// valid key is 0 / 0 = NaN, as the oracle's all -inf softmax is.
//
// The TPU kernel pads q to its block and aligns the causal diagonal with
// the padded length (`kv_len - sq` with sq the padded Sq), which shifts
// every row of a padded causal call.  Here nothing is padded: the grid
// covers ceil(Sq / BQ) blocks, rows past Sq are staged as zeros and never
// written, and the diagonal offset is Sk - Sq of the true shapes.
//
// Design (a simple kernel, right first): one CTA per (q block, query
// head, batch row), WARPS warps of ROWS query rows each (BQ = WARPS *
// ROWS).  The CTA stages its q rows in shared memory as float32, then
// walks the keys in tiles of 32, staging K (row stride Dh + 1, so lane j
// reading key j's column d hits bank (j + d) mod 32) and V in shared
// memory.  Lane j scores key j against each of the warp's rows (q read by
// broadcast), the online-softmax update runs per row with warp shuffles,
// the probabilities go through shared memory, and lane l accumulates
// output dims l, l + 32, l + 64, l + 96.  Tiles at or past
// min(kv_len, last row + Sk - Sq + 1) are never loaded: the causal skip
// and the kv_len skip in one bound.  Products accumulate through explicit
// fmaf (the build's --fmad=false leaves explicit fmaf alone), as the
// plain version's GEMMs accumulate.
//
// Bound: at decode (Sq = 1) bytes, the valid K/V prefix read once per
// query head; at prefill the operations, far below the tensor-core rate
// on CUDA cores.  wgmma and TMA, and one CTA per KV-head group (K/V read
// once per group), are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockK = 32;              // keys per tile, one per lane
constexpr int kMaxHeadDim = 128;
constexpr int kDimSlots = kMaxHeadDim / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int WARPS, int ROWS>
constexpr size_t smem_floats(int dh) {
  return static_cast<size_t>(WARPS * ROWS) * dh      // q rows
         + static_cast<size_t>(kBlockK) * (dh + 1)    // K tile, padded
         + static_cast<size_t>(kBlockK) * dh          // V tile
         + static_cast<size_t>(WARPS * ROWS) * kBlockK;  // probabilities
}

template <int WARPS, int ROWS, typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       int Hq, int Hkv, int Sq, int Sk, int Dh, float scale,
                       int causal) {
  constexpr int BQ = WARPS * ROWS;
  constexpr int kThreads = WARPS * 32;
  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][Dh]
  float* ks = qs + BQ * Dh;                  // [kBlockK][Dh + 1]
  float* vs = ks + kBlockK * (Dh + 1);       // [kBlockK][Dh]
  float* ps = vs + kBlockK * Dh;             // [BQ][kBlockK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (Hq / Hkv);
  const long q_base = (static_cast<long>(b) * Hq + h) * Sq * Dh;
  const long kv_base = (static_cast<long>(b) * Hkv + hk) * Sk * Dh;

  const int kvl = kv_len ? min(max(kv_len[b], 0), Sk) : Sk;
  const int off = Sk - Sq;                   // causal: j <= i + off
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(kvl, q_last + off + 1) : kvl;

  for (int i = threadIdx.x; i < BQ * Dh; i += kThreads) {
    const int r = i / Dh;
    qs[i] = q0 + r < Sq ? to_f(q[q_base + static_cast<long>(q0) * Dh + i])
                        : 0.f;
  }

  const int row0 = q0 + warp * ROWS;         // this warp's first row
  const bool active = row0 < Sq;
  const float* qw = qs + warp * ROWS * Dh;
  float* pw = ps + warp * ROWS * kBlockK;
  float m[ROWS], l[ROWS], acc[ROWS][kDimSlots];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimSlots; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < k_end; j0 += kBlockK) {
    __syncthreads();                         // the last tile is read
    for (int i = threadIdx.x; i < kBlockK * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const bool in = j0 + j < k_end;
      const long g = kv_base + static_cast<long>(j0) * Dh + i;
      ks[j * (Dh + 1) + d] = in ? to_f(k[g]) : 0.f;
      vs[i] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (Dh + 1);
    for (int d = 0; d < Dh; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qw[r * Dh + d], kd, s[r]);
    }
    const int key = j0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool ok = key < kvl && (!causal || key <= row0 + r + off);
      const float sv = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(sv - base);       // 0 for a masked key
      const float corr = expf(m[r] - base);  // 0 while nothing was valid
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kDimSlots; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      pw[r * kBlockK + lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < kBlockK; ++j) {
      float vj[kDimSlots];
#pragma unroll
      for (int c = 0; c < kDimSlots; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < Dh ? vs[j * Dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = pw[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kDimSlots; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

  if (!active) return;
  T* ob = out + q_base;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    if (row >= Sq) break;
#pragma unroll
    for (int c = 0; c < kDimSlots; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) store(ob + static_cast<long>(row) * Dh + d, acc[r][c] / l[r]);
    }
  }
}

template <int WARPS, int ROWS, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* out, int B, int Hq, int Hkv,
                   int Sq, int Sk, int Dh, float scale, int causal,
                   cudaStream_t st) {
  constexpr int BQ = WARPS * ROWS;
  auto kernel = flash_attention_kernel<WARPS, ROWS, T>;
  const size_t bytes = smem_floats<WARPS, ROWS>(Dh) * sizeof(float);
  // above 48 KB only as dynamic shared memory, after raising the limit;
  // the limit belongs to the current device, so it is raised every launch
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, WARPS * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), Hq, Hkv, Sq, Sk,
      Dh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, int B, int Hq, int Hkv,
                     int Sq, int Sk, int Dh, float scale, int causal,
                     cudaStream_t st) {
  // decode (a few query rows): one row a warp, the four warps share the
  // tile loads; prefill: 16 rows a warp, 64 a CTA
  if (Sq <= 4)
    return launch<4, 1, T>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                           scale, causal, st);
  return launch<4, 16, T>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh, scale,
                          causal, st);
}

}  // namespace

// q, out [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh] (bf16 != 0: __nv_bfloat16,
// else float), contiguous; kv_len int [B] or null (every key valid).
// Logits are scaled by Dh^-0.5, rounded once to float as the plain
// version's Python scalar is.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* kv_len,
                                      void* out, int B, int Hq, int Hkv,
                                      int Sq, int Sk, int Dh, int causal,
                                      int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk,
                                     Dh, scale, causal, st)
           : dispatch<float>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                             scale, causal, st);
  return static_cast<int>(e);
}

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
