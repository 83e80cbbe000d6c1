// Device helpers shared by the two sLDA sampler kernels (sm_90a).
//
// Layout shared by both kernels: one warp per (chain, document); lane j
// holds topic t = j + 32k in register slot k (K = ceil(T / 32) slots,
// T <= 256), so a row of a [W, T] table is read by the warp in coalesced
// 32-float pieces.  Topics t >= T carry p = 0 and never win a draw.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace slda {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxTopics = 256;

// murmur3-finalizer counter hash -> uniform in [0, 1), bit for bit the
// reference's `counter_uniform` (int32 seed and counter read as uint32).
__device__ __forceinline__ float counter_uniform(uint32_t seed,
                                                 uint32_t ctr) {
  uint32_t x = seed ^ (ctr * 0x9E3779B9u);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return static_cast<float>(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
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

// Inverse-CDF draw: z = #{t < T : c_t < u * c_{T-1}} with c the inclusive
// prefix sum of p (p[k] holds topic lane + 32k; topics past T never win).
// c_t is summed strictly left to right, c_t = (..((p_0 + p_1) + p_2)..) + p_t,
// which is the order in which a float32 GEMM accumulates the plain
// version's `p @ triu(T)` over its inner dimension: the two round alike,
// so their draws agree.  The warp stages p in `sp` (T floats of shared
// memory) and every lane runs the chain for its own topics, reading p_i
// by broadcast; c_{T-1} (the total) is the chain over all T.
template <int K>
__device__ __forceinline__ int draw_topic(const float (&p)[K], float u,
                                          int lane, int T, float* sp) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < T) sp[lane + 32 * k] = p[k];
  __syncwarp();
  float c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0.f;
  float total = 0.f;
#pragma unroll 16
  for (int i = 0; i < T; ++i) {
    const float pi = sp[i];
    total += pi;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i <= lane + 32 * k) c[k] += pi;
  }
  __syncwarp();  // sp is rewritten by the next token
  const float thr = u * total;
  int z = 0;
#pragma unroll
  for (int k = 0; k < K; ++k)
    z += __popc(__ballot_sync(kFull, lane + 32 * k < T && c[k] < thr));
  return z;
}

}  // namespace slda

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
