// Device helpers shared by the three sLDA sampler kernels (sm_90a).
//
// Layout shared by all three: one warp per (chain, document); lane j
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

// Sparse two-stage draw (kernel B4, the reference's
// `sparse_two_stage_draw` of src/repro/kernels/sparse.py): the same
// categorical as `draw_topic`, split by the word's topic index (idx,
// vmask rows of cap entries, occm row of T) into a sparse bucket over the
// indexed topics and a residual over the rest.  Each of its three prefix
// sums runs left to right, in the order of the plain version's matmuls:
//   cs_i    = sv_0 + .. + sv_i,      sv_i = p[idx_i]·vmask_i  (i < cap)
//   cf_t    = r_b0 + .. + r_t        inside t's block of blk = min(16, T)
//                                    topics, r_t = p_t·(1 − occm_t)
//   cr_b    = rs_0 + .. + rs_b       over the nb block totals, rs_b the
//                                    block's cf at its last topic
// then tgt = u·(q_s + q_r) with q_s, q_r the two totals.  Stage 1 (tgt <
// q_s, or an empty residual) counts cs_i < tgt; stage 2 counts cr_b <
// tgt − q_s to pick the block, then cf_t < the remainder inside it; every
// count is clamped as the reference clamps it.  Every lane computes the
// same totals from the same staged values, so the stage-2 branch is
// warp-uniform.  `sp` holds T + cap + 16 floats: p, then the residual in
// its place, sv and the block totals.
template <int K>
__device__ __forceinline__ int draw_topic_sparse(
    const float (&p)[K], float u, int lane, int T, float* sp,
    const int* __restrict__ idx_row, const float* __restrict__ vm_row,
    const float* __restrict__ om_row, int cap) {
  float* ssv = sp + T;
  float* srs = ssv + cap;
  const int blk = T < 16 ? T : 16;
  const int nb = (T + blk - 1) / blk;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < T) sp[lane + 32 * k] = p[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) {  // cap <= T: K slots cover the bucket
    const int i = lane + 32 * k;
    if (i < cap) ssv[i] = sp[idx_row[i]] * vm_row[i];
  }
  __syncwarp();  // every lane has gathered from p
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    if (t < T) sp[t] = p[k] * (1.f - om_row[t]);
  }
  __syncwarp();
  float cs[K], cf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) cs[k] = cf[k] = 0.f;
  float q_s = 0.f;
#pragma unroll 16
  for (int i = 0; i < cap; ++i) {
    const float v = ssv[i];
    q_s += v;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i <= lane + 32 * k) cs[k] += v;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    const int b0 = t / blk * blk;
#pragma unroll 16
    for (int j = 0; j < blk; ++j)
      if (t < T && b0 + j <= t) cf[k] += sp[b0 + j];
  }
  if (lane < nb) {
    float rs = 0.f;
    for (int i = lane * blk; i < lane * blk + blk && i < T; ++i) rs += sp[i];
    srs[lane] = rs;
  }
  __syncwarp();
  float cr = 0.f, q_r = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float v = srs[b];
    q_r += v;
    if (b <= lane) cr += v;
  }
  __syncwarp();  // sp is rewritten by the next token
  const float tgt = u * (q_s + q_r);
  if (tgt < q_s || q_r <= 0.f) {  // stage 1: the sparse bucket
    int ks = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      ks += __popc(__ballot_sync(kFull, lane + 32 * k < cap && cs[k] < tgt));
    return idx_row[min(ks, cap - 1)];
  }
  // stage 2: the residual, block first, then the topic inside it
  const float tr = tgt - q_s;
  const int jb = min(__popc(__ballot_sync(kFull, lane < nb && cr < tr)),
                     nb - 1);
  const float cr_before = __shfl_sync(kFull, cr, jb > 0 ? jb - 1 : 0);
  const float rem = tr - (jb > 0 ? cr_before : 0.f);
  int kf = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    kf += __popc(__ballot_sync(kFull, t < T && t / blk == jb && cf[k] < rem));
  }
  return min(jb * blk + min(kf, blk - 1), T - 1);
}

}  // namespace slda

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
