// Device helpers shared by the three sLDA sampler kernels (sm_90a).
//
// The warp layout (B1's and B2's `warp` variants, B3's `block` variant,
// and every sparse draw): a warp draws one (chain, document); lane j holds
// topic t = j + 32k in register slot k (K = ceil(T / 32) slots, T <= 256),
// so a row of a [W, T] table is read by the warp in coalesced 32-float
// pieces.  Topics t >= T carry p = 0 and never win a draw.  The group
// helpers at the end serve layouts in which a half-warp draws one
// document (B2's `half_warp`, B3's `cluster` at T <= 16); B1's `lane`
// variant draws a document in one lane and needs none of them.
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

// ---------------------------------------------------------------------------
// Groups of G lanes that draw one document (G = 16: a half-warp, two
// documents a warp; G = 32: the whole warp), as B2's half_warp variant and
// B3's cluster variant lay them out: topic t in group lane t mod G, slot
// t / G.

// the drawing group's max and sum (G = 16: a half-warp's butterfly)
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// this group's bits of a warp ballot
template <int G>
__device__ __forceinline__ unsigned group_bits(unsigned v, int shift) {
  return G == 32 ? v : (v >> shift) & 0xffffu;
}

// η of topic z (< T), from the group's registers (topic t in group lane
// t mod G, slot t / G)
template <int K, int G>
__device__ __forceinline__ float eta_of(const float (&eta_r)[K], int z) {
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float v = __shfl_sync(kFull, eta_r[k], z & (G - 1), G);
    if (z / G == k) e = v;
  }
  return e;
}

// `draw_topic` for a half-warp group (T <= 16, one topic a lane): the
// same left-to-right prefix sum, counted in the half's bits; the stage is
// padded with zeros to 16 topics, so that the loop has no bound to test
// (lane t < T still sums p_0 .. p_t from 0), and the total is lane
// T − 1's prefix, the same chain of additions
__device__ __forceinline__ int draw_topic_half(float p, float u, int gl,
                                               int T, float* sp, int shift) {
  sp[gl] = gl < T ? p : 0.f;
  __syncwarp();
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float pi = sp[i];
    if (i <= gl) c += pi;
  }
  __syncwarp();  // sp is rewritten by the next token
  const float total = __shfl_sync(kFull, c, T - 1, 16);
  const float thr = u * total;
  return __popc(group_bits<16>(__ballot_sync(kFull, gl < T && c < thr),
                               shift));
}

}  // namespace slda

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
