// Device helpers shared by the three sLDA sampler kernels (sm_90a).
//
// The warp layout (B1's and B2's `warp` variants, B3's `block` variant, and
// B3's `cluster` variant above T = 16): a warp draws one (chain, document);
// lane j holds topic t = j + 32k in register slot k (K slots, T <= 32K, T <=
// 512), so a row of a [W, T] table is read by the warp in coalesced 32-float
// pieces.  Topics t >= T carry p = 0 and never win a draw.  Its kernels are
// declared with one CTA an SM as their minimum (`__launch_bounds__(threads,
// 1)`): with the thread count alone, ptxas held some to 96 or 128 registers
// a thread and spilled (up to 172 bytes at K = 12) to keep more CTAs
// resident.  The group helpers at the end serve layouts in which a half-warp
// draws one document (B2's `half_warp`, B3's `cluster` at T <= 16), dense or
// sparse; B1's `lane` variant draws a document in one lane and needs none of
// them.  Kernel B4, the sparse two-stage draw, comes in three forms, one for
// each layout (`draw_topic_sparse`, `_lane`, `_half`), all reading the
// packed topic index below.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace slda {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxTopics = 512;

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
// prefix sum of p (p[k] holds topic lane + 32k; topics past T never win),
// clamped to T - 1: the count reaches T only where the total is not
// positive (negative counts, which the supervisor's probes flag), and a
// chain in that state must still not index past its table.
// c_t is summed strictly left to right, c_t = (..((p_0 + p_1) + p_2)..) + p_t,
// the order of the plain version's prefix sum (`mathutil.prefix_sum`).
// The warp stages p in `sp` and runs that one chain of T adds, every lane
// alike, writing each c_t beside it (`sc`: `dense_stage_floats` floats a
// warp in all); each lane then reads its own topics' c_t back, so that a
// lane holds no K-long sum and the chain is T adds at any K.  c_{T-1} is
// the total.
__host__ __device__ __forceinline__ int dense_stage_floats(int T) {
  return 2 * T;
}
template <int K>
__device__ __forceinline__ int draw_topic(const float (&p)[K], float u,
                                          int lane, int T, float* sp) {
  float* sc = sp + T;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane + 32 * k < T) sp[lane + 32 * k] = p[k];
  __syncwarp();
  float c = 0.f;
#pragma unroll 16
  for (int i = 0; i < T; ++i) {
    c += sp[i];
    sc[i] = c;  // every lane writes the same value
  }
  __syncwarp();
  const float thr = u * c;
  int z = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    z += __popc(__ballot_sync(kFull, t < T && sc[min(t, T - 1)] < thr));
  }
  __syncwarp();  // the stage is rewritten by the next token
  return min(z, T - 1);  // T only where the total is not positive
}

// ---------------------------------------------------------------------------
// The packed topic index.  The sparse draw reads a word's index rows idx
// (cap topics), vmask (cap) and occm (T) only as topic numbers and 0/1
// flags: `topic_occupancy_index` makes vmask and occm exactly 0 or 1, and
// with p finite and >= 0, p·vmask and p·(1 − occm) equal a select on a
// bit, bit for bit (p·0 = +0).  So the kernels read one record a (chain,
// word) in their place, packed on the device once a launch
// (`pack_topic_index`, beside the rows, which stay the plain version's
// operands), in 32-bit words:
//   [0, ow)             occm: topic t at bit t % 32 of word t / 32
//                       (ow = ⌈T/32⌉)
//   [ow, ow + vw)       vmask: slot i at bit i % 32 of word i / 32
//                       (vw = ⌈cap/32⌉)
//   [ow + vw, ...)      idx: slot i in bits [ib·i, ib·i + ib) of the
//                       section, ib = 4 (T <= 16), 8 (T <= 256) or 16
// and zeros up to a multiple of four words: 16 bytes at T <= 16, against
// 192 bytes of rows at T = cap = 16.  `sparse.pack_topic_index` is its
// plain version.
__host__ __device__ __forceinline__ int rec_ibits(int T) {
  return T <= 16 ? 4 : T <= 256 ? 8 : 16;
}
__host__ __device__ __forceinline__ int rec_words(int T, int cap) {
  const int n = (T + 31) / 32 + (cap + 31) / 32 +
                (cap * rec_ibits(T) + 31) / 32;
  return (n + 3) & ~3;
}
// floats of a warp's stage for the warp layout's sparse draw: p, the
// residual and its in-block prefixes, the bucket, the block totals
// (nb <= 32) and two records (the token's and the next one's, copied in
// ahead: `fetch_record`)
__host__ __device__ __forceinline__ int sparse_stage_floats(int T, int cap) {
  return 3 * T + cap + 32 + 2 * rec_words(T, cap);
}
// record buffer `which` (0 or 1) of a warp's sparse stage
__device__ __forceinline__ uint32_t* stage_record(float* sp, int T, int cap,
                                                  int which) {
  return reinterpret_cast<uint32_t*>(sp + 3 * T + cap + 32) +
         which * rec_words(T, cap);
}

// topic of slot i, from the idx section of a record
__device__ __forceinline__ int rec_topic(const uint32_t* ix, int i, int ib) {
  const int bit = i * ib;
  return static_cast<int>((ix[bit >> 5] >> (bit & 31)) & ((1u << ib) - 1u));
}
// the same from a 16-byte record (T <= 16: nibbles in words 2 and 3)
__device__ __forceinline__ int rec16_topic(const uint4& rec, int i) {
  return static_cast<int>(((i < 8 ? rec.z : rec.w) >> (4 * (i & 7))) & 15u);
}

// One thread a record word: rows (chain, word) rows of (idx, vmask
// [rows, cap], occm [rows, T]) into rec [rows, rec_words(T, cap)].
__global__ void pack_topic_index_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ vmask,
                                        const float* __restrict__ occm,
                                        uint32_t* __restrict__ rec,
                                        size_t rows, int T, int cap) {
  const int rw = rec_words(T, cap);
  const int ow = (T + 31) / 32, vw = (cap + 31) / 32, ib = rec_ibits(T);
  const size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= rows * rw) return;
  const size_t r = g / rw;
  const int j = static_cast<int>(g - r * rw);
  uint32_t v = 0u;
  if (j < ow) {
    for (int b = 0; b < 32; ++b) {
      const int t = 32 * j + b;
      if (t < T && occm[r * T + t] != 0.f) v |= 1u << b;
    }
  } else if (j < ow + vw) {
    for (int b = 0; b < 32; ++b) {
      const int i = 32 * (j - ow) + b;
      if (i < cap && vmask[r * cap + i] != 0.f) v |= 1u << b;
    }
  } else {
    const int per = 32 / ib;
    const uint32_t m = (1u << ib) - 1u;
    for (int e = 0; e < per; ++e) {
      const int i = (j - ow - vw) * per + e;
      if (i < cap)
        v |= (static_cast<uint32_t>(idx[r * cap + i]) & m) << (ib * e);
    }
  }
  rec[g] = v;
}

// the packing of `rows` index rows on stream st (a launcher's first kernel)
inline cudaError_t pack_topic_index(const int* idx, const float* vmask,
                                    const float* occm, uint32_t* rec,
                                    size_t rows, int T, int cap,
                                    cudaStream_t st) {
  const size_t n = rows * rec_words(T, cap);
  if (n == 0) return cudaSuccess;
  pack_topic_index_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                            st>>>(idx, vmask, occm, rec, rows, T, cap);
  return cudaGetLastError();
}

// The warp's copy of a record (rw words, from global memory) into dst in
// its stage, issued asynchronously (cp.async) by every lane and committed
// as one group, empty where there is no token (`live` false), so that each
// lane commits one group a call; nothing waits for it here, and no
// register holds it.  `record_wait<n>` waits until at most the n newest
// groups are in flight and makes every lane's copies visible to the warp.
__device__ __forceinline__ void fetch_record(uint32_t* dst,
                                             const uint32_t* __restrict__ src,
                                             int lane, int rw, bool live) {
  if (live)
    for (int j = lane; j < rw; j += 32)
      __pipeline_memcpy_async(dst + j, src + j, sizeof(uint32_t));
  __pipeline_commit();
}
template <int PENDING>
__device__ __forceinline__ void record_wait() {
  __pipeline_wait_prior(PENDING);
  __syncwarp();
}

// Sparse two-stage draw in the warp layout (kernel B4, the reference's
// `sparse_two_stage_draw` of src/repro/kernels/sparse.py): the same
// categorical as `draw_topic`, split by the word's topic index into a
// sparse bucket over the indexed topics and a residual over the rest.
// Each of its three prefix sums runs left to right (the plain version,
// `sparse.two_stage_draw`, forms them as matmuls with triangles of ones):
//   cs_i    = sv_0 + .. + sv_i,      sv_i = p[idx_i] where vmask_i, else 0
//   cf_t    = r_b0 + .. + r_t        inside t's block of blk = min(16, T)
//                                    topics, r_t = 0 where occm_t, else p_t
//   cr_b    = rs_0 + .. + rs_b       over the nb block totals, rs_b the
//                                    block's cf at its last topic
// then tgt = u·(q_s + q_r) with q_s, q_r the two totals.  Stage 1 (tgt <
// q_s, or an empty residual) counts cs_i < tgt; stage 2 counts cr_b <
// tgt − q_s to pick the block, then cf_t < the remainder inside it; every
// count is clamped as the reference clamps it.  Every lane computes the
// same totals from the same staged values, so the stage-2 branch is
// warp-uniform.  `srec` is the word's record in the warp's stage
// (`stage_record`), copied in a token ahead and visible to every lane
// (`record_wait`); p, the residual, its in-block prefixes, the bucket and
// the block totals are staged beside it (`sparse_stage_floats` floats), so
// that no sum and no record word is held in K registers a lane: the block
// totals come from the prefixes, stage 2 reads its one block's prefixes
// back (a ballot of 16 lanes), and the bucket's prefixes cover only the
// ⌈cap/32⌉ slots that hold it.
template <int K>
__device__ __forceinline__ int draw_topic_sparse(const float (&p)[K], float u,
                                                 int lane, int T, int cap,
                                                 float* sp,
                                                 const uint32_t* srec) {
  float* sr = sp + T;       // the residual
  float* scf = sr + T;      // its prefix inside each block
  float* ssv = scf + T;     // the bucket
  float* srs = ssv + cap;   // the block totals
  // blocks of 16 topics, or one block of T < 16: shifts, no divisions
  const int blk = T < 16 ? T : 16;
  const int nb = T < 16 ? 1 : (T + 15) >> 4;
  const int ib = rec_ibits(T);
  const int kc = (cap + 31) / 32;  // slots that hold bucket entries
  const uint32_t* s_vm = srec + (T + 31) / 32;
  const uint32_t* s_ix = s_vm + kc;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    if (t < T) {
      sp[t] = p[k];
      sr[t] = (srec[k] >> lane) & 1u ? 0.f : p[k];  // occm's word k
    }
  }
  __syncwarp();
  // the bucket, gathered from p; each lane's in-block prefixes, and each
  // block's total from the lane that holds its last topic (slot by slot,
  // so that no more than one slot's 16 loads are in flight)
  for (int k = 0; k < kc; ++k) {
    const int i = lane + 32 * k;
    if (i < cap)
      ssv[i] = (s_vm[k] >> lane) & 1u ? sp[rec_topic(s_ix, i, ib)] : 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    if (t < T) {
      const int b0 = T < 16 ? 0 : t & ~15;
      float c = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float v = sr[min(b0 + j, T - 1)];
        if (j < blk && b0 + j <= t) c += v;
      }
      scf[t] = c;
      if (t == T - 1 || t - b0 == blk - 1) srs[T < 16 ? 0 : t >> 4] = c;
    }
  }
  __syncwarp();
  float q_s = 0.f, cs0 = 0.f;  // cs0: the prefix at slot `lane`
#pragma unroll 16
  for (int i = 0; i < cap; ++i) {
    const float v = ssv[i];
    q_s += v;
    if (i <= lane) cs0 += v;
  }
  float cr = 0.f, q_r = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float v = srs[b];
    q_r += v;
    if (b <= lane) cr += v;
  }
  const float tgt = u * (q_s + q_r);
  int z;
  if (tgt < q_s || q_r <= 0.f) {  // stage 1: the sparse bucket
    int ks = __popc(__ballot_sync(kFull, lane < cap && cs0 < tgt));
    for (int k = 1; k < kc; ++k) {  // slots past 32 (cap > 32)
      const int i = lane + 32 * k;
      float c = 0.f;
      for (int j = 0; j < cap; ++j) {
        const float v = ssv[j];
        if (j <= i) c += v;
      }
      ks += __popc(__ballot_sync(kFull, i < cap && c < tgt));
    }
    z = rec_topic(s_ix, min(ks, cap - 1), ib);
  } else {  // stage 2: the residual, block first, then the topic inside it
    const float tr = tgt - q_s;
    const int jb = min(__popc(__ballot_sync(kFull, lane < nb && cr < tr)),
                       nb - 1);
    const float cr_before = __shfl_sync(kFull, cr, jb > 0 ? jb - 1 : 0);
    const float rem = tr - (jb > 0 ? cr_before : 0.f);
    const int t = jb * blk + lane;
    const float c = scf[min(t, T - 1)];
    const int kf =
        __popc(__ballot_sync(kFull, lane < blk && t < T && c < rem));
    z = min(jb * blk + min(kf, blk - 1), T - 1);
  }
  __syncwarp();  // the stage is rewritten by the next token
  return z;
}

// The sparse draw for a lane that draws one document alone (B1's `lane`
// variant, T <= 16): p[16] its weights (zeros past T), rec its word's
// 16-byte record, col its column of a [17][32] float stage in shared
// memory whose row 16 holds 0 (`kLaneCells`): it gathers p through the
// column by a runtime topic (a register array indexed so would go to
// local memory), an invalid slot (vmask's bit 0, as past cap) reading
// the zero, so the bucket needs no select.  A lane touches only its own
// column: no barrier, and the column's bank is the lane's.  The three
// sums run left to right in registers; with one block (blk = T) the
// block total cr_0 is the residual's total itself, and stage 2 picks
// block 0 with remainder tgt − q_s.  Positions past cap (T) add zeros,
// which leave the sums as they were, and are counted unguarded: their
// prefix is q_s (q_r), which stage 1 never counts (it runs only where
// tgt < q_s, or q_r = 0 and tgt = u·q_s <= q_s), and which stage 2
// counts only where every topic below T counts too, so that the clamp
// to T − 1 gives the same topic.  Counts are trees of integer adds.
constexpr int kLaneCells = 17;
__device__ __forceinline__ int draw_topic_sparse_lane(const float (&p)[16],
                                                      float u, int T, int cap,
                                                      const uint4& rec,
                                                      float* col) {
  const uint32_t om = rec.x, vm = rec.y;
#pragma unroll
  for (int t = 0; t < 16; ++t) col[32 * t] = p[t];
  float g[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    g[i] = col[32 * ((vm >> i) & 1u ? rec16_topic(rec, i) : 16)];
  float cs[16], cf[16];
  float q_s = 0.f, q_r = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    q_s += g[i];
    cs[i] = q_s;
    q_r += (om >> i) & 1u ? 0.f : p[i];
    cf[i] = q_r;
  }
  const float tgt = u * (q_s + q_r);
  const float rem = tgt - q_s;
  int ks[16], kf[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ks[i] = cs[i] < tgt ? 1 : 0;
    kf[i] = cf[i] < rem ? 1 : 0;
  }
#pragma unroll
  for (int w = 1; w < 16; w *= 2)
#pragma unroll
    for (int i = 0; i < 16; i += 2 * w) {
      ks[i] += ks[i + w];
      kf[i] += kf[i + w];
    }
  return tgt < q_s || q_r <= 0.f ? rec16_topic(rec, min(ks[0], cap - 1))
                                 : min(kf[0], T - 1);
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
  return min(__popc(group_bits<16>(
                 __ballot_sync(kFull, gl < T && c < thr), shift)),
             T - 1);  // as `draw_topic`
}

// The sparse draw for a half-warp group (T <= 16, topic t in lane t of
// the half; B2's `half_warp`, B3's `cluster`): the gather p[idx_i] is a
// shuffle within the half, the bucket and the residual are staged side by
// side (`sp`: 32 floats of the half) with zeros past cap and T, and each
// lane's two prefixes are `draw_topic_half`'s zero-padded 16-step loop
// (adding zeros leaves every prefix as it was); the totals are lane
// cap − 1's and lane T − 1's prefixes.  The stage taken is the half's, not
// the warp's, so both counts are taken by both halves.
__device__ __forceinline__ int draw_topic_sparse_half(float p, float u,
                                                      int gl, int T, int cap,
                                                      float* sp,
                                                      const uint4& rec,
                                                      int shift) {
  const float pg = __shfl_sync(kFull, p, rec16_topic(rec, gl), 16);
  sp[gl] = gl < cap && ((rec.y >> gl) & 1u) ? pg : 0.f;
  sp[16 + gl] = gl < T && !((rec.x >> gl) & 1u) ? p : 0.f;
  __syncwarp();
  float cs = 0.f, cf = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float a = sp[i], b = sp[16 + i];
    if (i <= gl) {
      cs += a;
      cf += b;
    }
  }
  __syncwarp();  // sp is rewritten by the next token
  const float q_s = __shfl_sync(kFull, cs, cap - 1, 16);
  const float q_r = __shfl_sync(kFull, cf, T - 1, 16);
  const float tgt = u * (q_s + q_r);
  const float rem = tgt - q_s;
  const int ks = __popc(group_bits<16>(
      __ballot_sync(kFull, gl < cap && cs < tgt), shift));
  const int kf = __popc(group_bits<16>(
      __ballot_sync(kFull, gl < T && cf < rem), shift));
  return tgt < q_s || q_r <= 0.f ? rec16_topic(rec, min(ks, cap - 1))
                                 : min(kf, T - 1);
}

}  // namespace slda

// `CASE(K)` for the slots of T topics: K = ⌈T/32⌉ up to 8, then 12 and 16
// (a lane's slots past T hold p = 0, so a larger K draws alike); T past
// 512 returns cudaErrorInvalidValue from the enclosing launcher.
#define SLDA_FOR_K(T, CASE)                                                 \
  switch (((T) + 31) / 32) {                                                \
    case 1: CASE(1); break;                                                 \
    case 2: CASE(2); break;                                                 \
    case 3: CASE(3); break;                                                 \
    case 4: CASE(4); break;                                                 \
    case 5: CASE(5); break;                                                 \
    case 6: CASE(6); break;                                                 \
    case 7: CASE(7); break;                                                 \
    case 8: CASE(8); break;                                                 \
    case 9: case 10: case 11: case 12: CASE(12); break;                     \
    case 13: case 14: case 15: case 16: CASE(16); break;                    \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
