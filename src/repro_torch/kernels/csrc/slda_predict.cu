// Kernel B1: all sLDA prediction sweeps in one launch, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_predict_kernel` of
// src/repro/kernels/slda_predict.py (launched by
// `slda_predict_sweeps_chains_pallas`, grid (M, D/DB)).  It computes the
// same thing: for n_burnin + n_samples sweeps, every document walks its
// tokens in order under the frozen φ̂; per real token it removes the
// token's topic from ndt, forms p_t = (ndt_t + α)·φ̂_t[w], draws
// u = counter_uniform(seed_d, s·ctr_stride + n) and
// z = #{t : prefix_t(p) < u·Σp}, and adds the new topic back.  After
// burn-in it sums ndt; the output is that sum times f32(1/n_samples).
// The TPU kernel's `tpu_prng=True` branch (the TPU's hardware PRNG) has
// no counterpart here: the counter hash is the contract.
//
// What bounds it on the card: not bytes (about 2 MB of inputs) or
// operations, but the issue slots of the token steps and the dependent
// chain of the longest document (its real tokens × the sweeps).  Two
// variants, named by the wrapper (`slda_predict.variant`):
//
// * lane (the main path at T <= 16, dense or sparse).  Each lane walks one
//   (chain, document) pair alone, so 32 documents share every warp
//   instruction.  The lane holds its ndt, its post-burn-in sum and its
//   left-to-right prefix in registers: no shuffle, no `__syncwarp`, no
//   shared-memory stage on the token chain.  The wrapper gives the
//   kernel transposed copies of tokens and mask [N, D]
//   (`slda_predict.lane_layout`), so the 32 lanes read one position of
//   their 32 documents in one coalesced piece.  (Lanes taking the
//   documents by length would not shorten the launch, whose time is the
//   longest document's walk while every warp has a scheduler to itself,
//   as at the MD&A slice, and an argsort a launch cost more host time.)
//   z lives in shared memory for the launch, one byte a token: read from
//   z0 once, written to z_out once; padding keeps
//   its topic, as the reference's masked update does, whether or not the
//   mask is a prefix.  φ̂ is frozen for the launch, so a token's row,
//   word, mask, old topic and uniform depend on no draw: the next
//   token's row (a scattered 64-byte read from L2) and the word after it
//   are loaded while this token draws, and the chain holds only the
//   count update, T products, T dependent adds, the compares and the
//   add back.
//
// * warp (the kernel the lane variant replaced, and T > 16): one warp per
//   (chain, document) pair, lane j holding topic t = j + 32k; it reads
//   tokens, mask and z 32 positions at a time in coalesced loads and
//   broadcasts them by shuffle, loads the word's φ̂ row on the chain,
//   stages p in shared memory for the prefix sum (one chain of T adds,
//   `draw_topic`) and counts by ballot, so at T = 16 half of its lanes
//   carry p = 0.  The post-burn-in sum is kept in ndt_avg, read and
//   written once a sweep, so that a lane holds only its counts.
//
// Both draw alike, bit for bit: the same expressions in the same order,
// the prefix strictly left to right with the total the chain over all T
// (the order of the plain version's `mathutil.prefix_sum`), and
// z = #{t : c_t < u·total}.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch at
// slda_predict.py:172-178) draw through kernel B4 against each chain's topic
// index of φ̂, packed by the launcher's first kernel into one record a
// (chain, word) (`pack_topic_index`: 16 bytes at T <= 16).  The lane variant
// loads the next token's record beside its φ̂ row and draws with
// `draw_topic_sparse_lane`, gathering p through its own column of a [17][32]
// shared stage; the warp variant copies a word's record into its stage
// (cp.async) while the token before it draws (the first of each 32-position
// piece on the chain) and draws with `draw_topic_sparse`.  Everything else
// is the dense kernel.
#include "slda_common.cuh"

namespace slda {

// ---------------------------------------------------------------------------
// warp

template <int K, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
predict_sweeps_kernel(const int* __restrict__ tokens,   // [D, N] shared
                      const float* __restrict__ mask,   // [D, N] shared
                      const int* __restrict__ seeds,    // [M, D]
                      const int* __restrict__ z0,       // [M, D, N]
                      const float* __restrict__ ndt0,   // [M, D, T]
                      const float* __restrict__ phi_t,  // [M, W, T]
                      float* __restrict__ ndt_avg,      // [M, D, T]
                      int* __restrict__ z_out,          // [M, D, N]
                      int D, int N, int T, int W, float alpha, int n_burnin,
                      int n_samples, int ctr_stride, float inv_samples,
                      const uint32_t* __restrict__ rec,  // [M, W, rw]
                      int cap, int stride) {
  extern __shared__ float warp_stage[];  // `stride` floats a warp
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= D) return;  // warp-uniform
  const int c = blockIdx.y;
  float* sp = warp_stage + (threadIdx.x >> 5) * stride;
  const int rw = SPARSE ? rec_words(T, cap) : 0;
  const uint32_t* recs = rec + static_cast<size_t>(c) * W * rw;
  const size_t row = static_cast<size_t>(c) * D + d;
  const int* tok = tokens + static_cast<size_t>(d) * N;
  const float* msk = mask + static_cast<size_t>(d) * N;
  const float* phi = phi_t + static_cast<size_t>(c) * W * T;
  int* zrow = z_out + row * N;
  float* avg = ndt_avg + row * T;
  const uint32_t seed = static_cast<uint32_t>(seeds[row]);

  // nd in registers; the post-burn-in sum in ndt_avg itself, read and
  // written once a sweep (0 + nd = nd, so the first sweep stores nd)
  float nd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    nd[k] = t < T ? ndt0[row * T + t] : 0.f;
  }

  int rb = 0;  // the stage's record buffer of the token drawn next
  for (int s = 0; s < n_burnin + n_samples; ++s) {
    const int* zsrc = s == 0 ? z0 + row * N : zrow;  // z persists across sweeps
    for (int n0 = 0; n0 < N; n0 += 32) {
      const int n = n0 + lane;
      const bool in = n < N;
      const int w_l = in ? tok[n] : 0;
      const float m_l = in ? msk[n] : 0.f;
      int z_l = in ? zsrc[n] : 0;
      const float u_l = counter_uniform(
          seed, static_cast<uint32_t>(s) * static_cast<uint32_t>(ctr_stride)
                    + static_cast<uint32_t>(n));
      unsigned real = __ballot_sync(kFull, m_l > 0.f);
      // the record of the chunk's first real token (on the chain), then
      // each next one's while this token draws
      if constexpr (SPARSE) {
        const int w0 = __shfl_sync(kFull, w_l, real ? __ffs(real) - 1 : 0);
        fetch_record(stage_record(sp, T, cap, rb),
                     recs + static_cast<size_t>(w0) * rw, lane, rw, real != 0);
      }
      while (real) {  // real tokens of this chunk, in document order
        const int j = __ffs(real) - 1;
        real &= real - 1;
        const int w = __shfl_sync(kFull, w_l, j);
        const float m = __shfl_sync(kFull, m_l, j);
        const int z_old = __shfl_sync(kFull, z_l, j);
        const float u = __shfl_sync(kFull, u_l, j);
        if constexpr (SPARSE) {
          const int wn = __shfl_sync(kFull, w_l, real ? __ffs(real) - 1 : 0);
          fetch_record(stage_record(sp, T, cap, rb ^ 1),
                       recs + static_cast<size_t>(wn) * rw, lane, rw,
                       real != 0);
        }
        const float* prow = phi + static_cast<size_t>(w) * T;
        float p[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int t = lane + 32 * k;
          nd[k] = nd[k] - (t == z_old ? m : 0.f);
          p[k] = t < T ? (nd[k] + alpha) * prow[t] : 0.f;
        }
        int z_new;
        if constexpr (SPARSE) {
          record_wait<1>();  // this token's record (the next one's in flight)
          z_new = draw_topic_sparse<K>(p, u, lane, T, cap, sp,
                                       stage_record(sp, T, cap, rb));
          rb ^= 1;
        } else {
          z_new = draw_topic<K>(p, u, lane, T, sp);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          nd[k] = nd[k] + (lane + 32 * k == z_new ? m : 0.f);
        if (lane == j) z_l = z_new;
      }
      if (in) zrow[n] = z_l;
    }
    if (s >= n_burnin) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = lane + 32 * k;
        if (t < T) avg[t] = (s == n_burnin ? 0.f : avg[t]) + nd[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    if (t < T) avg[t] = (n_samples > 0 ? avg[t] : 0.f) * inv_samples;
  }
}

// ---------------------------------------------------------------------------
// lane

constexpr int kLaneTopics = 16;  // topics a lane holds (T <= 16)

// the φ̂ row of word w into registers; EXACT: T == kLaneTopics, four
// 16-byte loads (a row is 64 bytes, so 16-byte aligned), else T guarded
// loads with zeros past T
template <bool EXACT>
__device__ __forceinline__ void load_row(float (&r)[kLaneTopics],
                                         const float* __restrict__ phi,
                                         int w, int T) {
  const float* p = phi + w * T;  // within one chain's table
  if constexpr (EXACT) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < kLaneTopics / 4; ++i) {
      const float4 v = __ldg(q + i);
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kLaneTopics; ++t) r[t] = t < T ? __ldg(p + t) : 0.f;
  }
}

// One lane per (chain, document): lane g of chain c (blockIdx.y) walks
// document g.  tok_t / msk_t hold its position n at n·D + g.  Dynamic
// shared memory: SPARSE, each warp's [17 cells][32 lanes] gather stage
// (2,176 bytes); then each warp's z, one byte a token, [N][32 lanes].
template <bool EXACT, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
predict_lane_kernel(const int* __restrict__ tok_t,    // [N, D]
                    const float* __restrict__ msk_t,  // [N, D]
                    const int* __restrict__ seeds,    // [M, D]
                    const int* __restrict__ z0,       // [M, D, N]
                    const float* __restrict__ ndt0,   // [M, D, T]
                    const float* __restrict__ phi_t,  // [M, W, T]
                    float* __restrict__ ndt_avg,      // [M, D, T]
                    int* __restrict__ z_out,          // [M, D, N]
                    int D, int N, int T, int W, float alpha, int n_burnin,
                    int n_samples, int ctr_stride, float inv_samples,
                    const uint4* __restrict__ rec,    // [M, W] records
                    int cap) {
  constexpr int TM = kLaneTopics;
  constexpr int kCol = SPARSE ? kLaneCells * 32 : 0;  // floats a warp
  extern __shared__ __align__(16) uint8_t lane_shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g0 = (blockIdx.x * kWarpsPerBlock + warp) * 32;
  if (g0 >= D) return;  // warp-uniform
  const int c = blockIdx.y;
  const int docs = min(32, D - g0);  // the warp's documents
  float* col = reinterpret_cast<float*>(lane_shared) + warp * kCol + lane;
  uint8_t* zs = lane_shared + kWarpsPerBlock * kCol * sizeof(float) +
                static_cast<size_t>(warp) * 32 * N;
  const uint4* recs = SPARSE ? rec + static_cast<size_t>(c) * W : nullptr;
  if constexpr (SPARSE) col[32 * kLaneTopics] = 0.f;  // the zero cell
  const int g = g0 + lane;
  const bool live = lane < docs;
  const size_t row = static_cast<size_t>(c) * D + (live ? g : 0);

  // the warp's documents' z0, each row read in coalesced pieces
  for (int j = 0; j < docs; ++j) {  // warp-uniform
    const int* src = z0 + (static_cast<size_t>(c) * D + g0 + j) * N;
    for (int n = lane; n < N; n += 32)
      zs[n * 32 + j] = static_cast<uint8_t>(src[n]);
  }
  // this lane's walk ends at its last real token; the warp walks the
  // longest of its lanes' walks
  int len = 0;
  if (live)
    for (int n = 0; n < N; ++n)
      if (msk_t[static_cast<size_t>(n) * D + g] > 0.f) len = n + 1;
  const int steps = __reduce_max_sync(kFull, len);
  __syncwarp();

  float nd[TM], acc[TM];
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    nd[t] = live && t < T ? ndt0[row * T + t] : 0.f;
    acc[t] = 0.f;
  }
  const uint32_t seed = live ? static_cast<uint32_t>(seeds[row]) : 0u;
  const float* phi = phi_t + static_cast<size_t>(c) * W * T;
  const int* tk = tok_t + g;    // position n at tk[n·D]
  const float* mk = msk_t + g;

  for (int s = 0; s < n_burnin + n_samples; ++s) {
    const uint32_t ctr0 =
        static_cast<uint32_t>(s) * static_cast<uint32_t>(ctr_stride);
    // token 0's row, record, mask and old topic, token 1's word and mask
    float row_c[TM];
    uint4 rec_c = make_uint4(0u, 0u, 0u, 0u);
    float m_c = 0.f, m_1 = 0.f;
    int w_1 = 0;
    int z_c = steps > 0 ? zs[lane] : 0;
    {
      int w_c = 0;
      if (live && steps > 0) {
        w_c = tk[0];
        m_c = mk[0];
      }
      load_row<EXACT>(row_c, phi, w_c, T);
      if constexpr (SPARSE) rec_c = __ldg(recs + w_c);
      if (live && steps > 1) {
        w_1 = tk[D];
        m_1 = mk[D];
      }
    }
    for (int n = 0; n < steps; ++n) {  // warp-uniform
      // off the chain: the next token's row, record and old topic (this
      // sweep writes position n only), the word after it, this token's
      // uniform
      float row_n[TM];
      load_row<EXACT>(row_n, phi, w_1, T);
      uint4 rec_n = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (SPARSE) rec_n = __ldg(recs + w_1);
      int w_2 = 0;
      float m_2 = 0.f;
      if (live && n + 2 < steps) {
        w_2 = tk[(n + 2) * D];
        m_2 = mk[(n + 2) * D];
      }
      const int z_1 = n + 1 < steps ? zs[(n + 1) * 32 + lane] : 0;
      const int z_old = z_c;
      const float u = counter_uniform(seed, ctr0 + static_cast<uint32_t>(n));
      if (m_c > 0.f) {  // a real token; padding keeps its topic
        float pv[TM];
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          if (t == z_old) nd[t] = nd[t] - m_c;
          pv[t] = EXACT || t < T ? (nd[t] + alpha) * row_c[t] : 0.f;
        }
        int z_new;
        if constexpr (SPARSE) {
          z_new = draw_topic_sparse_lane(pv, u, T, cap, rec_c, col);
        } else {
          float cp[TM];
          float total = 0.f;
#pragma unroll
          for (int t = 0; t < TM; ++t) {
            total = total + pv[t];  // left to right; past T it adds zeros
            cp[t] = total;
          }
          // z = #{t < T : c_t < u·total}, counted as a tree of sums
          const float thr = u * total;
          int below[TM];
#pragma unroll
          for (int t = 0; t < TM; ++t)
            below[t] = (EXACT || t < T) && cp[t] < thr ? 1 : 0;
#pragma unroll
          for (int w = 1; w < TM; w *= 2)
#pragma unroll
            for (int t = 0; t < TM; t += 2 * w) below[t] += below[t + w];
          z_new = min(below[0], T - 1);  // as `draw_topic`
        }
#pragma unroll
        for (int t = 0; t < TM; ++t)
          if (t == z_new) nd[t] = nd[t] + m_c;
        zs[n * 32 + lane] = static_cast<uint8_t>(z_new);
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) row_c[t] = row_n[t];
      rec_c = rec_n;
      z_c = z_1;
      m_c = m_1;
      w_1 = w_2;
      m_1 = m_2;
    }
    if (s >= n_burnin) {
#pragma unroll
      for (int t = 0; t < TM; ++t) acc[t] = acc[t] + nd[t];
    }
  }
  if (live) {
#pragma unroll
    for (int t = 0; t < TM; ++t)
      if (t < T) ndt_avg[row * T + t] = acc[t] * inv_samples;
  }
  __syncwarp();
  // z back to each document's row.  A real token's topic is below T, so
  // its byte is exact; where the byte still equals z0's, z0 stands (a
  // padding position keeps whatever int32 it held)
  for (int j = 0; j < docs; ++j) {  // warp-uniform
    const size_t at = (static_cast<size_t>(c) * D + g0 + j) * N;
    for (int n = lane; n < N; n += 32) {
      const int was = z0[at + n];
      const uint8_t b = zs[n * 32 + j];
      z_out[at + n] = b == static_cast<uint8_t>(was) ? was : b;
    }
  }
}

// Kernel B4 alone: the sparse two-stage draw of rows of p [R, T] with
// their uniforms and packed index records [R, rw], each layout's device
// function exposed so that it can be held against its plain version and
// timed by itself.  warp: a warp a row (any T); lane: a lane a row and
// half_warp: a half-warp a row (T <= 16).
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
sparse_draw_warp_kernel(const float* __restrict__ p,
                        const float* __restrict__ u,
                        const uint32_t* __restrict__ rec,
                        int* __restrict__ z, int R, int T, int cap,
                        int stride) {
  extern __shared__ float draw_stage[];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // warp-uniform
  const size_t row = static_cast<size_t>(r);
  const int rw = rec_words(T, cap);
  float* sp = draw_stage + (threadIdx.x >> 5) * stride;
  fetch_record(stage_record(sp, T, cap, 0), rec + row * rw, lane, rw, true);
  float pr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    pr[k] = t < T ? p[row * T + t] : 0.f;
  }
  record_wait<0>();
  const int zr = draw_topic_sparse<K>(pr, u[r], lane, T, cap, sp,
                                      stage_record(sp, T, cap, 0));
  if (lane == 0) z[r] = zr;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparse_draw_lane_kernel(const float* __restrict__ p,
                        const float* __restrict__ u,
                        const uint4* __restrict__ rec, int* __restrict__ z,
                        int R, int T, int cap) {
  __shared__ float col[kWarpsPerBlock][kLaneCells][32];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;  // the lane's draw has no warp-wide step
  col[threadIdx.x >> 5][kLaneTopics][lane] = 0.f;  // the zero cell
  float pr[kLaneTopics];
  if (T == kLaneTopics) load_row<true>(pr, p, r, T);  // 16-byte pieces
  else load_row<false>(pr, p, r, T);
  z[r] = draw_topic_sparse_lane(pr, u[r], T, cap, __ldg(rec + r),
                                &col[threadIdx.x >> 5][0][lane]);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparse_draw_half_kernel(const float* __restrict__ p,
                        const float* __restrict__ u,
                        const uint4* __restrict__ rec, int* __restrict__ z,
                        int R, int T, int cap) {
  __shared__ float stage[kWarpsPerBlock][64];  // 32 floats a half
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / 16, gl = lane % 16;
  const int r0 = (blockIdx.x * kWarpsPerBlock + warp) * 2;
  if (r0 >= R) return;  // warp-uniform
  const int r = r0 + grp;
  const bool has = r < R;  // the last warp may draw one row
  const float pv = has && gl < T ? p[static_cast<size_t>(r) * T + gl] : 0.f;
  const uint4 rr = has ? __ldg(rec + r) : make_uint4(0u, 0u, 0u, 0u);
  const int zr = draw_topic_sparse_half(pv, has ? u[r] : 0.f, gl, T, cap,
                                        stage[warp] + 32 * grp, rr, 16 * grp);
  if (has && gl == 0) z[r] = zr;
}

__global__ void counter_uniform_kernel(const int* __restrict__ seeds,
                                       const int* __restrict__ ctrs,
                                       float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = counter_uniform(static_cast<uint32_t>(seeds[i]),
                             static_cast<uint32_t>(ctrs[i]));
}

}  // namespace slda

// variant 0: warp (T <= 512); 1: lane (T <= 16, with the wrapper's
// lane_layout, tok_t and msk_t [N, D], and N <= 1816 for the dense draw,
// 1748 for the sparse one, so that 4 warps' z and gather stages fit 227
// KB).  A non-null idx is the sparse draw over cap <= T slots: the
// launcher first packs (idx, vmask [M, W, cap], occm [M, W, T]) into
// `rec` [M, W, rec_words(T, cap)].
extern "C" int slda_predict_sweeps_launch(
    const int* tokens, const float* mask, const int* seeds, const int* z0,
    const float* ndt0, const float* phi_t, float* ndt_avg, int* z_out, int M,
    int D, int N, int T, int W, float alpha, int n_burnin, int n_samples,
    int ctr_stride, float inv_samples, const int* idx, const float* vmask,
    const float* occm, int cap, int variant, const int* tok_t,
    const float* msk_t, uint32_t* rec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sparse = idx != nullptr;
  if (T < 1 || T > slda::kMaxTopics ||
      (sparse && (cap < 1 || cap > T || !vmask || !occm || !rec)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sparse) {
    const cudaError_t e = slda::pack_topic_index(
        idx, vmask, occm, rec, static_cast<size_t>(M) * W, T, cap, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (variant == 1) {
    // int offsets: a position's column n·D + g and a word's row w·T
    if (T > slda::kLaneTopics || !tok_t || !msk_t ||
        static_cast<long long>(N) * D >= (1LL << 31) ||
        static_cast<long long>(W) * T >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t cols = sparse ? static_cast<size_t>(slda::kWarpsPerBlock) *
                                     slda::kLaneCells * 32 * sizeof(float)
                               : 0;
    const size_t smem =
        cols + static_cast<size_t>(slda::kWarpsPerBlock) * 32 * N;
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const int lanes = slda::kWarpsPerBlock * 32;
    const dim3 grid((D + lanes - 1) / lanes, M);
    const uint4* rec4 = reinterpret_cast<const uint4*>(rec);
#define SLDA_PREDICT_LANE(EXACT, SPARSE)                                    \
  do {                                                                      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          slda::predict_lane_kernel<EXACT, SPARSE>,                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(smem));                                          \
      if (e != cudaSuccess) return static_cast<int>(e);                     \
    }                                                                       \
    slda::predict_lane_kernel<EXACT, SPARSE><<<grid, lanes, smem, st>>>(    \
        tok_t, msk_t, seeds, z0, ndt0, phi_t, ndt_avg, z_out, D, N,         \
        T, W, alpha, n_burnin, n_samples, ctr_stride, inv_samples, rec4,    \
        cap);                                                               \
  } while (0)
    const bool exact = T == slda::kLaneTopics;
    if (sparse) {
      if (exact) SLDA_PREDICT_LANE(true, true);
      else SLDA_PREDICT_LANE(false, true);
    } else {
      if (exact) SLDA_PREDICT_LANE(true, false);
      else SLDA_PREDICT_LANE(false, false);
    }
#undef SLDA_PREDICT_LANE
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock, M);
  const dim3 block(slda::kWarpsPerBlock * 32);
  // a warp's stage: p and its prefixes for the dense draw
  // (`dense_stage_floats`), `sparse_stage_floats` for B4
#define SLDA_PREDICT_AS(K, SPARSE)                                          \
  do {                                                                      \
    const int stride = SPARSE ? slda::sparse_stage_floats(T, cap)           \
                              : slda::dense_stage_floats(T);                \
    const size_t smem = sizeof(float) * slda::kWarpsPerBlock * stride;      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          slda::predict_sweeps_kernel<K, SPARSE>,                           \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(smem));                                          \
      if (e != cudaSuccess) return static_cast<int>(e);                     \
    }                                                                       \
    slda::predict_sweeps_kernel<K, SPARSE><<<grid, block, smem, st>>>(      \
        tokens, mask, seeds, z0, ndt0, phi_t, ndt_avg, z_out, D, N, T, W,   \
        alpha, n_burnin, n_samples, ctr_stride, inv_samples, rec, cap,      \
        stride);                                                            \
  } while (0)
#define SLDA_PREDICT(K)                                                     \
  if (sparse) SLDA_PREDICT_AS(K, true); else SLDA_PREDICT_AS(K, false)
  SLDA_FOR_K(T, SLDA_PREDICT)
#undef SLDA_PREDICT
#undef SLDA_PREDICT_AS
  return static_cast<int>(cudaGetLastError());
}

// Kernel B4 alone (variant 0: warp, 1: lane, 2: half_warp; the last two
// at T <= 16): packs (idx, vmask [R, cap], occm [R, T]) into `rec`
// [R, rec_words(T, cap)], then draws z [R] from p [R, T] and u [R].
extern "C" int slda_sparse_draw_launch(const float* p, const float* u,
                                       const int* idx, const float* vmask,
                                       const float* occm, uint32_t* rec,
                                       int* z, int R, int T, int cap,
                                       int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > slda::kMaxTopics || cap < 1 || cap > T || R < 0 ||
      (variant != 0 && T > slda::kLaneTopics) || variant < 0 ||
      variant > 2 || static_cast<long long>(R) * T >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      slda::pack_topic_index(idx, vmask, occm, rec, R, T, cap, st);
  if (e != cudaSuccess || R == 0) return static_cast<int>(e);
  const int threads = slda::kWarpsPerBlock * 32;
  if (variant == 1) {
    slda::sparse_draw_lane_kernel<<<(R + threads - 1) / threads, threads, 0,
                                    st>>>(
        p, u, reinterpret_cast<const uint4*>(rec), z, R, T, cap);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == 2) {
    const int rows = 2 * slda::kWarpsPerBlock;
    slda::sparse_draw_half_kernel<<<(R + rows - 1) / rows, threads, 0, st>>>(
        p, u, reinterpret_cast<const uint4*>(rec), z, R, T, cap);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((R + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock);
  const int stride = slda::sparse_stage_floats(T, cap);
  const size_t smem = sizeof(float) * slda::kWarpsPerBlock * stride;
#define SLDA_SPARSE_DRAW(K)                                                 \
  do {                                                                      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t a = cudaFuncSetAttribute(                           \
          slda::sparse_draw_warp_kernel<K>,                                 \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(smem));                                          \
      if (a != cudaSuccess) return static_cast<int>(a);                     \
    }                                                                       \
    slda::sparse_draw_warp_kernel<K><<<grid, threads, smem, st>>>(          \
        p, u, rec, z, R, T, cap, stride);                                   \
  } while (0)
  SLDA_FOR_K(T, SLDA_SPARSE_DRAW)
#undef SLDA_SPARSE_DRAW
  return static_cast<int>(cudaGetLastError());
}

// The packing alone: (idx, vmask [rows, cap], occm [rows, T]) into rec
// [rows, rec_words(T, cap)], held against `sparse.pack_topic_index`.
extern "C" int slda_pack_topic_index_launch(const int* idx,
                                            const float* vmask,
                                            const float* occm, uint32_t* rec,
                                            int rows, int T, int cap,
                                            void* stream) {
  if (T < 1 || T > slda::kMaxTopics || cap < 1 || cap > T || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(slda::pack_topic_index(
      idx, vmask, occm, rec, rows, T, cap, static_cast<cudaStream_t>(stream)));
}

extern "C" int slda_counter_uniform_launch(const int* seeds, const int* ctrs,
                                           float* out, int n, void* stream) {
  slda::counter_uniform_kernel<<<(n + 255) / 256, 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      seeds, ctrs, out, n);
  return static_cast<int>(cudaGetLastError());
}
