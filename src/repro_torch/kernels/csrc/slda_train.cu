// Kernel B3: all `n_sweeps` supervised training sweeps of one fused
// launch, with the block-local delayed-count refresh, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_train_kernel` of src/repro/kernels/slda_train.py
// (launched by `slda_train_sweeps_chains_pallas`, grid (M, D/DB)).  Each
// doc block of DB documents of a chain carries a private copy of its
// chain's topic-word table ntw_t [W, T] and of nt.  Every sweep runs each
// document of the block against the block's sweep-frozen copy; between
// sweeps (not after the last) the block's own ±1 reassignments land on
// its copy and nt.  Per real token, in document order: remove the
// token's topic from ndt and from the running s = Σ_t η_t·ndt_t, form
//   product form  p_t = (ndt_t + α)·((ntw[w,t] − old_t) + β)
//                       / ((nt_t − old_t) + Wβ) · exp(g_t − max g),
//                 g_t = −0.5·(y − (s + η_t)·il)² / ρ;
//   log form      p_t = exp(logp_t − max logp), logp as kernel B2's;
// draw z = #{t : prefix_t(p) < u·Σp} with u = counter_uniform(seed_d,
// s·ctr_stride + n), and add the new topic back.  Padding tokens keep
// their topic.  The global ntw_t and nt are inputs only; the caller
// refreshes them from (z0, z_final).
//
// What bounds it on the card: neither bytes nor operations but the
// critical path, the dependent token steps of the longest walk (the real
// tokens one group of lanes draws in turn, times the sweeps), times the
// latency of a step (the p_t arithmetic with its divide and exp, a
// group max, the left-to-right prefix sum through shared memory, a
// ballot).  Two variants, named by the wrapper:
//
// * cluster (the main path).  A doc block is split across a thread-block
//   cluster of up to 8 CTAs of 16 warps (8 above T = 256) on neighbouring
//   SMs
//   (cudaLaunchKernelEx with a cluster dimension; Hopper only), so the
//   grid grows from M·B CTAs to M·B·cluster.  Documents go to (CTA, warp,
//   group) slots by a table the wrapper builds (`slda_train.slot_plan`):
//   at T <= 16 (dense or sparse draw) each half-warp is a group that
//   walks its own document, topic t in lane t of the half, with the max,
//   prefix sum and ballot per half; else a group is the whole warp, topic
//   t in lane t mod 32, slot t / 32, as before.  At the MD&A slice that is one
//   document a group where the replaced kernel walked about four a warp.
//   The block's private table stays one copy per block in the global
//   scratch `local` (271 KB at W = 4238, T = 16, more than an SM holds),
//   filled by all CTAs of the cluster, read through L2; nt is kept once
//   per cluster, in the shared memory of the cluster's first CTA, which
//   every CTA copies at the start of a sweep and to which each CTA adds
//   its deltas, summed in its own shared memory first, one remote add a
//   topic (distributed shared memory; a remote add a token onto T hot
//   floats cost 1.28 against 0.91 ms a launch at the MD&A slice on an
//   H100, by chip_smoke.py).
//   Cluster barriers stand
//   between the sweep and the deltas and between the deltas and the next
//   sweep.  Deltas stay ±1 on integer-valued floats below 2^24, so any
//   order of atomics is exact.  Off the dependent chain: within a sweep
//   the block's table is frozen, so everything of the next real token but
//   the counts (its lane, word, mask, old topic and that topic's η, its
//   uniform and its table row) is gathered while this token draws, and
//   the next window's words, masks and topics a window ahead; η comes
//   from registers by shuffle, not from memory.  The draws are those of
//   the replaced kernel bit for bit: the same expressions, the same
//   left-to-right prefix sum, the same butterfly for the starting s (a
//   half-warp's butterfly equals the warp's when lanes 16-31 add zeros).
//
// * block (the kernel the cluster variant replaced, kept to time it
//   beside it): one CTA per (chain, doc block), each warp walking the
//   block's documents d0 + warp, + 32, ... one after the other, every
//   token's table row loaded from L2 on the dependent chain.
//
// It is built without fused multiply-add contraction so that each
// expression rounds as the plain version's separate tensor operations do.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch
// at slda_train.py:179-187) draw through kernel B4 against the chain's
// LAUNCH-frozen topic index (built by the caller from the entry ntw_t),
// packed by the launcher's first kernel into one record a (chain, word)
// (`pack_topic_index`: 16 bytes at T <= 16): every doc block of the chain
// reads the same records, which the between-sweep deltas never touch.
// The cluster variant walks them in its groups as the dense draw does (a
// half-warp a document at T <= 16, `draw_topic_sparse_half`; a warp above,
// `draw_topic_sparse`), each token's record gathered with its table row
// (above T = 16 copied into the warp's stage by cp.async) while the token
// before it draws; the block variant walks a warp a document and copies a
// word's record into its stage while the token before it draws.  A warp's
// stage is dynamic shared memory (`sparse_stage_floats` floats a warp
// above T = 16: 53.5 KB an 8-warp CTA at T = 512, cap 32).

#include <cooperative_groups.h>

#include "slda_common.cuh"

namespace slda {

// ---------------------------------------------------------------------------
// block

template <int K, int WARPS, bool SPARSE>
__global__ void __launch_bounds__(WARPS * 32, 1)
train_sweeps_kernel(const int* __restrict__ tokens,     // [M, D, N]
                    const float* __restrict__ mask,     // [M, D, N]
                    const int* __restrict__ seeds,      // [M, D]
                    const int* z0,                      // [M, D, N]
                    const float* ndt0,                  // [M, D, T]
                    const float* __restrict__ y,        // [M, D]
                    const float* __restrict__ inv_len,  // [M, D]
                    const float* __restrict__ ntw_t,    // [M, W, T]
                    const float* __restrict__ nt,       // [M, T]
                    const float* __restrict__ eta,      // [M, T]
                    int* z_out,                         // [M, D, N]
                    float* ndt_out,                     // [M, D, T]
                    int* z_buf,                         // [M, D, N]
                    float* local,                       // [M, B, W, T]
                    int D, int N, int T, int W, int doc_block, int n_sweeps,
                    int ctr_stride, float alpha, float beta, float w_beta,
                    float rho, int supervised, int product_form,
                    const uint32_t* __restrict__ rec,   // [M, W, rw]
                    int cap, int stride) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x, c = blockIdx.y;
  extern __shared__ float warp_stage[];  // `stride` floats a warp
  __shared__ float nt_s[K * 32];
  float* sp = warp_stage + warp * stride;
  const int rw = SPARSE ? rec_words(T, cap) : 0;
  const uint32_t* recs = rec + static_cast<size_t>(c) * W * rw;
  const int d0 = b * doc_block;
  const int d1 = min(d0 + doc_block, D);
  const float* eta_c = eta + static_cast<size_t>(c) * T;
  const size_t table_size = static_cast<size_t>(W) * T;
  const float* table_in = ntw_t + static_cast<size_t>(c) * table_size;
  float* table_loc =
      local + (static_cast<size_t>(c) * gridDim.x + b) * table_size;

  // the block's private copies of its chain's table and nt
  if (n_sweeps > 1)
    for (size_t i = threadIdx.x; i < table_size; i += blockDim.x)
      __stcg(table_loc + i, table_in[i]);
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    nt_s[t] = nt[static_cast<size_t>(c) * T + t];
  __syncthreads();
  const float* table = n_sweeps > 1 ? table_loc : table_in;

  float eta_r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    eta_r[k] = t < T ? eta_c[t] : 0.f;
  }

  int rb = 0;  // the stage's record buffer of the token drawn next
  const int* z_src = z0;
  for (int s = 0; s < n_sweeps; ++s) {
    // the last sweep writes z_out; earlier ones alternate with z_buf
    int* z_dst = (n_sweeps - 1 - s) % 2 == 0 ? z_out : z_buf;
    const float* nd_src = s == 0 ? ndt0 : ndt_out;
    const uint32_t ctr0 = static_cast<uint32_t>(s) *
                          static_cast<uint32_t>(ctr_stride);
    float nt_r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = lane + 32 * k;
      nt_r[k] = t < T ? nt_s[t] : 0.f;
    }

    for (int d = d0 + warp; d < d1; d += WARPS) {  // warp-uniform
      const size_t row = static_cast<size_t>(c) * D + d;
      float nd[K];
      float s_part = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = lane + 32 * k;
        nd[k] = t < T ? nd_src[row * T + t] : 0.f;
        s_part += nd[k] * eta_r[k];
      }
      float st = warp_sum(s_part);  // running Σ_t η_t ndt_t
      const float yd = y[row];
      const float il = inv_len[row];
      const uint32_t seed = static_cast<uint32_t>(seeds[row]);

      for (int n0 = 0; n0 < N; n0 += 32) {
        const int n = n0 + lane;
        const bool in = n < N;
        const size_t at = row * N + n;
        const int w_l = in ? tokens[at] : 0;
        const float m_l = in ? mask[at] : 0.f;
        int z_l = in ? z_src[at] : 0;
        unsigned real = __ballot_sync(kFull, m_l > 0.f);
        // the record of the chunk's first real token (on the chain), then
        // each next one's while this token draws
        if constexpr (SPARSE) {
          const int w0 = __shfl_sync(kFull, w_l, real ? __ffs(real) - 1 : 0);
          fetch_record(stage_record(sp, T, cap, rb),
                       recs + static_cast<size_t>(w0) * rw, lane, rw,
                       real != 0);
        }
        while (real) {  // real tokens of this chunk, in document order
          const int j = __ffs(real) - 1;
          real &= real - 1;
          const int w = __shfl_sync(kFull, w_l, j);
          const float m = __shfl_sync(kFull, m_l, j);
          const int z_old = __shfl_sync(kFull, z_l, j);
          const float u = counter_uniform(seed, ctr0 + n0 + j);
          if constexpr (SPARSE) {
            const int wn =
                __shfl_sync(kFull, w_l, real ? __ffs(real) - 1 : 0);
            fetch_record(stage_record(sp, T, cap, rb ^ 1),
                         recs + static_cast<size_t>(wn) * rw, lane, rw,
                         real != 0);
          }
          st = st - eta_c[z_old] * m;
          const float* trow = table + static_cast<size_t>(w) * T;
          float p[K];
          if (product_form) {
            float g[K];
            float gmax = -INFINITY;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int t = lane + 32 * k;
              const float old = t == z_old ? m : 0.f;
              nd[k] = nd[k] - old;
              p[k] = 0.f;
              g[k] = 0.f;
              if (t < T) {
                p[k] = ((nd[k] + alpha) * ((__ldcg(trow + t) - old) + beta))
                       / ((nt_r[k] - old) + w_beta);
                if (supervised) {
                  const float e = yd - (st + eta_r[k]) * il;
                  g[k] = (-0.5f * (e * e)) / rho;
                  gmax = fmaxf(gmax, g[k]);
                }
              }
            }
            if (supervised) {
              gmax = warp_max(gmax);
#pragma unroll
              for (int k = 0; k < K; ++k)
                if (lane + 32 * k < T) p[k] = p[k] * expf(g[k] - gmax);
            }
          } else {
            float lp[K];
            float mx = -INFINITY;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int t = lane + 32 * k;
              const float old = t == z_old ? m : 0.f;
              nd[k] = nd[k] - old;
              lp[k] = -INFINITY;
              if (t < T) {
                float l = (logf(nd[k] + alpha) +
                           logf((__ldcg(trow + t) - old) + beta)) -
                          logf((nt_r[k] - old) + w_beta);
                if (supervised) {
                  const float e = yd - (st + eta_r[k]) * il;
                  l = l - (0.5f * (e * e)) / rho;
                }
                lp[k] = l;
                mx = fmaxf(mx, l);
              }
            }
            mx = warp_max(mx);
#pragma unroll
            for (int k = 0; k < K; ++k)
              p[k] = lane + 32 * k < T ? expf(lp[k] - mx) : 0.f;
          }
          int z_new;
          if constexpr (SPARSE) {
            record_wait<1>();  // this token's record (the next in flight)
            z_new = draw_topic_sparse<K>(p, u, lane, T, cap, sp,
                                         stage_record(sp, T, cap, rb));
            rb ^= 1;
          } else {
            z_new = draw_topic<K>(p, u, lane, T, sp);
          }
#pragma unroll
          for (int k = 0; k < K; ++k)
            nd[k] = nd[k] + (lane + 32 * k == z_new ? m : 0.f);
          st = st + eta_c[z_new] * m;
          if (lane == j) z_l = z_new;
        }
        if (in) z_dst[at] = z_l;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = lane + 32 * k;
        if (t < T) ndt_out[row * T + t] = nd[k];
      }
    }

    if (s + 1 < n_sweeps) {
      __syncthreads();  // every document of the block has swept
      // the block's own ±1 reassignments land on its private copies
      for (int d = d0 + warp; d < d1; d += WARPS) {
        const size_t row = static_cast<size_t>(c) * D + d;
        for (int n = lane; n < N; n += 32) {
          const size_t at = row * N + n;
          const float m = mask[at];
          const int zo = z_src[at], zn = z_dst[at];
          if (m > 0.f && zo != zn) {
            float* trow = table_loc + static_cast<size_t>(tokens[at]) * T;
            atomicAdd(trow + zo, -m);
            atomicAdd(trow + zn, m);
            atomicAdd(nt_s + zo, -m);
            atomicAdd(nt_s + zn, m);
          }
        }
      }
      __syncthreads();
    }
    z_src = z_dst;
  }
}

// ---------------------------------------------------------------------------
// cluster

// G lanes draw one document (G = 16: two documents a warp, T <= 16, K =
// 1, dense or sparse; G = 32: one, K topics a lane); `slots` [B, cluster,
// WARPS, 32 / G, per_slot] names each group's documents (-1: none).
// Dynamic shared memory: each warp's stage, `stride` floats.
// At K = 1 two CTAs share an SM (64 registers a thread), so that a doc
// block's 8-CTA cluster fits the card in one wave at T <= 32; the sparse
// half-warp draw's token (its 16-byte record twice) needs more, and its
// clusters are half as wide, so it keeps one CTA an SM.
template <int K, int WARPS, bool SPARSE, int G>
__global__ void __launch_bounds__(WARPS * 32,
                                  K == 1 && !(SPARSE && G == 16) ? 2 : 1)
train_cluster_kernel(const int* __restrict__ tokens,     // [M, D, N]
                     const float* __restrict__ mask,     // [M, D, N]
                     const int* __restrict__ seeds,      // [M, D]
                     const int* z0,                      // [M, D, N]
                     const float* ndt0,                  // [M, D, T]
                     const float* __restrict__ y,        // [M, D]
                     const float* __restrict__ inv_len,  // [M, D]
                     const float* __restrict__ ntw_t,    // [M, W, T]
                     const float* __restrict__ nt,       // [M, T]
                     const float* __restrict__ eta,      // [M, T]
                     int* z_out,                         // [M, D, N]
                     float* ndt_out,                     // [M, D, T]
                     int* z_buf,                         // [M, D, N]
                     float* local,                       // [M, B, W, T]
                     int D, int N, int T, int W, int n_sweeps,
                     int ctr_stride, float alpha, float beta, float w_beta,
                     float rho, int supervised, int product_form,
                     const uint32_t* __restrict__ rec,   // [M, W, rw]
                     int cap, const int* __restrict__ slots, int per_slot,
                     int stride) {
  static_assert(G == 32 || (G == 16 && K == 1), "groups");
  constexpr int NG = 32 / G;  // documents a warp walks at once
  // a token's record words a lane holds: the whole 16-byte record in a
  // half-warp group (T <= 16); a warp's tokens' records go to its stage
  // (`fetch_record`), in its two buffers by turns
  constexpr int RN = G == 16 ? 4 : 1;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G, shift = grp * G;
  const int b = blockIdx.x / cs, c = blockIdx.y;
  const int n_blocks = gridDim.x / cs;
  extern __shared__ float warp_stage[];
  __shared__ float nt_s[K * 32];  // the first CTA: the cluster's nt; others
                                  // a copy of it for the sweep
  __shared__ float nt_d[K * 32];  // this CTA's nt deltas of a sweep
  float* sp = warp_stage + warp * stride +
              (G == 16 ? (SPARSE ? 32 : 16) * grp : 0);
  const int rw = SPARSE ? rec_words(T, cap) : 0;
  const uint32_t* recs = rec + static_cast<size_t>(c) * W * rw;
  float* nt_master = cluster.map_shared_rank(nt_s, 0);
  const float* eta_c = eta + static_cast<size_t>(c) * T;
  const size_t table_size = static_cast<size_t>(W) * T;
  const float* table_in = ntw_t + static_cast<size_t>(c) * table_size;
  float* table_loc =
      local + (static_cast<size_t>(c) * n_blocks + b) * table_size;
  const int* my_slots =
      slots + ((static_cast<size_t>(b) * cs + rank) * WARPS + warp) * NG *
                  per_slot;

  // the block's private copies of its chain's table (filled by the whole
  // cluster) and nt (in the first CTA)
  if (n_sweeps > 1)
    for (size_t i = static_cast<size_t>(rank) * blockDim.x + threadIdx.x;
         i < table_size; i += static_cast<size_t>(cs) * blockDim.x)
      __stcg(table_loc + i, table_in[i]);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    if (rank == 0) nt_s[t] = nt[static_cast<size_t>(c) * T + t];
    nt_d[t] = 0.f;
  }
  cluster.sync();
  const float* table = n_sweeps > 1 ? table_loc : table_in;

  float eta_r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = gl + G * k;
    eta_r[k] = t < T ? eta_c[t] : 0.f;
  }

  const int* z_src = z0;
  for (int s = 0; s < n_sweeps; ++s) {
    // the last sweep writes z_out; earlier ones alternate with z_buf
    int* z_dst = (n_sweeps - 1 - s) % 2 == 0 ? z_out : z_buf;
    const float* nd_src = s == 0 ? ndt0 : ndt_out;
    const uint32_t ctr0 = static_cast<uint32_t>(s) *
                          static_cast<uint32_t>(ctr_stride);
    if (rank != 0) {
      for (int t = threadIdx.x; t < T; t += blockDim.x) nt_s[t] = nt_master[t];
      __syncthreads();
    }
    float nt_r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = gl + G * k;
      nt_r[k] = t < T ? nt_s[t] : 0.f;
    }

    for (int e = 0; e < per_slot; ++e) {  // warp-uniform
      const int d = my_slots[grp * per_slot + e];
      const bool has = d >= 0;
      const size_t row = has ? static_cast<size_t>(c) * D + d : 0;
      float nd[K];
      float s_part = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = gl + G * k;
        nd[k] = has && t < T ? nd_src[row * T + t] : 0.f;
        s_part += nd[k] * eta_r[k];
      }
      float st = group_sum<G>(s_part);  // running Σ_t η_t ndt_t
      const float yd = has ? y[row] : 0.f;
      const float il = has ? inv_len[row] : 0.f;
      const uint32_t seed = has ? static_cast<uint32_t>(seeds[row]) : 0u;

      // The window of G positions at n0 (words, masks, topics a lane) and
      // its real tokens.  `cur` is the token this group draws next, its
      // lane, word, mask, old topic and η, uniform, table row and (sparse)
      // record gathered while the token before it drew: none of them
      // depends on this sweep's draws (the block's table and the index are
      // frozen within a sweep).
      int w_l = 0, z_l = 0;
      float m_l = 0.f;
      if (has && gl < N) {
        const size_t at = row * N + gl;
        w_l = tokens[at];
        m_l = mask[at];
        z_l = z_src[at];
      }
      unsigned bits = group_bits<G>(__ballot_sync(kFull, m_l > 0.f), shift);
      struct Tok {
        int j, w, z_old, rb;
        float m, eta_old, u, row[K];
        uint32_t rec[RN];
      };
      // the first token of `b` among the lane values (wv, mv, zv) of the
      // window at `base`, its record (G = 32) copied to the stage's buffer
      // rb; every lane calls it (it shuffles and commits a copy group), and
      // a group with no token (b == 0) loads nothing
      auto peek = [&](unsigned b, int wv, float mv, int zv, int base,
                      int rb) {
        Tok k_;
        k_.j = b ? __ffs(b) - 1 : 0;
        k_.rb = rb;
        k_.w = __shfl_sync(kFull, wv, k_.j, G);
        k_.m = __shfl_sync(kFull, mv, k_.j, G);
        k_.z_old = __shfl_sync(kFull, zv, k_.j, G);
        k_.eta_old = eta_of<K, G>(eta_r, k_.z_old);
        k_.u = counter_uniform(seed, ctr0 + base + k_.j);
        const float* r = table + static_cast<size_t>(k_.w) * T;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int t = gl + G * k;
          k_.row[k] = b && t < T ? __ldcg(r + t) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < RN; ++q) k_.rec[q] = 0u;
        if constexpr (SPARSE) {
          const uint32_t* rr = recs + static_cast<size_t>(k_.w) * rw;
          if constexpr (G == 16) {
            if (b) {
              const uint4 v = __ldg(reinterpret_cast<const uint4*>(rr));
              k_.rec[0] = v.x;
              k_.rec[1] = v.y;
              k_.rec[2] = v.z;
              k_.rec[3] = v.w;
            }
          } else {
            fetch_record(stage_record(sp, T, cap, rb), rr, gl, rw, b != 0);
          }
        }
        return k_;
      };
      Tok cur;
      cur.rb = 1;
      bool have = false;  // cur is this window's first token already
      for (int n0 = 0; n0 < N; n0 += G) {  // warp-uniform
        {
          const Tok first =
              peek(have ? 0u : bits, w_l, m_l, z_l, n0, cur.rb ^ 1);
          if (!have) cur = first;
          have = false;
        }
        bool cv = bits != 0;                // cur is a token to draw
        unsigned rest = bits & (bits - 1);  // the window's tokens after it
        // the next window, a window ahead
        const int nn = n0 + G + gl;
        int w_n = 0, z_n = 0;
        float m_n = 0.f;
        if (has && nn < N) {
          const size_t at = row * N + nn;
          w_n = tokens[at];
          m_n = mask[at];
          z_n = z_src[at];
        }
        while (__any_sync(kFull, cv)) {
          // the next token while this one draws: the next in this window,
          // else the first of the next window (once)
          const unsigned nreal =
              group_bits<G>(__ballot_sync(kFull, m_n > 0.f), shift);
          const bool more = rest != 0;
          const Tok nxt = peek(more ? rest : (have ? 0u : nreal),
                               more ? w_l : w_n, more ? m_l : m_n,
                               more ? z_l : z_n, more ? n0 : n0 + G,
                               cur.rb ^ 1);
          const float m = cv ? cur.m : 0.f;  // an idle group changes nothing
          const int z_old = cur.z_old;
          st = st - cur.eta_old * m;
          float p[K];
          if (product_form) {
            float g[K];
            float gmax = -INFINITY;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int t = gl + G * k;
              const float old = t == z_old ? m : 0.f;
              nd[k] = nd[k] - old;
              p[k] = 0.f;
              g[k] = 0.f;
              if (t < T) {
                p[k] = ((nd[k] + alpha) * ((cur.row[k] - old) + beta))
                       / ((nt_r[k] - old) + w_beta);
                if (supervised) {
                  const float e = yd - (st + eta_r[k]) * il;
                  g[k] = (-0.5f * (e * e)) / rho;
                  gmax = fmaxf(gmax, g[k]);
                }
              }
            }
            if (supervised) {
              gmax = group_max<G>(gmax);
#pragma unroll
              for (int k = 0; k < K; ++k)
                if (gl + G * k < T) p[k] = p[k] * expf(g[k] - gmax);
            }
          } else {
            float lp[K];
            float mx = -INFINITY;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int t = gl + G * k;
              const float old = t == z_old ? m : 0.f;
              nd[k] = nd[k] - old;
              lp[k] = -INFINITY;
              if (t < T) {
                float l = (logf(nd[k] + alpha) +
                           logf((cur.row[k] - old) + beta)) -
                          logf((nt_r[k] - old) + w_beta);
                if (supervised) {
                  const float e = yd - (st + eta_r[k]) * il;
                  l = l - (0.5f * (e * e)) / rho;
                }
                lp[k] = l;
                mx = fmaxf(mx, l);
              }
            }
            mx = group_max<G>(mx);
#pragma unroll
            for (int k = 0; k < K; ++k)
              p[k] = gl + G * k < T ? expf(lp[k] - mx) : 0.f;
          }
          int z_new;
          if constexpr (SPARSE && G == 16) {
            z_new = draw_topic_sparse_half(
                p[0], cur.u, gl, T, cap, sp,
                make_uint4(cur.rec[0], cur.rec[1], cur.rec[2], cur.rec[3]),
                shift);
          } else if constexpr (SPARSE) {
            record_wait<1>();  // cur's record (nxt's in flight)
            z_new = draw_topic_sparse<K>(p, cur.u, lane, T, cap, sp,
                                         stage_record(sp, T, cap, cur.rb));
          } else if constexpr (G == 16) {
            z_new = draw_topic_half(p[0], cur.u, gl, T, sp, shift);
          } else {
            z_new = draw_topic<K>(p, cur.u, lane, T, sp);
          }
#pragma unroll
          for (int k = 0; k < K; ++k)
            nd[k] = nd[k] + (gl + G * k == z_new ? m : 0.f);
          st = st + eta_of<K, G>(eta_r, z_new) * m;
          if (cv && gl == cur.j) z_l = z_new;
          if (more) {
            cur = nxt;
            rest &= rest - 1;
          } else {
            cv = false;
            if (nreal && !have) {
              cur = nxt;
              have = true;
            }
          }
        }
        if (has && n0 + gl < N) z_dst[row * N + n0 + gl] = z_l;
        w_l = w_n;
        m_l = m_n;
        z_l = z_n;
        bits = group_bits<G>(__ballot_sync(kFull, m_l > 0.f), shift);
      }
      if (has) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int t = gl + G * k;
          if (t < T) ndt_out[row * T + t] = nd[k];
        }
      }
    }

    if (s + 1 < n_sweeps) {
      cluster.sync();  // every document of the block has swept
      // the warp's documents' ±1 reassignments land on the block's table
      // copy, and summed over the CTA on the cluster's nt (integers below
      // 2^24: exact in any order)
      for (int q = 0; q < NG * per_slot; ++q) {
        const int d = my_slots[q];
        if (d < 0) continue;  // warp-uniform
        const size_t row = static_cast<size_t>(c) * D + d;
        for (int n = lane; n < N; n += 32) {
          const size_t at = row * N + n;
          const float m = mask[at];
          const int zo = z_src[at], zn = z_dst[at];
          if (m > 0.f && zo != zn) {
            float* trow = table_loc + static_cast<size_t>(tokens[at]) * T;
            atomicAdd(trow + zo, -m);
            atomicAdd(trow + zn, m);
            atomicAdd(nt_d + zo, -m);
            atomicAdd(nt_d + zn, m);
          }
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        if (nt_d[t] != 0.f) atomicAdd(nt_master + t, nt_d[t]);
        nt_d[t] = 0.f;
      }
      cluster.sync();
    }
    z_src = z_dst;
  }
  cluster.sync();  // the first CTA's nt outlives every read of it
}

}  // namespace slda

// variant 0: block; 1: cluster, with the wrapper's slot plan.  A
// non-null idx is the sparse draw over cap <= T slots: the launcher first
// packs (idx, vmask [M, W, cap], occm [M, W, T]) into `rec`
// [M, W, rec_words(T, cap)].
extern "C" int slda_train_sweeps_launch(
    const int* tokens, const float* mask, const int* seeds, const int* z0,
    const float* ndt0, const float* y, const float* inv_len,
    const float* ntw_t, const float* nt, const float* eta, int* z_out,
    float* ndt_out, int* z_buf, float* local, int M, int D, int N, int T,
    int W, int doc_block, int n_sweeps, int ctr_stride, float alpha,
    float beta, float w_beta, float rho, int supervised, int product_form,
    const int* idx, const float* vmask, const float* occm, int cap,
    int variant, const int* slots, int cluster, int groups, int per_slot,
    uint32_t* rec, void* stream) {
  const int n_blocks = (D + doc_block - 1) / doc_block;
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
  // a warp's stage: p and its prefixes for the dense draw
  // (`dense_stage_floats`), `sparse_stage_floats` for B4
  // (a half-warp group: 16 floats a half dense, 32 sparse)
  auto stride_of = [&](int G) {
    if (G == 16) return sparse ? 64 : 32;
    return sparse ? slda::sparse_stage_floats(T, cap)
                  : slda::dense_stage_floats(T);
  };
  if (variant == 0) {
    // block: one CTA per (chain, doc block), 32 warps up to T = 64, 16 up
    // to T = 256, else 8 (255 registers a thread for K = 16 slots)
    const dim3 grid(n_blocks, M);
#define SLDA_TRAIN_AS(K, SPARSE)                                            \
  do {                                                                      \
    constexpr int kW = K <= 2 ? 32 : K <= 8 ? 16 : 8;                       \
    const size_t smem = sizeof(float) * kW * stride_of(32);                 \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          slda::train_sweeps_kernel<K, kW, SPARSE>,                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(smem));                                          \
      if (e != cudaSuccess) return static_cast<int>(e);                     \
    }                                                                       \
    slda::train_sweeps_kernel<K, kW, SPARSE><<<grid, kW * 32, smem, st>>>(  \
        tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t, nt, eta, z_out,   \
        ndt_out, z_buf, local, D, N, T, W, doc_block, n_sweeps, ctr_stride, \
        alpha, beta, w_beta, rho, supervised, product_form, rec, cap,       \
        stride_of(32));                                                     \
  } while (0)
#define SLDA_TRAIN(K)                                                       \
  if (sparse) SLDA_TRAIN_AS(K, true); else SLDA_TRAIN_AS(K, false)
    SLDA_FOR_K(T, SLDA_TRAIN)
#undef SLDA_TRAIN
#undef SLDA_TRAIN_AS
    return static_cast<int>(cudaGetLastError());
  }
  // cluster: `slots` [n_blocks, cluster, warps, groups, per_slot] from the
  // wrapper's plan, 16 warps a CTA up to T = 256, else 8 (255 registers a
  // thread for K = 16 slots); two groups a warp at T <= 16
  if (variant != 1 || !slots || cluster < 1 || cluster > 8 || per_slot < 1 ||
      !(groups == 1 || (groups == 2 && T <= 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks * cluster, M);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaSuccess;
#define SLDA_CLUSTER_AS(K, SPARSE, G)                                       \
  do {                                                                      \
    constexpr int kWarps = K <= 8 ? 16 : 8;                                 \
    const int stride = stride_of(G);                                        \
    cfg.blockDim = dim3(kWarps * 32);                                       \
    cfg.dynamicSmemBytes = sizeof(float) * kWarps * stride;                 \
    if (cfg.dynamicSmemBytes > 48 * 1024) {                                 \
      e = cudaFuncSetAttribute(                                             \
          slda::train_cluster_kernel<K, kWarps, SPARSE, G>,                 \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(cfg.dynamicSmemBytes));                          \
      if (e != cudaSuccess) return static_cast<int>(e);                     \
    }                                                                       \
    e = cudaLaunchKernelEx(                                                 \
        &cfg, slda::train_cluster_kernel<K, kWarps, SPARSE, G>, tokens,     \
        mask, seeds, z0, ndt0, y, inv_len, ntw_t, nt, eta, z_out, ndt_out,  \
        z_buf, local, D, N, T, W, n_sweeps, ctr_stride, alpha, beta,        \
        w_beta, rho, supervised, product_form,                              \
        static_cast<const uint32_t*>(rec), cap, slots, per_slot, stride);   \
  } while (0)
#define SLDA_CLUSTER(K)                                                     \
  if (K == 1 && groups == 2) {                                              \
    if (sparse) SLDA_CLUSTER_AS(1, true, 16);                               \
    else SLDA_CLUSTER_AS(1, false, 16);                                     \
  } else if (sparse) {                                                      \
    SLDA_CLUSTER_AS(K, true, 32);                                           \
  } else {                                                                  \
    SLDA_CLUSTER_AS(K, false, 32);                                          \
  }
  SLDA_FOR_K(T, SLDA_CLUSTER)
#undef SLDA_CLUSTER
#undef SLDA_CLUSTER_AS
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
