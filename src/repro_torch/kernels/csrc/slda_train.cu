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
// What bounds it on the card: the latency of the sequential token chain,
// as in B1/B2 (a dependent row load from the table in L2, the exp (or
// three logs) per topic, a warp max, the left-to-right prefix sum and a
// ballot per token), not bytes or operations.  The design:
//  * one CTA per (chain, doc block): the block is the delayed-count
//    partition, so it is semantics, not tiling.  The grid has only M·B
//    CTAs (24 at the MD&A slice), far below the card's 132 SMs; that is
//    the price of the semantics.
//  * the private table does not fit on chip (271 KB at W=4238, T=16, more
//    than an SM's 227 KB of shared memory), so it lives in a global
//    scratch [M, B, W, T] that the wrapper allocates, and is served from
//    L2 (loads with __ldcg, updates with atomicAdd at L2).  nt lives in
//    shared memory.  All updates are ±1 on integers below 2^24, so
//    atomics in any order are exact and equal the reference's scatter.
//  * inside the CTA, B2's per-document design: one warp per document at a
//    time (each warp walks several documents of the block), topic t in
//    lane t mod 32, ndt / nt / η in registers, padding tokens skipped by
//    a ballot.  z ping-pongs between z_out and z_buf so that the refresh
//    sees each token's sweep-start and new topic; ndt is kept in ndt_out
//    between sweeps.  Order: sweep, __syncthreads, deltas, __syncthreads.
// It is built without fused multiply-add contraction so that each
// expression rounds as the plain version's separate tensor operations do.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch
// at slda_train.py:179-187) draw through `draw_topic_sparse` against the
// chain's LAUNCH-frozen topic index (idx, vmask [M, W, cap], occm
// [M, W, T], built by the caller from the entry ntw_t): every doc block of
// the chain reads the same index, which the between-sweep deltas never
// touch.  The warp's staging grows from K·32 to 2·K·32 + 16 floats, which
// keeps the static shared memory under 48 KB (33.8 KB at K = 8 with 16
// warps): the residual reuses p's stage, and the prefix sums stay in
// registers.
#include "slda_common.cuh"

namespace slda {

template <int K, int WARPS, bool SPARSE>
__global__ void __launch_bounds__(WARPS * 32)
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
                    const int* __restrict__ idx,        // [M, W, cap]
                    const float* __restrict__ vmask,    // [M, W, cap]
                    const float* __restrict__ occm,     // [M, W, T]
                    int cap) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x, c = blockIdx.y;
  __shared__ float stage[WARPS][SPARSE ? 2 * K * 32 + 16 : K * 32];
  __shared__ float nt_s[K * 32];
  float* sp = stage[warp];
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
        while (real) {  // real tokens of this chunk, in document order
          const int j = __ffs(real) - 1;
          real &= real - 1;
          const int w = __shfl_sync(kFull, w_l, j);
          const float m = __shfl_sync(kFull, m_l, j);
          const int z_old = __shfl_sync(kFull, z_l, j);
          const float u = counter_uniform(seed, ctr0 + n0 + j);
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
            const size_t r = static_cast<size_t>(c) * W + w;
            z_new = draw_topic_sparse<K>(p, u, lane, T, sp, idx + r * cap,
                                         vmask + r * cap, occm + r * T, cap);
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

}  // namespace slda

extern "C" int slda_train_sweeps_launch(
    const int* tokens, const float* mask, const int* seeds, const int* z0,
    const float* ndt0, const float* y, const float* inv_len,
    const float* ntw_t, const float* nt, const float* eta, int* z_out,
    float* ndt_out, int* z_buf, float* local, int M, int D, int N, int T,
    int W, int doc_block, int n_sweeps, int ctr_stride, float alpha,
    float beta, float w_beta, float rho, int supervised, int product_form,
    const int* idx, const float* vmask, const float* occm, int cap,
    void* stream) {
  const dim3 grid((D + doc_block - 1) / doc_block, M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a null idx is the dense draw; else the sparse one over cap <= T slots
#define SLDA_TRAIN_AS(K, WARPS, SPARSE)                                     \
  slda::train_sweeps_kernel<K, WARPS, SPARSE>                               \
      <<<grid, (WARPS) * 32, 0, st>>>(                                      \
          tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t, nt, eta, z_out, \
          ndt_out, z_buf, local, D, N, T, W, doc_block, n_sweeps,           \
          ctr_stride, alpha, beta, w_beta, rho, supervised, product_form,   \
          idx, vmask, occm, cap)
#define SLDA_TRAIN(K, WARPS)                                                \
  if (idx) SLDA_TRAIN_AS(K, WARPS, true);                                   \
  else SLDA_TRAIN_AS(K, WARPS, false)
  switch ((T + 31) / 32) {
    case 1: SLDA_TRAIN(1, 32); break;
    case 2: SLDA_TRAIN(2, 32); break;
    case 3: SLDA_TRAIN(3, 16); break;
    case 4: SLDA_TRAIN(4, 16); break;
    case 5: SLDA_TRAIN(5, 16); break;
    case 6: SLDA_TRAIN(6, 16); break;
    case 7: SLDA_TRAIN(7, 16); break;
    case 8: SLDA_TRAIN(8, 16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLDA_TRAIN
#undef SLDA_TRAIN_AS
  return static_cast<int>(cudaGetLastError());
}
