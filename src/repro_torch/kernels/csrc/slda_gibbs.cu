// Kernel B2: one supervised collapsed-Gibbs training sweep, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_gibbs_kernel` of src/repro/kernels/slda_gibbs.py
// (launched by `slda_gibbs_sweep_pallas`, grid D/DB, chains vmapped by
// `ops.slda_gibbs_sweep`).  It computes the same sweep against the
// sweep-frozen tables ntw_t [W, T], nt and η (AD-LDA delayed counts): per
// real token, in document order, remove the token's topic from ndt and
// from the running s = Σ_t η_t·ndt_t, form
//   logp_t = log(ndt_t + α) + log(ntw_t[w] − old_t + β)
//            − log(nt_t − old_t + Wβ) − (y − (s + η_t)·il)² / 2ρ,
// p_t = exp(logp_t − max logp), draw z = #{t : prefix_t(p) < u·Σp} with
// the uniform u passed in, and add the new topic back.  Padding tokens
// keep their topic.
//
// What bounds it on the card: the latency of the sequential token chain
// (a dependent row load from the ntw table in L2, three logf and one expf
// per topic, a warp max, the left-to-right prefix sum of B1 and a ballot
// per token),
// not bytes or operations.  The design is that of kernel B1: one warp per
// (chain, document) so that every document of every chain advances at
// once; ndt, nt, η and s in registers; tokens, mask, z and uniforms read
// 32 positions at a time in coalesced loads and broadcast by shuffle;
// padding tokens skipped by a warp-uniform branch.  It is built without
// fused multiply-add contraction so that each expression rounds as the
// plain version's separate tensor operations do.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch
// at slda_gibbs.py:74-79) draw through `draw_topic_sparse` against the
// topic index of the sweep-frozen table (idx, vmask [M, W, cap], occm
// [M, W, T]); everything else is the dense kernel.
#include "slda_common.cuh"

namespace slda {

template <int K, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gibbs_sweep_kernel(const int* __restrict__ tokens,     // [M, D, N]
                   const float* __restrict__ mask,     // [M, D, N]
                   const float* __restrict__ uniforms, // [M, D, N]
                   const int* __restrict__ z,          // [M, D, N]
                   const float* __restrict__ ndt,      // [M, D, T]
                   const float* __restrict__ y,        // [M, D]
                   const float* __restrict__ inv_len,  // [M, D]
                   const float* __restrict__ ntw_t,    // [M, W, T]
                   const float* __restrict__ nt,       // [M, T]
                   const float* __restrict__ eta,      // [M, T]
                   int* __restrict__ z_out,            // [M, D, N]
                   float* __restrict__ ndt_out,        // [M, D, T]
                   int D, int N, int T, int W, float alpha, float beta,
                   float w_beta, float rho, int supervised,
                   const int* __restrict__ idx,        // [M, W, cap]
                   const float* __restrict__ vmask,    // [M, W, cap]
                   const float* __restrict__ occm,     // [M, W, T]
                   int cap) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= D) return;  // warp-uniform
  const int c = blockIdx.y;
  __shared__ float stage[kWarpsPerBlock]
                        [SPARSE ? 2 * kMaxTopics + 16 : kMaxTopics];
  float* sp = stage[threadIdx.x >> 5];
  const size_t row = static_cast<size_t>(c) * D + d;
  const float* table = ntw_t + static_cast<size_t>(c) * W * T;
  const float* eta_c = eta + static_cast<size_t>(c) * T;

  float nd[K], nt_r[K], eta_r[K];
  float s_part = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    nd[k] = t < T ? ndt[row * T + t] : 0.f;
    nt_r[k] = t < T ? nt[static_cast<size_t>(c) * T + t] : 0.f;
    eta_r[k] = t < T ? eta_c[t] : 0.f;
    s_part += nd[k] * eta_r[k];
  }
  float s = warp_sum(s_part);  // running Σ_t η_t ndt_t
  const float yd = y[row];
  const float il = inv_len[row];

  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    const bool in = n < N;
    const size_t at = row * N + n;
    const int w_l = in ? tokens[at] : 0;
    const float m_l = in ? mask[at] : 0.f;
    const float u_l = in ? uniforms[at] : 0.f;
    int z_l = in ? z[at] : 0;
    unsigned real = __ballot_sync(kFull, m_l > 0.f);
    while (real) {  // real tokens of this chunk, in document order
      const int j = __ffs(real) - 1;
      real &= real - 1;
      const int w = __shfl_sync(kFull, w_l, j);
      const float m = __shfl_sync(kFull, m_l, j);
      const int z_old = __shfl_sync(kFull, z_l, j);
      const float u = __shfl_sync(kFull, u_l, j);
      s = s - eta_c[z_old] * m;
      const float* trow = table + static_cast<size_t>(w) * T;
      float lp[K];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = lane + 32 * k;
        const float old = t == z_old ? m : 0.f;
        nd[k] = nd[k] - old;
        lp[k] = -INFINITY;
        if (t < T) {
          float l = (logf(nd[k] + alpha) + logf((trow[t] - old) + beta))
                    - logf((nt_r[k] - old) + w_beta);
          if (supervised) {
            const float mu = (s + eta_r[k]) * il;
            const float e = yd - mu;
            l = l - (0.5f * (e * e)) / rho;
          }
          lp[k] = l;
          mx = fmaxf(mx, l);
        }
      }
      mx = warp_max(mx);
      float p[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        p[k] = lane + 32 * k < T ? expf(lp[k] - mx) : 0.f;
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
      s = s + eta_c[z_new] * m;
      if (lane == j) z_l = z_new;
    }
    if (in) z_out[at] = z_l;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    if (t < T) ndt_out[row * T + t] = nd[k];
  }
}

}  // namespace slda

extern "C" int slda_gibbs_sweep_launch(
    const int* tokens, const float* mask, const float* uniforms, const int* z,
    const float* ndt, const float* y, const float* inv_len,
    const float* ntw_t, const float* nt, const float* eta, int* z_out,
    float* ndt_out, int M, int D, int N, int T, int W, float alpha,
    float beta, float w_beta, float rho, int supervised, const int* idx,
    const float* vmask, const float* occm, int cap, void* stream) {
  const dim3 grid((D + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock, M);
  const dim3 block(slda::kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a null idx is the dense draw; else the sparse one over cap <= T slots
#define SLDA_GIBBS_AS(K, SPARSE)                                            \
  slda::gibbs_sweep_kernel<K, SPARSE><<<grid, block, 0, st>>>(              \
      tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t, nt, eta, z_out,    \
      ndt_out, D, N, T, W, alpha, beta, w_beta, rho, supervised, idx,       \
      vmask, occm, cap)
#define SLDA_GIBBS(K)                                                       \
  if (idx) SLDA_GIBBS_AS(K, true); else SLDA_GIBBS_AS(K, false)
  switch ((T + 31) / 32) {
    case 1: SLDA_GIBBS(1); break;
    case 2: SLDA_GIBBS(2); break;
    case 3: SLDA_GIBBS(3); break;
    case 4: SLDA_GIBBS(4); break;
    case 5: SLDA_GIBBS(5); break;
    case 6: SLDA_GIBBS(6); break;
    case 7: SLDA_GIBBS(7); break;
    case 8: SLDA_GIBBS(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLDA_GIBBS
#undef SLDA_GIBBS_AS
  return static_cast<int>(cudaGetLastError());
}
