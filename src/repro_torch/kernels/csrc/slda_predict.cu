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
// What bounds it on the card: not bytes or operations, but the latency of
// the sequential token chain.  Each token's draw depends on the previous
// token's ndt, and each step is a dependent chain: broadcast the word id,
// load a φ̂ row (L2: the [W, T] table is ~270 KB per chain at W=4238,
// T=16), a left-to-right prefix sum over the T topics (staged in shared
// memory, in the order the plain version's matmul adds them, so that the
// two draw alike), a ballot.  The design gives every (chain, document)
// pair its own warp so that all of them advance at once (thousands of
// warps in flight hide each other's latency); keeps ndt and the
// post-burn-in sum in registers for all sweeps; reads tokens,
// mask and z 32 positions at a time in coalesced loads and broadcasts
// them by shuffle; and skips padding tokens with a warp-uniform branch
// (their z and ndt are left as they are, which is what the reference's
// masked update computes).  The token and mask tiles [D, N] are shared by
// all chains.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch
// at slda_predict.py:172-178) draw through `draw_topic_sparse` against
// each chain's topic index of φ̂ (idx, vmask [M, W, cap], occm [M, W, T]),
// read per token beside the φ̂ row; everything else is the dense kernel.
#include "slda_common.cuh"

namespace slda {

template <int K, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
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
                      const int* __restrict__ idx,      // [M, W, cap]
                      const float* __restrict__ vmask,  // [M, W, cap]
                      const float* __restrict__ occm,   // [M, W, T]
                      int cap) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= D) return;  // warp-uniform
  const int c = blockIdx.y;
  __shared__ float stage[kWarpsPerBlock]
                        [SPARSE ? 2 * kMaxTopics + 16 : kMaxTopics];
  float* sp = stage[threadIdx.x >> 5];
  const size_t row = static_cast<size_t>(c) * D + d;
  const int* tok = tokens + static_cast<size_t>(d) * N;
  const float* msk = mask + static_cast<size_t>(d) * N;
  const float* phi = phi_t + static_cast<size_t>(c) * W * T;
  int* zrow = z_out + row * N;
  const uint32_t seed = static_cast<uint32_t>(seeds[row]);

  float nd[K], acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    nd[k] = t < T ? ndt0[row * T + t] : 0.f;
    acc[k] = 0.f;
  }

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
      while (real) {  // real tokens of this chunk, in document order
        const int j = __ffs(real) - 1;
        real &= real - 1;
        const int w = __shfl_sync(kFull, w_l, j);
        const float m = __shfl_sync(kFull, m_l, j);
        const int z_old = __shfl_sync(kFull, z_l, j);
        const float u = __shfl_sync(kFull, u_l, j);
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
          const size_t r = static_cast<size_t>(c) * W + w;
          z_new = draw_topic_sparse<K>(p, u, lane, T, sp, idx + r * cap,
                                       vmask + r * cap, occm + r * T, cap);
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
      for (int k = 0; k < K; ++k) acc[k] = acc[k] + nd[k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    if (t < T) ndt_avg[row * T + t] = acc[k] * inv_samples;
  }
}

// The sparse two-stage draw alone, one warp per row of p [R, T] with its
// uniform and index rows (idx, vmask [R, cap], occm [R, T]): the device
// function the three sampler kernels draw with, exposed so that it can be
// held against its plain version and timed by itself.
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparse_draw_kernel(const float* __restrict__ p, const float* __restrict__ u,
                   const int* __restrict__ idx,
                   const float* __restrict__ vmask,
                   const float* __restrict__ occm, int* __restrict__ z,
                   int R, int T, int cap) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // warp-uniform
  __shared__ float stage[kWarpsPerBlock][2 * kMaxTopics + 16];
  const size_t row = static_cast<size_t>(r);
  float pr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + 32 * k;
    pr[k] = t < T ? p[row * T + t] : 0.f;
  }
  const int zr = draw_topic_sparse<K>(pr, u[r], lane, T,
                                      stage[threadIdx.x >> 5],
                                      idx + row * cap, vmask + row * cap,
                                      occm + row * T, cap);
  if (lane == 0) z[r] = zr;
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

extern "C" int slda_predict_sweeps_launch(
    const int* tokens, const float* mask, const int* seeds, const int* z0,
    const float* ndt0, const float* phi_t, float* ndt_avg, int* z_out, int M,
    int D, int N, int T, int W, float alpha, int n_burnin, int n_samples,
    int ctr_stride, float inv_samples, const int* idx, const float* vmask,
    const float* occm, int cap, void* stream) {
  const dim3 grid((D + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock, M);
  const dim3 block(slda::kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a null idx is the dense draw; else the sparse one over cap <= T slots
#define SLDA_PREDICT_AS(K, SPARSE)                                          \
  slda::predict_sweeps_kernel<K, SPARSE><<<grid, block, 0, st>>>(           \
      tokens, mask, seeds, z0, ndt0, phi_t, ndt_avg, z_out, D, N, T, W,     \
      alpha, n_burnin, n_samples, ctr_stride, inv_samples, idx, vmask,      \
      occm, cap)
#define SLDA_PREDICT(K)                                                     \
  if (idx) SLDA_PREDICT_AS(K, true); else SLDA_PREDICT_AS(K, false)
  switch ((T + 31) / 32) {
    case 1: SLDA_PREDICT(1); break;
    case 2: SLDA_PREDICT(2); break;
    case 3: SLDA_PREDICT(3); break;
    case 4: SLDA_PREDICT(4); break;
    case 5: SLDA_PREDICT(5); break;
    case 6: SLDA_PREDICT(6); break;
    case 7: SLDA_PREDICT(7); break;
    case 8: SLDA_PREDICT(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLDA_PREDICT
#undef SLDA_PREDICT_AS
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slda_sparse_draw_launch(const float* p, const float* u,
                                       const int* idx, const float* vmask,
                                       const float* occm, int* z, int R,
                                       int T, int cap, void* stream) {
  const dim3 grid((R + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock);
  const dim3 block(slda::kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SLDA_SPARSE_DRAW(K)                                                 \
  slda::sparse_draw_kernel<K><<<grid, block, 0, st>>>(p, u, idx, vmask,     \
                                                      occm, z, R, T, cap)
  switch ((T + 31) / 32) {
    case 1: SLDA_SPARSE_DRAW(1); break;
    case 2: SLDA_SPARSE_DRAW(2); break;
    case 3: SLDA_SPARSE_DRAW(3); break;
    case 4: SLDA_SPARSE_DRAW(4); break;
    case 5: SLDA_SPARSE_DRAW(5); break;
    case 6: SLDA_SPARSE_DRAW(6); break;
    case 7: SLDA_SPARSE_DRAW(7); break;
    case 8: SLDA_SPARSE_DRAW(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLDA_SPARSE_DRAW
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slda_counter_uniform_launch(const int* seeds, const int* ctrs,
                                           float* out, int n, void* stream) {
  slda::counter_uniform_kernel<<<(n + 255) / 256, 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      seeds, ctrs, out, n);
  return static_cast<int>(cudaGetLastError());
}
