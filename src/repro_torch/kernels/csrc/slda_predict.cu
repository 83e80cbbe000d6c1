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
// * lane (the main path: the dense draw at T <= 16).  Each lane walks one
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
//   z lives in shared memory for the launch, one byte a token
//   (T <= 256): read from z0 once, written to z_out once; padding keeps
//   its topic, as the reference's masked update does, whether or not the
//   mask is a prefix.  φ̂ is frozen for the launch, so a token's row,
//   word, mask, old topic and uniform depend on no draw: the next
//   token's row (a scattered 64-byte read from L2) and the word after it
//   are loaded while this token draws, and the chain holds only the
//   count update, T products, T dependent adds, the compares and the
//   add back.
//
// * warp (the kernel the lane variant replaced, and the sparse draw and
//   T > 16): one warp per (chain, document) pair, lane j holding topic
//   t = j + 32k; it reads tokens, mask and z 32 positions at a time in
//   coalesced loads and broadcasts them by shuffle, loads the word's φ̂
//   row on the chain, stages p in shared memory for the prefix sum and
//   counts by ballot, so at T = 16 half of its lanes carry p = 0.
//
// Both draw alike, bit for bit: the same expressions in the same order,
// the prefix strictly left to right with the total the chain over all T
// (the order in which the plain version's `p @ triu(T)` accumulates), and
// z = #{t : c_t < u·total}.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch
// at slda_predict.py:172-178) run on the warp variant and draw through
// `draw_topic_sparse` against each chain's topic index of φ̂ (idx, vmask
// [M, W, cap], occm [M, W, T]), read per token beside the φ̂ row;
// everything else is the dense kernel.
#include "slda_common.cuh"

namespace slda {

// ---------------------------------------------------------------------------
// warp

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
// shared memory: each warp's z, one byte a token, [N][32 lanes].
template <bool EXACT>
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
                    int n_samples, int ctr_stride, float inv_samples) {
  constexpr int TM = kLaneTopics;
  extern __shared__ uint8_t z_shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g0 = (blockIdx.x * kWarpsPerBlock + warp) * 32;
  if (g0 >= D) return;  // warp-uniform
  const int c = blockIdx.y;
  const int docs = min(32, D - g0);  // the warp's documents
  uint8_t* zs = z_shared + static_cast<size_t>(warp) * 32 * N;
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
    // token 0's row, mask and old topic, token 1's word and mask
    float row_c[TM];
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
      if (live && steps > 1) {
        w_1 = tk[D];
        m_1 = mk[D];
      }
    }
    for (int n = 0; n < steps; ++n) {  // warp-uniform
      // off the chain: the next token's row and old topic (this sweep
      // writes position n only), the word after it, this token's uniform
      float row_n[TM];
      load_row<EXACT>(row_n, phi, w_1, T);
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
        float cp[TM];
        float total = 0.f;
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          if (t == z_old) nd[t] = nd[t] - m_c;
          const float p = EXACT || t < T ? (nd[t] + alpha) * row_c[t] : 0.f;
          total = total + p;  // left to right; past T it adds zeros
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
        const int z_new = below[0];
#pragma unroll
        for (int t = 0; t < TM; ++t)
          if (t == z_new) nd[t] = nd[t] + m_c;
        zs[n * 32 + lane] = static_cast<uint8_t>(z_new);
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) row_c[t] = row_n[t];
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

// variant 0: warp (any T <= 256, dense or sparse); 1: lane (the dense
// draw at T <= 16, with the wrapper's lane_layout, tok_t and msk_t
// [N, D], and N <= 1816, so that 4 warps' z fit 227 KB)
extern "C" int slda_predict_sweeps_launch(
    const int* tokens, const float* mask, const int* seeds, const int* z0,
    const float* ndt0, const float* phi_t, float* ndt_avg, int* z_out, int M,
    int D, int N, int T, int W, float alpha, int n_burnin, int n_samples,
    int ctr_stride, float inv_samples, const int* idx, const float* vmask,
    const float* occm, int cap, int variant, const int* tok_t,
    const float* msk_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    // int offsets: a position's column n·D + g and a word's row w·T
    if (idx || T < 1 || T > slda::kLaneTopics || !tok_t || !msk_t ||
        static_cast<long long>(N) * D >= (1LL << 31) ||
        static_cast<long long>(W) * T >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(slda::kWarpsPerBlock) * 32 * N;
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const int lanes = slda::kWarpsPerBlock * 32;
    const dim3 grid((D + lanes - 1) / lanes, M);
#define SLDA_PREDICT_LANE(EXACT)                                            \
  do {                                                                      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          slda::predict_lane_kernel<EXACT>,                                 \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(smem));                                          \
      if (e != cudaSuccess) return static_cast<int>(e);                     \
    }                                                                       \
    slda::predict_lane_kernel<EXACT><<<grid, lanes, smem, st>>>(            \
        tok_t, msk_t, seeds, z0, ndt0, phi_t, ndt_avg, z_out, D, N,         \
        T, W, alpha, n_burnin, n_samples, ctr_stride, inv_samples);         \
  } while (0)
    if (T == slda::kLaneTopics) SLDA_PREDICT_LANE(true);
    else SLDA_PREDICT_LANE(false);
#undef SLDA_PREDICT_LANE
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock, M);
  const dim3 block(slda::kWarpsPerBlock * 32);
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
