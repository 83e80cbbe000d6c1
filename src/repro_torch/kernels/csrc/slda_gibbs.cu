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
// What bounds it on the card: not bytes or operations but the issue
// slots of the token steps (three logf, an expf and an IEEE divide a
// topic, a group max, the left-to-right prefix sum, a ballot) and the
// dependent chain of the longest document.  Two variants, named by the
// wrapper (`slda_gibbs.variant`):
//
// * half_warp (the main path at T <= 16, dense or sparse).  A half-warp
//   walks one document, topic t in lane t of the half, with the max, the
//   prefix sum and the ballot per half: B3's cluster group layout and its
//   `draw_topic_half`, so a warp instruction serves two documents.  The
//   logs that are functions of the launch's frozen inputs leave the
//   token loop: a first kernel of the launch tabulates
//   log((ntw_t[w,t] − 0) + β) and log((ntw_t[w,t] − 1) + β) per chain
//   ([M, W, 2T] scratch, one 128-byte row a word at T = 16), each CTA
//   log((nt_t − 0) + Wβ) and log((nt_t − 1) + Wβ) per topic, and
//   log(k + α) for the counts k < 256.  Each is the same logf of the same
//   float, so the same bits.  The half-warp walks its document one
//   position a step, up to the last real token of the warp's two
//   documents (a padding position's step changes nothing), with plain
//   loads ahead of the chain: a position's word, mask, old topic and
//   uniform two steps ahead, its row of logs one step ahead (a step is
//   longer than an L2 round trip).  Lane z_old takes the "− 1" entries
//   (a mask other than 0 or 1 computes its two logs afresh), and
//   log(ndt_t + α) is a table read wherever ndt_t is a count below 256.
//   η comes from registers by shuffle, not memory.  The supervised term,
//   its divide by ρ, the max, expf and the draw stay as they were.  What
//   bounds the step is its own dependent chain: the removal, the
//   supervised term and its divide, the group max's four shuffles, expf,
//   the 16-add prefix sum, the ballot and the add back; one chain (a
//   quarter of the warps) is about as slow as four.
//
// * warp (the kernel the half_warp variant replaced, and T > 16): one
//   warp per (chain, document), lane j holding topic
//   t = j + 32k; ndt, nt, η and s in registers; tokens, mask, z and
//   uniforms read 32 positions at a time and broadcast by shuffle; three
//   logf a topic every token, the table row and η read on the chain.
//
// Both draw alike, bit for bit: the same expressions in the same order,
// the prefix strictly left to right with the total the chain over all T,
// and z = #{t : c_t < u·total}.  Built without fused multiply-add
// contraction so that each expression rounds as the plain version's
// separate tensor operations do.
//
// SPARSE instantiations (`sampler_mode="sparse"`, the TPU kernel's branch
// at slda_gibbs.py:74-79) draw through kernel B4 against the topic index
// of the sweep-frozen table, packed by the launcher's first kernel into
// one record a (chain, word) (`pack_topic_index`: 16 bytes at T <= 16).
// The half_warp variant loads a position's record one step ahead, beside
// its row of logs, and draws with `draw_topic_sparse_half` (the gather a
// shuffle within the half); the warp variant copies a word's record into
// its stage (cp.async) while the token before it draws and draws with
// `draw_topic_sparse`.
// Everything else is the dense kernel.
#include "slda_common.cuh"

namespace slda {

// ---------------------------------------------------------------------------
// warp

template <int K, bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
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
                   const uint32_t* __restrict__ rec,   // [M, W, rw]
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

  int rb = 0;  // the stage's record buffer of the token drawn next
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    const bool in = n < N;
    const size_t at = row * N + n;
    const int w_l = in ? tokens[at] : 0;
    const float m_l = in ? mask[at] : 0.f;
    const float u_l = in ? uniforms[at] : 0.f;
    int z_l = in ? z[at] : 0;
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

// ---------------------------------------------------------------------------
// half_warp

constexpr int kLogCounts = 256;  // log(k + α) tabulated for counts k < 256

// The launch-frozen logs of the table: ltab[c, w, t] = log((x − 0) + β)
// and ltab[c, w, T + t] = log((x − 1) + β), x = ntw_t[c, w, t].
__global__ void gibbs_log_table_kernel(const float* __restrict__ ntw_t,
                                       float* __restrict__ ltab,
                                       size_t n, int T, float beta) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t r = i / T;
  const int t = static_cast<int>(i - r * T);
  const float x = ntw_t[i];
  ltab[r * 2 * T + t] = logf((x - 0.f) + beta);
  ltab[r * 2 * T + T + t] = logf((x - 1.f) + beta);
}

// Two documents a warp: half-warp grp of warp gw walks document
// 2·gw + grp of chain blockIdx.y, topic t in its lane t (T <= 16), one
// position a step up to the last real token of the warp's two
// documents; a padding position's step changes nothing.
template <bool SPARSE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gibbs_half_kernel(const int* __restrict__ tokens,     // [M, D, N]
                  const float* __restrict__ mask,     // [M, D, N]
                  const float* __restrict__ uniforms, // [M, D, N]
                  const int* __restrict__ z,          // [M, D, N]
                  const float* __restrict__ ndt,      // [M, D, T]
                  const float* __restrict__ y,        // [M, D]
                  const float* __restrict__ inv_len,  // [M, D]
                  const float* __restrict__ ntw_t,    // [M, W, T]
                  const float* __restrict__ ltab,     // [M, W, 2T]
                  const float* __restrict__ nt,       // [M, T]
                  const float* __restrict__ eta,      // [M, T]
                  int* __restrict__ z_out,            // [M, D, N]
                  float* __restrict__ ndt_out,        // [M, D, T]
                  int D, int N, int T, int W, float alpha, float beta,
                  float w_beta, float rho, int supervised,
                  const uint4* __restrict__ rec,      // [M, W] records
                  int cap) {
  constexpr int G = 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G, shift = grp * G;
  __shared__ float stage[kWarpsPerBlock][SPARSE ? 64 : 32];
  __shared__ float log_nd[kLogCounts];
  for (int k = threadIdx.x; k < kLogCounts; k += blockDim.x)
    log_nd[k] = logf(static_cast<float>(k) + alpha);
  __syncthreads();
  const int d0 = (blockIdx.x * kWarpsPerBlock + warp) * 2;
  if (d0 >= D) return;  // warp-uniform
  const int d = d0 + grp;
  const bool has = d < D;  // the last warp may walk one document
  const int c = blockIdx.y;
  float* sp = stage[warp] + (SPARSE ? 2 * G : G) * grp;
  const uint4* recs = SPARSE ? rec + static_cast<size_t>(c) * W : nullptr;
  const size_t row = has ? static_cast<size_t>(c) * D + d : 0;
  const bool tv = gl < T;
  const float* table = ntw_t + static_cast<size_t>(c) * W * T;
  const float* logs = ltab + static_cast<size_t>(c) * W * 2 * T;
  const int* tk = tokens + row * N;
  const float* mk = mask + row * N;
  const int* zk = z + row * N;
  const float* uk = uniforms + row * N;
  int* zo = z_out + row * N;

  float eta_r[1];
  eta_r[0] = tv ? eta[static_cast<size_t>(c) * T + gl] : 0.f;
  const float nt_r = tv ? nt[static_cast<size_t>(c) * T + gl] : 0.f;
  const float ln0 = logf((nt_r - 0.f) + w_beta);
  const float ln1 = logf((nt_r - 1.f) + w_beta);
  float nd = has && tv ? ndt[row * T + gl] : 0.f;
  float s_part = 0.f;
  s_part += nd * eta_r[0];
  float st = group_sum<G>(s_part);  // running Σ_t η_t ndt_t
  const float yd = has ? y[row] : 0.f;
  const float il = has ? inv_len[row] : 0.f;

  // the warp walks to the last real token of its two documents
  int len = 0;
  if (has)
    for (int n = gl; n < N; n += G)
      if (mk[n] > 0.f) len = n + 1;
  const int steps = __reduce_max_sync(kFull, len);

  // Position n's word, mask, old topic and uniform (the same for the
  // group's lanes), read two positions ahead, and this lane's entries of
  // its word's row of logs (and, sparse, its word's record), read one
  // position ahead: none depends on a draw, so no load is on the token
  // chain.
  auto at = [&](int n, int& w, float& m, int& zz, float& u) {
    w = zz = 0;
    m = u = 0.f;
    if (has && n < steps) {
      w = tk[n];
      m = mk[n];
      zz = zk[n];
      u = uk[n];
    }
  };
  auto logs_of = [&](int w, float m, float& l0, float& l1) {
    l0 = l1 = 0.f;
    if (m > 0.f && tv) {
      const int r = w * 2 * T + gl;  // within one chain's table
      l0 = __ldg(logs + r);          // log((x − 0) + β)
      l1 = __ldg(logs + r + T);      // log((x − 1) + β)
    }
  };
  auto rec_of = [&](int w, float m) {
    return SPARSE && m > 0.f ? __ldg(recs + w) : make_uint4(0u, 0u, 0u, 0u);
  };
  int w_0, z_0, w_1, z_1;
  float m_0, u_0, m_1, u_1, l0_0, l1_0;
  at(0, w_0, m_0, z_0, u_0);
  at(1, w_1, m_1, z_1, u_1);
  logs_of(w_0, m_0, l0_0, l1_0);
  uint4 rec_0 = rec_of(w_0, m_0);
  for (int n = 0; n < steps; ++n) {  // warp-uniform
    float l0_1, l1_1;
    logs_of(w_1, m_1, l0_1, l1_1);
    const uint4 rec_1 = rec_of(w_1, m_1);
    int w_2, z_2;
    float m_2, u_2;
    at(n + 2, w_2, m_2, z_2, u_2);

    const float m = m_0;  // 0 at padding: the step changes nothing
    const int z_old = z_0;
    st = st - eta_of<1, G>(eta_r, z_old) * m;
    if (gl == z_old) nd = nd - m;
    // log((x − old) + β) and log((nt − old) + Wβ): tabulated for old 0
    // and 1; a mask other than 0 or 1 computes the old topic's afresh
    const bool at_old = gl == z_old && m != 0.f;
    float lw = at_old ? l1_0 : l0_0, ln = at_old ? ln1 : ln0;
    if (__any_sync(kFull, tv && at_old && m != 1.f)) {  // warp-uniform
      if (tv && at_old && m != 1.f) {
        lw = logf((__ldg(table + w_0 * T + gl) - m) + beta);
        ln = logf((nt_r - m) + w_beta);
      }
    }
    // log(ndt + α): the table's entry where ndt is a count below 256
    const int k = static_cast<int>(nd);
    const bool counted = k >= 0 && k < kLogCounts &&
                         static_cast<float>(k) == nd;
    float la = log_nd[counted ? k : 0];
    if (__any_sync(kFull, tv && !counted)) {  // warp-uniform
      if (!counted) la = logf(nd + alpha);
    }
    float l = -INFINITY;
    if (tv) {
      l = (la + lw) - ln;
      if (supervised) {
        const float mu = (st + eta_r[0]) * il;
        const float e = yd - mu;
        l = l - (0.5f * (e * e)) / rho;
      }
    }
    const float mx = group_max<G>(l);
    const float p = tv ? expf(l - mx) : 0.f;
    int z_new;
    if constexpr (SPARSE)
      z_new = draw_topic_sparse_half(p, u_0, gl, T, cap, sp, rec_0, shift);
    else
      z_new = draw_topic_half(p, u_0, gl, T, sp, shift);
    if (gl == z_new) nd = nd + m;
    st = st + eta_of<1, G>(eta_r, z_new) * m;
    if (has && gl == 0) zo[n] = m > 0.f ? z_new : z_old;

    w_0 = w_1;
    m_0 = m_1;
    z_0 = z_1;
    u_0 = u_1;
    l0_0 = l0_1;
    l1_0 = l1_1;
    rec_0 = rec_1;
    w_1 = w_2;
    m_1 = m_2;
    z_1 = z_2;
    u_1 = u_2;
  }
  if (has) {
    for (int n = steps + gl; n < N; n += G) zo[n] = zk[n];  // padding
    if (tv) ndt_out[row * T + gl] = nd;
  }
}

}  // namespace slda

// variant 0: warp (T <= 512); 1: half_warp (T <= 16, with `ltab`
// [M, W, 2T] scratch for the table's logs).  A non-null idx is the sparse
// draw over cap <= T slots: the launcher first packs (idx, vmask
// [M, W, cap], occm [M, W, T]) into `rec` [M, W, rec_words(T, cap)].
extern "C" int slda_gibbs_sweep_launch(
    const int* tokens, const float* mask, const float* uniforms, const int* z,
    const float* ndt, const float* y, const float* inv_len,
    const float* ntw_t, const float* nt, const float* eta, int* z_out,
    float* ndt_out, int M, int D, int N, int T, int W, float alpha,
    float beta, float w_beta, float rho, int supervised, const int* idx,
    const float* vmask, const float* occm, int cap, int variant, float* ltab,
    uint32_t* rec, void* stream) {
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
    // int offsets within a chain's [W, 2T] logs
    if (T > 16 || !ltab || static_cast<long long>(W) * 2 * T >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t n = static_cast<size_t>(M) * W * T;
    if (n) {
      slda::gibbs_log_table_kernel<<<static_cast<unsigned>((n + 255) / 256),
                                     256, 0, st>>>(ntw_t, ltab, n, T, beta);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int docs = 2 * slda::kWarpsPerBlock;  // two documents a warp
    const dim3 grid((D + docs - 1) / docs, M);
    const uint4* rec4 = reinterpret_cast<const uint4*>(rec);
#define SLDA_GIBBS_HALF(SPARSE)                                             \
  slda::gibbs_half_kernel<SPARSE><<<grid, slda::kWarpsPerBlock * 32, 0,     \
                                    st>>>(                                  \
      tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t, ltab, nt, eta,     \
      z_out, ndt_out, D, N, T, W, alpha, beta, w_beta, rho, supervised,     \
      rec4, cap)
    if (sparse) SLDA_GIBBS_HALF(true);
    else SLDA_GIBBS_HALF(false);
#undef SLDA_GIBBS_HALF
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + slda::kWarpsPerBlock - 1) / slda::kWarpsPerBlock, M);
  const dim3 block(slda::kWarpsPerBlock * 32);
  // a warp's stage: p and its prefixes for the dense draw
  // (`dense_stage_floats`), `sparse_stage_floats` for B4
#define SLDA_GIBBS_AS(K, SPARSE)                                            \
  do {                                                                      \
    const int stride = SPARSE ? slda::sparse_stage_floats(T, cap)           \
                              : slda::dense_stage_floats(T);                \
    const size_t smem = sizeof(float) * slda::kWarpsPerBlock * stride;      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          slda::gibbs_sweep_kernel<K, SPARSE>,                              \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                      \
          static_cast<int>(smem));                                          \
      if (e != cudaSuccess) return static_cast<int>(e);                     \
    }                                                                       \
    slda::gibbs_sweep_kernel<K, SPARSE><<<grid, block, smem, st>>>(         \
        tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t, nt, eta, z_out,  \
        ndt_out, D, N, T, W, alpha, beta, w_beta, rho, supervised, rec,     \
        cap, stride);                                                       \
  } while (0)
#define SLDA_GIBBS(K)                                                       \
  if (sparse) SLDA_GIBBS_AS(K, true); else SLDA_GIBBS_AS(K, false)
  SLDA_FOR_K(T, SLDA_GIBBS)
#undef SLDA_GIBBS
#undef SLDA_GIBBS_AS
  return static_cast<int>(cudaGetLastError());
}
