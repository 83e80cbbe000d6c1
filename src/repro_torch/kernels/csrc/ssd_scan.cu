// Kernel B6: the Mamba-2 SSD chunked scan (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` of the reference
// (src/repro/kernels/ssd_scan.py:28) and computes what it computes, with
// the chain axis the models fold in: x [C, b, S, H, P] (float32 or bf16),
// dt [C, b, S, H], A [C, H], B and C [C, b, S, N] (float32; B and C shared
// by the heads, one group).  For each (chain, batch row, head) the state
// starts at zero and
//   h_t = exp(A dt_t) h_{t-1} + dt_t x_t (x) B_t,    y_t = C_t . h_t,
// accumulated in float32; y comes out in x's type.  Row r of the b rows of
// chain c reads A[c], as B7 finds its weight's chain.
//
// The chunk algebra (chunks of L <= 64 steps, cum the running sum of A dt
// inside a chunk):
//   y   = ((C B^T) o M) x + exp(cum) o (C h0^T),
//         M[t, s] = exp(cum_t - cum_s) dt_s for s <= t, else 0;
//   h1  = h0 exp(cum_last) + (x o w)^T B,   w_s = exp(cum_last - cum_s) dt_s.
// Above the diagonal cum_t - cum_s is positive and its exponent may be
// +inf; it is never computed (a select, as the reference's `where`), so no
// inf * 0 = NaN.  The TPU route pads S to a multiple of L with zeros: a
// padded step has dt = 0, decays by 1 and carries nothing, so the last
// chunk here is simply shorter and nothing is padded.
//
// Two variants, chosen by the wrapper from dtype and widths
// (`ssd_scan.variant`):
//
// * tensor_cores (bf16 x, P % 8 == 0, N % 4 == 0: the served route).
//   Bound by bytes: at mamba2-1.3b's fused prefill (C 4, b 8, S 200, H 64,
//   P 64, N 128) x and y in bf16 and B, C, dt in float32 are about 112 MB,
//   0.034 ms at 3.35 TB/s; the chunk algebra's 13 GFLOP (what the data
//   needs, `chip_smoke.ssd_flops`) take 0.013 ms at the dense bf16 rate.
//   One CTA of 256 threads per (chain * batch row, pair of heads) walks
//   the chunks in order, a warpgroup a head.  G = C B^T is formed once
//   per chunk for both heads, by all eight warps on mma.sync (once per
//   row and chunk would need all 64 heads' state on one SM), and each
//   warp turns its G tile straight into both heads' M.  Each head's
//   warpgroup then runs the head's three products on wgmma, computing y
//   transposed, y^T[p, t], so that the [P, N] state stays in registers
//   as a wgmma accumulator across the chunks and is, rounded in
//   registers, the A operand of the next chunk's y_off:
//     y_off^T = h0 C^T         (A: the state; B: C, K-major),
//     y^T     = e o y_off^T + x^T M^T   (A: x by ldmatrix; B: M, K-major),
//     h1      = h0 exp(cum_last) + (x o w)^T B   (A: x o w; B: B,
//               MN-major through the transpose bit),
//   bf16 in, float32 accumulators.  C, B and M are tiles of [64][64]
//   blocks in the 128-byte swizzle that wgmma reads (and ldmatrix, for
//   G, through swizzled row addresses).  The next chunk's x and dt land
//   by cp.async straight in the other of two buffers, and its B and C in
//   a staging area, while this chunk computes; each chunk converts B and
//   C once into bf16 hi and lo tiles, zero past the chunk and N, so every
//   product runs over whole tiles.  cum is a warp's shuffle scan.  About
//   200 KB of shared memory at N = 128 (one CTA an SM), its limit raised
//   once per device.
//   Precision: x is bf16 and enters exactly.  Every float32 operand (C, B,
//   G o M, h0, x o w) is split into a bf16 hi and the bf16 of its residual
//   lo, so that a product of two float32 operands is lo.hi + hi.lo + hi.hi
//   (three products, lo.lo dropped: about 2^-16 relative a term) and a product
//   with x is lo.x + hi.x (two).  Rounded to bf16 once each instead, the
//   products miss the bf16 gate (B6_TOL): at mamba2-1.3b's widths the
//   worst output needs 2.2 times the tolerance, the split form 0.17
//   (tests/test_torch_ssd_kernel.py).  M's decays use the fast exponential
//   (__expf, a few ulp, far below the split's 2^-16); w and exp(cum) the
//   exact one.  Sums are float32 in the tensor cores' order.
//
// * cuda_cores (float32 x, or widths the tensor_cores variant does not
//   take): the kernel the other replaced, kept for these calls and to time
//   it beside them.  float32 on the CUDA cores, the route of the float32
//   parity gates.  One CTA of 256 threads (a 16 x 16 grid) per (chain *
//   batch row, head), walking the chunks in order.  The [P, N] state (64 x
//   128 float32, 32 KB at mamba2-1.3b) stays in shared memory across
//   chunks; each chunk's x (as float32), dt, B and C are staged in shared
//   memory; the L x L decayed score matrix is formed there for s <= t.
//   Each thread computes a 4 x 4 tile of the score matrix and of y, and a 4
//   x 8 tile of the state update, from shared memory, rows padded by one
//   float (no bank conflicts across a warp's 16 columns).  Products
//   accumulate through explicit fmaf (the build's --fmad=false leaves
//   explicit fmaf alone).  About 130 KB of shared memory at N = 128.  It
//   forms G again in every head's CTA; bound by its float32 operations on
//   the CUDA cores (about 2.4 MFLOP per full chunk and head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A launch above 48 KB of shared memory needs the kernel's limit raised
// on the current device: once per device and size, as the limit stays
// (`allowed`, one per kernel, holds what each device has).
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return e;
}

// ---------------------------------------------------------------------------
// cuda_cores

constexpr int kGrid = 16;                  // threads along each tile axis
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxChunk = 64;              // L
constexpr int kMaxHeadDim = 64;            // P
constexpr int kMaxState = 128;             // N
constexpr int kTL = kMaxChunk / kGrid;     // rows of t (or s) a thread
constexpr int kTP = kMaxHeadDim / kGrid;   // rows of p a thread
constexpr int kTN = kMaxState / kGrid;     // columns of n a thread
constexpr int kMs = kMaxChunk + 1;         // score row stride

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

size_t smem_floats(int N) {
  return static_cast<size_t>(kMaxChunk) * kMaxHeadDim       // xs
         + 2 * static_cast<size_t>(kMaxChunk) * (N + 1)     // bs, cs
         + static_cast<size_t>(kMaxChunk) * kMs             // ms
         + static_cast<size_t>(kMaxHeadDim) * (N + 1)       // hs
         + 3 * kMaxChunk;                                   // dt, cum, w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, T* __restrict__ y, int batch,
                int S, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  const int NS = N + 1;                     // B, C and state row stride
  float* xs = smem;                         // [L][kMaxHeadDim]
  float* bs = xs + kMaxChunk * kMaxHeadDim; // [L][N + 1]
  float* cs = bs + kMaxChunk * NS;          // [L][N + 1]
  float* ms = cs + kMaxChunk * NS;          // [L][L + 1]
  float* hs = ms + kMaxChunk * kMs;         // [kMaxHeadDim][N + 1]
  float* dts = hs + kMaxHeadDim * NS;       // [L]
  float* cum = dts + kMaxChunk;             // [L]
  float* ws = cum + kMaxChunk;              // [L]

  const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
  const long row = blockIdx.x;              // chain * batch + batch row
  const int h = blockIdx.y;
  const float a = A[(row / batch) * H + h];

  for (int i = tid; i < kMaxHeadDim * NS; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);
    const long step0 = row * S + t0;        // this chunk's first step
    __syncthreads();                        // the last chunk is read
    for (int i = tid; i < Lc * P; i += kThreads) {
      const int l = i / P, p = i - l * P;
      xs[l * kMaxHeadDim + p] = to_f(x[((step0 + l) * H + h) * P + p]);
    }
    for (int i = tid; i < Lc * N; i += kThreads) {
      const int l = i / N, n = i - l * N;
      bs[l * NS + n] = B[step0 * N + i];
      cs[l * NS + n] = C[step0 * N + i];
    }
    for (int l = tid; l < Lc; l += kThreads) dts[l] = dt[(step0 + l) * H + h];
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int l = 0; l < Lc; ++l) {
        c += a * dts[l];
        cum[l] = c;
      }
    }
    __syncthreads();
    const float cum_last = cum[Lc - 1];
    for (int l = tid; l < Lc; l += kThreads)
      ws[l] = expf(cum_last - cum[l]) * dts[l];

    // scores: ms[t][s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t
    {
      float g[kTL][kTL];
#pragma unroll
      for (int i = 0; i < kTL; ++i)
#pragma unroll
        for (int j = 0; j < kTL; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kTL], bv[kTL];
#pragma unroll
        for (int i = 0; i < kTL; ++i) cv[i] = cs[(ty + kGrid * i) * NS + n];
#pragma unroll
        for (int j = 0; j < kTL; ++j) bv[j] = bs[(tx + kGrid * j) * NS + n];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTL; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTL; ++i) {
        const int t = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kTL; ++j) {
          const int s = tx + kGrid * j;
          if (t < Lc && s < Lc)
            ms[t * kMs + s] =
                s <= t ? g[i][j] * (expf(cum[t] - cum[s]) * dts[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_s ms[t][s] x[s][p] + exp(cum_t) * (C_t . h0[p])
    {
      float y1[kTL][kTP], y2[kTL][kTP];
#pragma unroll
      for (int i = 0; i < kTL; ++i)
#pragma unroll
        for (int j = 0; j < kTP; ++j) y1[i][j] = y2[i][j] = 0.f;
      for (int s = 0; s < Lc; ++s) {
        float mv[kTL], xv[kTP];
#pragma unroll
        for (int i = 0; i < kTL; ++i) mv[i] = ms[(ty + kGrid * i) * kMs + s];
#pragma unroll
        for (int j = 0; j < kTP; ++j)
          xv[j] = xs[s * kMaxHeadDim + tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTP; ++j)
            y1[i][j] = fmaf(mv[i], xv[j], y1[i][j]);
      }
      if (t0 > 0) {                         // h0 = 0 in the first chunk
        for (int n = 0; n < N; ++n) {
          float cv[kTL], hv[kTP];
#pragma unroll
          for (int i = 0; i < kTL; ++i) cv[i] = cs[(ty + kGrid * i) * NS + n];
#pragma unroll
          for (int j = 0; j < kTP; ++j) hv[j] = hs[(tx + kGrid * j) * NS + n];
#pragma unroll
          for (int i = 0; i < kTL; ++i)
#pragma unroll
            for (int j = 0; j < kTP; ++j)
              y2[i][j] = fmaf(cv[i], hv[j], y2[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTL; ++i) {
        const int t = ty + kGrid * i;
        if (t >= Lc) continue;
        const float e = expf(cum[t]);
        T* yr = y + ((step0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kTP; ++j) {
          const int p = tx + kGrid * j;
          if (p < P) store(yr + p, y1[i][j] + e * y2[i][j]);
        }
      }
    }
    __syncthreads();                        // h0 is read

    // h1[p][n] = h0[p][n] exp(cum_last) + sum_s (x[s][p] w_s) B[s][n]
    {
      float acc[kTP][kTN];
#pragma unroll
      for (int i = 0; i < kTP; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < Lc; ++s) {
        const float w = ws[s];
        float xv[kTP], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTP; ++i)
          xv[i] = xs[s * kMaxHeadDim + ty + kGrid * i] * w;
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[s * NS + tx + kGrid * j];
#pragma unroll
        for (int i = 0; i < kTP; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        const int p = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int n = tx + kGrid * j;
          if (p < P && n < N) {
            float* hp = hs + p * NS + n;
            *hp = *hp * decay + acc[i][j];
          }
        }
      }
    }
  }
}


// ---------------------------------------------------------------------------
// tensor_cores

constexpr int kHeads = 2;                  // heads a CTA (they share G)
constexpr int kTcThreads = kHeads * 128;   // a warpgroup a head
constexpr int kXs = kMaxHeadDim + 8;       // x's row stride (16-byte pad)
constexpr int kBlk = 64 * 64;              // elements of a swizzled block
constexpr int kBlkBytes = 2 * kBlk;

// C [t][n], B [s][n] and each head's M [t][s] are bf16 tiles of [64 rows]
// [64 columns] blocks in the 128-byte swizzle that wgmma reads (row r's
// 16-byte pieces permuted by r % 8, each block 1 KB aligned); x [s][p] is
// a padded tile that only ldmatrix reads.  Byte offsets into the dynamic
// shared memory of a CTA with state width NT (64 or 128), from a 1 KB
// aligned base.
template <int NT>
struct TcLayout {
  static constexpr size_t tile = static_cast<size_t>(NT / 64) * kBlkBytes;
  static constexpr size_t c_hi = 0;
  static constexpr size_t c_lo = c_hi + tile;
  static constexpr size_t b_hi = c_lo + tile;
  static constexpr size_t b_lo = b_hi + tile;
  static constexpr size_t m_hi = b_lo + tile;               // [heads]
  static constexpr size_t m_lo = m_hi + kHeads * kBlkBytes; // [heads]
  // x [heads][2 buffers][s][p] bf16; dt [2 buffers][L], cum, w and
  // exp(cum) [L] float a head
  static constexpr size_t x = m_lo + kHeads * kBlkBytes;
  static constexpr size_t x_bytes = 2ull * 2 * kMaxChunk * kXs;
  static constexpr size_t vec = x + kHeads * x_bytes;
  static constexpr size_t vec_bytes = 4ull * 5 * kMaxChunk;
  // the next chunk's B and C [L][NT] (float) as they arrive
  static constexpr size_t raw_b = vec + kHeads * vec_bytes;
  static constexpr size_t raw_c = raw_b + 4ull * kMaxChunk * NT;
  static constexpr size_t bytes = raw_c + 4ull * kMaxChunk * NT;
};

// element offset of (row r < 64, column c) in a tile of swizzled blocks
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kBlk + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lane T names row T % 8 of
// matrix T / 8 (16 bytes); register i holds matrix i's elements (row
// gid, columns 2 tig and + 1), or with .trans (rows 2 tig and + 1,
// column gid).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// d += a b for one m16n8k16 tile (G's products): a the 16 x 16 row-major
// fragment (four registers of two bf16), b the 16 x 8 column fragment
// (two registers).  Not volatile: the compiler orders the products by
// their operands, so independent tiles overlap.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three products of a split float32 pair over four tiles, d[q] +=
// a_lo.bh + a_hi.bl + a_hi.bh for q < n; bh, bl hold tile q's fragment in
// registers 2q and 2q + 1 of two ldmatrix loads (tiles 0, 1 in the first,
// 2, 3 in the second).  Each product runs over all tiles before the next,
// so that consecutive mma are independent.
__device__ __forceinline__ void mma3(float (*d)[4], const uint32_t (&a_lo)[4],
                                     const uint32_t (&a_hi)[4],
                                     const uint32_t (&bh)[2][4],
                                     const uint32_t (&bl)[2][4], int n) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) mma_bf16(d[q], a_lo, bh[q / 2][2 * (q % 2)],
                        bh[q / 2][2 * (q % 2) + 1]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) mma_bf16(d[q], a_hi, bl[q / 2][2 * (q % 2)],
                        bl[q / 2][2 * (q % 2) + 1]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) mma_bf16(d[q], a_hi, bh[q / 2][2 * (q % 2)],
                        bh[q / 2][2 * (q % 2) + 1]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from reading or moving accumulator registers across
// the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor of the 128-byte swizzle: `sbo` is the
// byte distance between groups of 8 rows along N (K-major) or along K
// (MN-major); `lbo` that between 64-column blocks along N (MN-major;
// unused K-major).  Inside a block the start address moves by 32 bytes a
// k16 step (K-major) or by 16 rows (MN-major).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         uint64_t{1} << 62;
}

// d += A·B for a warpgroup, m64nNk16 (N = 2 · D entries of d a thread):
// A from registers (each warp's 16 rows as mma.sync's A fragment), B in
// shared memory, K-major (TRANS 0) or MN-major (TRANS 1).
template <int TRANS>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TRANS),
        "r"(1));
}
template <int TRANS>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TRANS),
        "r"(1));
}
// the state's product, m64nNTk16 with B MN-major
template <int NT>
__device__ __forceinline__ void wgmma_state(float (&d)[NT / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (NT == 64) wgmma_n64<1>(d, a, b);
  else wgmma_n128<1>(d, a, b);
}

// the two bf16 of a register as floats: the low half holds the smaller
// index
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
// (a, b) as bf16 hi and the bf16 of the residual lo: a = hi + lo to about
// 2^-16 relative (each pair one packed conversion, a in the low half)
__device__ __forceinline__ uint32_t bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = bf2(a, b);
  lo = bf2(a - lo_f(hi), b - hi_f(hi));
}

// Fragment positions (PTX's m16n8k16, and each warp's 16 rows of a
// warpgroup's m64 wgmma): lane = 4 gid + tig; A holds rows gid and gid + 8
// at columns 2 tig, + 1 and 2 tig + 8, + 9; B columns gid at rows (k)
// 2 tig, + 1 and 2 tig + 8, + 9; the accumulator of 8-column tile j rows
// gid and gid + 8 at columns 8 j + 2 tig, + 1 (registers 4 j .. 4 j + 3).
// With lane T naming row T % 8 of matrix T / 8, `mat` is T / 8 and `mrow`
// T % 8.
template <int NT>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_scan_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ B, const float* __restrict__ C,
                   __nv_bfloat16* __restrict__ y, int batch, int S, int H,
                   int P, int N, int L) {
  using Lay = TcLayout<NT>;
  extern __shared__ __align__(16) uint8_t tc_raw[];
  uint8_t* tc_smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t{1023});
  auto bf = [&](size_t off) {
    return reinterpret_cast<__nv_bfloat16*>(tc_smem + off);
  };
  auto fl = [&](size_t off) {
    return reinterpret_cast<float*>(tc_smem + off);
  };
  __nv_bfloat16 *c_hi = bf(Lay::c_hi), *c_lo = bf(Lay::c_lo);
  __nv_bfloat16 *b_hi = bf(Lay::b_hi), *b_lo = bf(Lay::b_lo);
  float *raw_b = fl(Lay::raw_b), *raw_c = fl(Lay::raw_c);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const int hh = warp / 4;                  // this warpgroup's head
  const int pb = (warp % 4) * 16;           // this warp's 16 rows of p
  const long row = blockIdx.x;              // chain * batch + batch row
  const int h0 = blockIdx.y * kHeads;
  const int h = h0 + hh;
  const bool head_ok = h < H;
  auto xk = [&](int k) { return bf(Lay::x + k * Lay::x_bytes); };
  auto vk = [&](int k) { return fl(Lay::vec + k * Lay::vec_bytes); };
  __nv_bfloat16* m_hi = bf(Lay::m_hi + hh * kBlkBytes);
  __nv_bfloat16* m_lo = bf(Lay::m_lo + hh * kBlkBytes);
  float* cum = vk(hh) + 2 * kMaxChunk;
  float* ws = cum + kMaxChunk;
  float* es = ws + kMaxChunk;
  const float a = head_ok ? A[(row / batch) * H + h] : 0.f;

  // x's tiles start at zero: columns past P stay so, and rows past a
  // short chunk hold an earlier chunk's (finite) rows, which meet zeros
  for (int i = tid; i < kHeads * Lay::x_bytes / 16; i += kTcThreads)
    reinterpret_cast<uint4*>(bf(Lay::x))[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the chunk at t0 into buffer `buf`, by cp.async: B and C rows into the
  // staging area, x rows straight into their tile (16-byte pieces), dt one
  // float each (the tiles' widths are powers of two: no division by a
  // runtime width)
  auto stage = [&](int t0, int buf) {
    const int Lc = min(L, S - t0);
    const long step0 = row * S + t0;
    constexpr int kQ = NT / 4, kPx = kMaxHeadDim / 8;
    for (int i = tid; i < Lc * kQ; i += kTcThreads) {
      const int l = i / kQ, q = i % kQ;
      if (4 * q < N) {
        cp_async16(raw_b + l * NT + 4 * q, B + (step0 + l) * N + 4 * q);
        cp_async16(raw_c + l * NT + 4 * q, C + (step0 + l) * N + 4 * q);
      }
    }
#pragma unroll
    for (int k = 0; k < kHeads; ++k) {
      if (h0 + k >= H) continue;
      __nv_bfloat16* xb = xk(k) + buf * kMaxChunk * kXs;
      const __nv_bfloat16* src = x + (step0 * H + h0 + k) * P;
      for (int i = tid; i < Lc * kPx; i += kTcThreads) {
        const int l = i / kPx, q = i % kPx;
        if (8 * q < P)
          cp_async16(xb + l * kXs + 8 * q, src + static_cast<long>(l) * H * P +
                                               8 * q);
      }
      if (tid < Lc)
        cp_async4(vk(k) + buf * kMaxChunk + tid,
                  dt + (step0 + tid) * H + h0 + k);
    }
    cp_async_commit();
  };

  // the state: warp w's rows pb + gid and + 8 at columns 8 j + 2 tig and
  // + 1, registers 4 j .. 4 j + 3 (the layout of a warpgroup's wgmma)
  float hacc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) hacc[i] = 0.f;

  stage(0, 0);
  for (int t0 = 0, buf = 0; t0 < S; t0 += L, buf ^= 1) {
    const int Lc = min(L, S - t0);
    const long step0 = row * S + t0;
    const __nv_bfloat16* xs = xk(hh) + buf * kMaxChunk * kXs;
    cp_async_wait_all();
    __syncthreads();            // the chunk has landed; the last is read

    // C and B as bf16 hi and lo, four columns a thread, zero past the
    // chunk and N
    for (int i = tid; i < kMaxChunk * (NT / 4); i += kTcThreads) {
      const int l = i / (NT / 4), n = 4 * (i - l * (NT / 4));
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
      if (l < Lc && n < N) {
        bv = *reinterpret_cast<const float4*>(raw_b + l * NT + n);
        cv = *reinterpret_cast<const float4*>(raw_c + l * NT + n);
      }
      const int at = swz(l, n);
      uint2 hi, lo;
      split2(bv.x, bv.y, hi.x, lo.x);
      split2(bv.z, bv.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(b_hi + at) = hi;
      *reinterpret_cast<uint2*>(b_lo + at) = lo;
      split2(cv.x, cv.y, hi.x, lo.x);
      split2(cv.z, cv.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(c_hi + at) = hi;
      *reinterpret_cast<uint2*>(c_lo + at) = lo;
    }
    // each head's cum (a warp's inclusive scan), w and exp(cum)
    if (warp % 4 == 0 && head_ok) {
      const float* dtb = vk(hh) + buf * kMaxChunk;
      float v0 = lane < Lc ? a * dtb[lane] : 0.f;
      float v1 = lane + 32 < Lc ? a * dtb[lane + 32] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float last = Lc > 32 ? __shfl_sync(0xffffffffu, v1, Lc - 33)
                                 : __shfl_sync(0xffffffffu, v0, Lc - 1);
      cum[lane] = v0;
      cum[lane + 32] = v1;
      ws[lane] = lane < Lc ? expf(last - v0) * dtb[lane] : 0.f;
      ws[lane + 32] = lane + 32 < Lc ? expf(last - v1) * dtb[lane + 32] : 0.f;
      es[lane] = lane < Lc ? expf(v0) : 0.f;
      es[lane + 32] = lane + 32 < Lc ? expf(v1) : 0.f;
    }
    __syncthreads();            // staging free; C, B, cum, w, e whole
    if (t0 + L < S) stage(t0 + L, buf ^ 1);

    // G = C B^T over the 16 rows t from 16 (warp % 4) and the 32 columns s
    // from 32 (warp / 4), s <= t only, once for both heads (mma.sync); then
    // both heads' M = G o exp(cum_t - cum_s) o dt_s from the accumulators
    {
      const int tt0 = (warp % 4) * 16, sb = (warp / 4) * 32;
      float gacc[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) gacc[jj][r] = 0.f;
      if (tt0 < Lc && sb <= tt0 + 15) {
        // C rows tt0 + (mat & 1) 8 + mrow at n + (mat >> 1) 8; B rows
        // s + (mat >> 1) 8 + mrow at n + (mat & 1) 8 (tiles s, s + 8)
        const int cr = tt0 + (mat & 1) * 8 + mrow, cc = (mat >> 1) * 8;
        const int br = sb + (mat >> 1) * 8 + mrow, bc = (mat & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < NT / 16; ++kk) {
          uint32_t ah[4], al[4], bh[2][4], bl[2][4];
          ldsm4(ah, c_hi + swz(cr, cc + 16 * kk));
          ldsm4(al, c_lo + swz(cr, cc + 16 * kk));
#pragma unroll
          for (int g2 = 0; g2 < 2; ++g2) {
            ldsm4(bh[g2], b_hi + swz(br + 16 * g2, bc + 16 * kk));
            ldsm4(bl[g2], b_lo + swz(br + 16 * g2, bc + 16 * kk));
          }
          // tiles past the diagonal or the chunk stay zero
          const int n_on = min(4, (min(tt0 + 16, Lc) - sb + 7) / 8);
          mma3(gacc, al, ah, bh, bl, n_on);
        }
      }
      // M's element (t, s) at gacc[jj][2 half + e]: t = tt0 + gid + 8 half,
      // s = sb + 8 jj + 2 tig + e; a block wholly past the diagonal or the
      // chunk is zero.  Both heads' cum and dt at this tile's rows and
      // columns are read before any store.
      const bool any = tt0 < Lc && sb <= tt0 + 15;
      float ct[kHeads][2], cs[kHeads][4][2], ds[kHeads][4][2];
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        const float* dk = vk(k) + buf * kMaxChunk;
        const float* ck = vk(k) + 2 * kMaxChunk;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          ct[k][half] = ck[tt0 + gid + 8 * half];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            cs[k][jj][e] = ck[sb + 8 * jj + 2 * tig + e];
            ds[k][jj][e] = dk[sb + 8 * jj + 2 * tig + e];
          }
      }
#pragma unroll
      for (int k = 0; k < kHeads; ++k) {
        if (h0 + k >= H) continue;
        __nv_bfloat16* mh = bf(Lay::m_hi + k * kBlkBytes);
        __nv_bfloat16* ml = bf(Lay::m_lo + k * kBlkBytes);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int s = sb + 8 * jj + 2 * tig;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = tt0 + gid + 8 * half;
            float m[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              m[e] = any && s + e <= t && t < Lc
                         ? gacc[jj][2 * half + e] *
                               (__expf(ct[k][half] - cs[k][jj][e]) *
                                ds[k][jj][e])
                         : 0.f;
            uint32_t hi, lo;
            split2(m[0], m[1], hi, lo);
            *reinterpret_cast<uint32_t*>(mh + swz(t, s)) = hi;
            *reinterpret_cast<uint32_t*>(ml + swz(t, s)) = lo;
          }
        }
      }
    }
    __syncthreads();            // M whole

    // The head's warpgroup: y^T [p][t] and the state [p][n] on wgmma, A
    // (the split state, x, x o w) from registers, B (C, M, B) from shared
    // memory
    if (head_ok) {
      const int kt = (Lc + 15) / 16;        // 16-step slices of s
      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;

      // y_off^T[p][t] = h0[p] . C[t] (C K-major), two k16 steps of n at a
      // time, then times exp(cum_t)
      if (t0 > 0) {
#pragma unroll
        for (int k0 = 0; k0 < NT / 16; k0 += 2) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* h2 = hacc + 8 * (k0 + q);   // tiles 2kk, 2kk + 1
            split2(h2[0], h2[1], ah[q][0], al[q][0]);
            split2(h2[2], h2[3], ah[q][1], al[q][1]);
            split2(h2[4], h2[5], ah[q][2], al[q][2]);
            split2(h2[6], h2[7], ah[q][3], al[q][3]);
          }
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int kk = k0 + q;
            const int off = (kk / 4) * kBlk + 16 * (kk % 4);
            const uint64_t dh = smem_desc(c_hi + off, 16, 1024);
            const uint64_t dl = smem_desc(c_lo + off, 16, 1024);
            wgmma_n64<0>(yacc, al[q], dh);
            wgmma_n64<0>(yacc, ah[q], dl);
            wgmma_n64<0>(yacc, ah[q], dh);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(yacc);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e0 = es[8 * j + 2 * tig], e1 = es[8 * j + 2 * tig + 1];
          yacc[4 * j] *= e0;
          yacc[4 * j + 1] *= e1;
          yacc[4 * j + 2] *= e0;
          yacc[4 * j + 3] *= e1;
        }
      }

      // x^T as A for every slice of s: x rows s0 + (mat >> 1) 8 + mrow at
      // p = pb + (mat & 1) 8, transposed
      uint32_t xa[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < kt)
          ldsm4_t(xa[ks], xs + (16 * ks + (mat >> 1) * 8 + mrow) * kXs + pb +
                              (mat & 1) * 8);

      // y^T += x^T M^T (M K-major)
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < kt) {
          wgmma_n64<0>(yacc, xa[ks], smem_desc(m_lo + 16 * ks, 16, 1024));
          wgmma_n64<0>(yacc, xa[ks], smem_desc(m_hi + 16 * ks, 16, 1024));
        }
      wgmma_commit();

      // h = h0 exp(cum_last) + (x o w)^T B (B MN-major: 16 rows of s a
      // step, groups of 8 rows 1 KB apart, 64-column blocks 8 KB apart)
      const float decay = expf(cum[Lc - 1]);
      uint32_t wh[4][4], wl[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < kt) {
          const int sw = 16 * ks + 2 * tig;
          const float w0 = ws[sw], w1 = ws[sw + 1];
          const float w8 = ws[sw + 8], w9 = ws[sw + 9];
          split2(lo_f(xa[ks][0]) * w0, hi_f(xa[ks][0]) * w1, wh[ks][0],
                 wl[ks][0]);
          split2(lo_f(xa[ks][1]) * w0, hi_f(xa[ks][1]) * w1, wh[ks][1],
                 wl[ks][1]);
          split2(lo_f(xa[ks][2]) * w8, hi_f(xa[ks][2]) * w9, wh[ks][2],
                 wl[ks][2]);
          split2(lo_f(xa[ks][3]) * w8, hi_f(xa[ks][3]) * w9, wh[ks][3],
                 wl[ks][3]);
        }
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) hacc[i] *= decay;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < kt) {
          const uint64_t dh = smem_desc(b_hi + 16 * ks * 64, kBlkBytes, 1024);
          const uint64_t dl = smem_desc(b_lo + 16 * ks * 64, kBlkBytes, 1024);
          wgmma_state<NT>(hacc, wl[ks], dh);
          wgmma_state<NT>(hacc, wh[ks], dl);
          wgmma_state<NT>(hacc, wh[ks], dh);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(yacc);
      fence_regs(hacc);

      // y rows t < Lc, columns p < P
      const int p0 = pb + gid;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = 8 * j + 2 * tig;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (t + q < Lc) {
            __nv_bfloat16* yr = y + ((step0 + t + q) * H + h) * P;
            if (p0 < P) yr[p0] = __float2bfloat16_rn(yacc[4 * j + q]);
            if (p0 + 8 < P)
              yr[p0 + 8] = __float2bfloat16_rn(yacc[4 * j + 2 + q]);
          }
        }
      }
    }
  }
}

template <int NT>
cudaError_t launch_tc(const void* x, const float* dt, const float* A,
                      const float* B, const float* C, void* y, int chains,
                      int batch, int S, int H, int P, int N, int L,
                      cudaStream_t st) {
  auto kernel = ssd_scan_tc_kernel<NT>;
  static size_t allowed[kMaxDevices] = {};
  const size_t bytes = TcLayout<NT>::bytes + 1024;  // the base rounded up
  const cudaError_t e = allow_smem(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(chains) * batch,
                  (H + kHeads - 1) / kHeads);
  kernel<<<grid, kTcThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, B, C,
      static_cast<__nv_bfloat16*>(y), batch, S, H, P, N, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const float* B, const float* C, void* y, int chains,
                   int batch, int S, int H, int P, int N, int L,
                   cudaStream_t st) {
  auto kernel = ssd_scan_kernel<T>;
  static size_t allowed[kMaxDevices] = {};
  const size_t bytes = smem_floats(N) * sizeof(float);
  const cudaError_t e = allow_smem(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(chains) * batch, H);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), dt, A, B, C, static_cast<T*>(y), batch, S, H,
      P, N, L);
  return cudaGetLastError();
}

}  // namespace

// x, y [chains, batch, S, H, P] (bf16 != 0: __nv_bfloat16, else float);
// dt [chains, batch, S, H], A [chains, H], B, C [chains, batch, S, N],
// float, contiguous; 1 <= chunk <= 64, P <= 64, N <= 128.  `variant` is
// the wrapper's choice: 0 cuda_cores, 1 tensor_cores (bf16, P % 8 == 0,
// N % 4 == 0, x, B and C 16-byte aligned).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const float* B, const float* C, void* y,
                               int chains, int batch, int S, int H, int P,
                               int N, int chunk, int bf16, int variant,
                               void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || P > kMaxHeadDim || N > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (variant == 1) {
    if (!bf16 || P % 8 || N % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    e = N <= 64 ? launch_tc<64>(x, dt, A, B, C, y, chains, batch, S, H, P,
                                N, chunk, st)
                : launch_tc<128>(x, dt, A, B, C, y, chains, batch, S, H, P,
                                 N, chunk, st);
  } else if (variant == 0) {
    e = bf16 ? launch<__nv_bfloat16>(x, dt, A, B, C, y, chains, batch, S, H,
                                     P, N, chunk, st)
             : launch<float>(x, dt, A, B, C, y, chains, batch, S, H, P, N,
                             chunk, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
