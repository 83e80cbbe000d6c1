// Kernel B5: causal GQA attention with an online softmax (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the reference
// (src/repro/kernels/flash_attention.py:26) and computes what the oracle
// `ref_attention` defines at every shape: q [B, Hq, Sq, Dh], k/v
// [B, Hkv, Sk, Dh] (float32 or bf16, Dh <= 128), query head h reads KV
// head h / (Hq / Hkv); row i of a causal call sees keys j <= i + Sk - Sq
// (the queries are the last Sq positions) and, with kv_len, keys
// j < kv_len[b].  Scores, the running max and sum and the output
// accumulator are float32; the output is cast to q's type.  A row with no
// valid key is 0 / 0 = NaN, as the oracle's all -inf softmax is.
//
// The TPU kernel pads q to its block and aligns the causal diagonal with
// the padded length (`kv_len - sq` with sq the padded Sq), which shifts
// every row of a padded causal call.  Here nothing is padded: rows past
// Sq are staged as zeros and never written, keys past Sk are never
// scored, and the diagonal offset is Sk - Sq of the true shapes.
//
// Three variants, chosen by the wrapper from dtype and shape
// (`flash_attention.variant`):
//
// * prefill_wgmma (Sq > 4, bf16, Dh % 8 == 0).  Bound by bytes at
//   qwen3-1.7b's prefill, so the products must run on the tensor cores.
//   One CTA per (64-row q tile, KV head, batch row) holds NC = 2 query
//   heads of the group (1 when the group is odd), one consumer warpgroup
//   each, so a K/V tile is loaded once for both.  A producer warp brings
//   the Q tiles once and K/V tiles of 64 keys through a ring of two
//   stages with TMA (`cp.async.bulk.tensor`) and mbarriers.  Each
//   consumer computes S = Q·Kᵀ with wgmma m64n64k16 (bf16 in, float32
//   accumulators, both operands in shared memory), runs the online
//   softmax on the accumulators in registers, rounds P to bf16 in
//   registers as the A operand of O += P·V (wgmma m64nDk16, V the
//   MN-major B operand through the transpose bit).  Shared memory holds
//   each tile as 64-column blocks of [64 rows][128 bytes] in the 128-byte
//   swizzle, one TMA box each, which wgmma reads without bank conflicts.
//   The head is padded to D = 64 or 128 columns: the box's columns past
//   Dh arrive as zeros (zamba2-2.7b's Dh 80 takes 128; zero in Q and K
//   leaves the scores exact, and V's zero columns reach no output).
//   The tensor maps are 3-D (Dh, S, B·H), so a box past S, in the ragged
//   last q tile or the key tail, fills with zeros and never reads the
//   next head's rows.  They are encoded on the host each call through
//   `cuTensorMapEncodeTiled`, reached with cudaGetDriverEntryPoint (the
//   build links no -lcuda).  Only the tiles that straddle the causal
//   diagonal or kv_len are masked; tiles wholly past
//   min(kv_len, last row + Sk - Sq + 1) are never loaded.  P in bf16
//   carries about 2^-9 relative error per weight into the output; the
//   normaliser l sums P in float32.  The softmax runs in log2 units
//   (scores times Dh^-0.5·log2(e), P = exp2f(x - max)): one MUFU
//   operation a score, its 2-ulp error far below P's bf16 rounding.
//
// * decode (Sq <= 4, both dtypes).  Bound by bytes: the valid K/V prefix
//   of each KV head, read once.  One CTA per (KV head, batch row) holds
//   the G·Sq query rows of the group (G = Hq / Hkv; up to 8 rows a CTA,
//   more CTAs past that), so each KV head is read once for its group.
//   Its eight warps take tiles of 32 keys in turn; in a tile lane j
//   scores key j (its K row read in 16-byte pieces, q broadcast from
//   shared memory), the warp updates its own (m, l, acc), and P·V reads
//   each V row in 16-byte pieces, lanes over the head's columns.  The
//   warps merge their (m, l, acc) through shared memory at the end.
//
// * cuda_cores (Sq > 4, float32, or bf16 with Dh % 8 != 0): the kernel
//   this design replaced, kept for these calls.  float32 on the CUDA
//   cores, the route of the float32 parity gates (TF32 stays off).  One
//   CTA per (q block, query head, batch row), four warps of 16 rows (one
//   row at Sq <= 4, where the wrapper picks it only when asked to, to time
//   what decode replaced); K (row stride Dh + 1) and V tiles of 32 keys
//   staged in shared memory as float32; lane j scores key j against the
//   warp's rows, the probabilities go through shared memory, and lane l
//   accumulates output columns l, l + 32, l + 64, l + 96.
//
// Products in the CUDA-core variants accumulate through explicit fmaf
// (the build's --fmad=false leaves explicit fmaf alone), as the plain
// version's GEMMs accumulate; the tensor-core products are unaffected by
// the flag.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

// The online-softmax step of one row: the new running max from the
// block's max `mx`, the factor that rescales the old sum and accumulator
// (0 while nothing was valid), and the base the block's scores are
// exponentiated against (0 while the row has no valid key, so a masked
// score gives exp(-inf) = 0).  `LOG2` keeps the scores in units of log2
// (exp2f, the bf16 tensor-core variant), else natural units (expf).
template <bool LOG2 = false>
__device__ __forceinline__ void softmax_step(float& m, float mx, float& corr,
                                             float& base) {
  const float m_new = fmaxf(m, mx);
  base = m_new == -INFINITY ? 0.f : m_new;
  corr = LOG2 ? exp2f(m - base) : expf(m - base);
  m = m_new;
}

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

// The variants, as the wrapper numbers them.
constexpr int kCudaCores = 0;
constexpr int kPrefillWgmma = 1;
constexpr int kDecode = 2;

// ------------------------------------------------------------------
// cuda_cores: float32 on the CUDA cores

constexpr int kBlockK = 32;              // keys per tile, one per lane
constexpr int kDimSlots = kMaxHeadDim / 32;

template <int WARPS, int ROWS>
constexpr size_t smem_floats(int dh) {
  return static_cast<size_t>(WARPS * ROWS) * dh      // q rows
         + static_cast<size_t>(kBlockK) * (dh + 1)    // K tile, padded
         + static_cast<size_t>(kBlockK) * dh          // V tile
         + static_cast<size_t>(WARPS * ROWS) * kBlockK;  // probabilities
}

template <int WARPS, int ROWS, typename T>
__global__ void __launch_bounds__(WARPS * 32)
attention_cuda_cores(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_len,
                     T* __restrict__ out, int Hq, int Hkv, int Sq, int Sk,
                     int Dh, float scale, int causal) {
  constexpr int BQ = WARPS * ROWS;
  constexpr int kThreads = WARPS * 32;
  extern __shared__ float smem[];
  float* qs = smem;                          // [BQ][Dh]
  float* ks = qs + BQ * Dh;                  // [kBlockK][Dh + 1]
  float* vs = ks + kBlockK * (Dh + 1);       // [kBlockK][Dh]
  float* ps = vs + kBlockK * Dh;             // [BQ][kBlockK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (Hq / Hkv);
  const long q_base = (static_cast<long>(b) * Hq + h) * Sq * Dh;
  const long kv_base = (static_cast<long>(b) * Hkv + hk) * Sk * Dh;

  const int kvl = kv_len ? min(max(kv_len[b], 0), Sk) : Sk;
  const int off = Sk - Sq;                   // causal: j <= i + off
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(kvl, q_last + off + 1) : kvl;

  for (int i = threadIdx.x; i < BQ * Dh; i += kThreads) {
    const int r = i / Dh;
    qs[i] = q0 + r < Sq ? to_f(q[q_base + static_cast<long>(q0) * Dh + i])
                        : 0.f;
  }

  const int row0 = q0 + warp * ROWS;         // this warp's first row
  const bool active = row0 < Sq;
  const float* qw = qs + warp * ROWS * Dh;
  float* pw = ps + warp * ROWS * kBlockK;
  float m[ROWS], l[ROWS], acc[ROWS][kDimSlots];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimSlots; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < k_end; j0 += kBlockK) {
    __syncthreads();                         // the last tile is read
    for (int i = threadIdx.x; i < kBlockK * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh;
      const bool in = j0 + j < k_end;
      const long g = kv_base + static_cast<long>(j0) * Dh + i;
      ks[j * (Dh + 1) + d] = in ? to_f(k[g]) : 0.f;
      vs[i] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (Dh + 1);
    for (int d = 0; d < Dh; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(qw[r * Dh + d], kd, s[r]);
    }
    const int key = j0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool ok = key < kvl && (!causal || key <= row0 + r + off);
      const float sv = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(sv - base);       // 0 for a masked key
      const float corr = expf(m[r] - base);  // 0 while nothing was valid
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kDimSlots; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      pw[r * kBlockK + lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < kBlockK; ++j) {
      float vj[kDimSlots];
#pragma unroll
      for (int c = 0; c < kDimSlots; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < Dh ? vs[j * Dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = pw[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < kDimSlots; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

  if (!active) return;
  T* ob = out + q_base;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    if (row >= Sq) break;
#pragma unroll
    for (int c = 0; c < kDimSlots; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) store(ob + static_cast<long>(row) * Dh + d, acc[r][c] / l[r]);
    }
  }
}

template <int WARPS, int ROWS, typename T>
cudaError_t launch_cuda_cores(const void* q, const void* k, const void* v,
                              const int* kv_len, void* out, int B, int Hq,
                              int Hkv, int Sq, int Sk, int Dh, float scale,
                              int causal, cudaStream_t st) {
  constexpr int BQ = WARPS * ROWS;
  auto kernel = attention_cuda_cores<WARPS, ROWS, T>;
  const size_t bytes = smem_floats<WARPS, ROWS>(Dh) * sizeof(float);
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t e = allow_smem(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, WARPS * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), Hq, Hkv, Sq, Sk,
      Dh, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------------
// prefill_wgmma: TMA and wgmma, bf16

constexpr int kTileRows = 64;             // q rows a tile: wgmma's M
constexpr int kTileKeys = 64;             // keys a tile: N of S = Q·Kᵀ
constexpr int kStages = 2;                // the K/V ring
constexpr int kBlockCols = 64;            // columns of a swizzled block
constexpr int kBlockBytes = 64 * 128;     // a block of a tile: 64 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
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

// A shared-memory matrix descriptor of the 128-byte swizzle, the layout
// TMA writes: rows of 128 bytes, their 16-byte pieces permuted by row % 8
// within each 1 KB group of 8 rows.  `sbo` is the byte distance between
// groups of 8 rows along M or N (K-major) or along K (MN-major); `lbo`
// that between 64-column blocks along N (MN-major; unused K-major).
// Inside a block the start address moves by 32 bytes a k16 step (K-major)
// or by 16 rows (MN-major); the swizzle follows the address bits.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         uint64_t{1} << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A·B, m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A·B, m64n64k16: A from registers, B MN-major in shared memory
// (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A·B, m64n128k16: A from registers, B MN-major in shared memory
// (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// Shared memory of a CTA: the head padded to D columns, each tile as D / 64
// blocks of [64 rows][64 columns] in the 128-byte swizzle (8 KB, 1 KB
// aligned), as TMA writes them.
template <int D, int NC>
struct WgmmaSmem {
  __nv_bfloat16 q[NC][D / kBlockCols][kTileRows * kBlockCols];
  __nv_bfloat16 k[kStages][D / kBlockCols][kTileKeys * kBlockCols];
  __nv_bfloat16 v[kStages][D / kBlockCols][kTileKeys * kBlockCols];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

// NC consumer warpgroups (threads [0, 128·NC)), one query head each, then
// one producer warp.  Consumer thread t of a warpgroup holds, in every
// 8-column chunk n of an m64nN accumulator, rows 16·(t / 32) + (t % 32) / 4
// and that + 8 at columns 8n + 2·(t % 4) and + 1 (registers 4n .. 4n + 3).
template <int D, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
attention_prefill_wgmma(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                        int Sq, int Sk, int Dh, float scale, int causal) {
  constexpr int kBlocks = D / kBlockCols;
  using Smem = WgmmaSmem<D, NC>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int tid = threadIdx.x;
  const int G = Hq / Hkv, splits = G / NC;
  const int hk = blockIdx.y / splits;
  const int h0 = hk * G + (blockIdx.y % splits) * NC;
  const int b = blockIdx.z, q0 = blockIdx.x * kTileRows;
  const int kvl = kv_len ? min(max(kv_len[b], 0), Sk) : Sk;
  const int off = Sk - Sq;                   // causal: j <= i + off
  const int q_last = min(q0 + kTileRows, Sq) - 1;
  const int k_end = causal ? min(kvl, q_last + off + 1) : kvl;
  const int n_tiles = k_end > 0 ? (k_end + kTileKeys - 1) / kTileKeys : 0;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC * 128) {                     // the producer warp
    if (tid == NC * 128) {
      // a box's columns past Dh and rows past S arrive as zeros, and
      // count in full
      const unsigned tile_bytes = kBlocks * kBlockBytes;
      mbar_expect_tx(&sm.q_full, NC * tile_bytes);
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < kBlocks; ++c)
          tma_load_3d(sm.q[w][c], &q_map, &sm.q_full, kBlockCols * c, q0,
                      b * Hq + h0 + w);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)                    // the consumers freed stage s
          mbar_wait(&sm.empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[s], tile_bytes);
        for (int c = 0; c < kBlocks; ++c)
          tma_load_3d(sm.k[s][c], &k_map, &sm.k_full[s], kBlockCols * c,
                      t * kTileKeys, b * Hkv + hk);
        mbar_expect_tx(&sm.v_full[s], tile_bytes);
        for (int c = 0; c < kBlocks; ++c)
          tma_load_3d(sm.v[s][c], &v_map, &sm.v_full[s], kBlockCols * c,
                      t * kTileKeys, b * Hkv + hk);
      }
    }
    return;
  }

  const int wg = tid / 128, lt = tid % 128, lane = lt % 32;
  const int h = h0 + wg;
  const int r_lo = q0 + 16 * (lt / 32) + lane / 4;  // and r_lo + 8
  const int c2 = 2 * (lane % 4);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * 1.4426950408889634f;   // · log2(e)

  mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, j0 = t * kTileKeys;
    const unsigned parity = (t / kStages) & 1;

    // S = Q·Kᵀ over the padded head, 16 columns (32 bytes) a step
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(&sm.k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, smem_desc(sm.q[wg][kk / 4] + 16 * (kk % 4), 16, 1024),
                   smem_desc(sm.k[s][kk / 4] + 16 * (kk % 4), 16, 1024),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale (to log2 units: P = 2^(x - max), one MUFU op a score), mask
    // the tiles that straddle the diagonal or kv_len, and the online
    // softmax of this thread's two rows (four lanes share a row)
    const bool edge = j0 + kTileKeys > kvl ||
                      (causal && j0 + kTileKeys - 1 > q0 + off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1), key = j0 + 8 * n + c2 + (e & 1);
        float x = sc[4 * n + e] * scale_log2;
        if (edge && !(key < kvl && (!causal || key <= row + off)))
          x = -INFINITY;
        sc[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      softmax_step<true>(m[i], mx[i], corr[i], base[i]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * n + e] - base[e >> 1]);
        sum[e >> 1] += p;
        sc[4 * n + e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
      sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P in bf16 as the A fragments of four k16 steps: the accumulator
    // layout of chunks 2kk and 2kk + 1 is the A layout of step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

    // O += P·V; V [keys][columns] is the MN-major B operand: 16 keys a
    // step, groups of 8 keys 1 KB apart, 64-column blocks 8 KB apart
    mbar_wait(&sm.v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(o, pa[kk], smem_desc(sm.v[s][0] + 16 * kk * kBlockCols,
                                       kBlockBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&sm.empty[s]);
  }

  __nv_bfloat16* ob = out + (static_cast<long>(b) * Hq + h) * Sq * Dh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + c2;
    if (col >= Dh) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo + 8 * i;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long>(row) * Dh +
                                           col) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] / l[i],
                                  o[4 * n + 2 * i + 1] / l[i]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// address, so the build needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [planes][rows][Dh] bf16 as a 3-D tensor map of [64 rows][64 columns]
// boxes in the 128-byte swizzle; a box's part past `rows` or Dh fills with
// zeros.
bool tile_map(EncodeTiled encode, CUtensorMap* map, const void* base, int Dh,
              int rows, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Dh) * 2,
                                 static_cast<cuuint64_t>(Dh) * 2 * rows};
  const cuuint32_t box[3] = {kBlockCols, 64, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* kv_len, void* out, int B, int Hq,
                         int Hkv, int Sq, int Sk, int Dh, float scale,
                         int causal, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!tile_map(encode, &q_map, q, Dh, Sq, B * Hq) ||
      !tile_map(encode, &k_map, k, Dh, Sk, B * Hkv) ||
      !tile_map(encode, &v_map, v, Dh, Sk, B * Hkv))
    return cudaErrorInvalidValue;
  auto kernel = attention_prefill_wgmma<D, NC>;
  const size_t bytes = sizeof(WgmmaSmem<D, NC>) + 1024;  // + alignment
  static size_t allowed[kMaxDevices] = {};
  const cudaError_t e = allow_smem(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kTileRows - 1) / kTileRows, Hkv * (Hq / Hkv / NC),
                  B);
  kernel<<<grid, NC * 128 + 32, bytes, st>>>(
      q_map, k_map, v_map, kv_len, static_cast<__nv_bfloat16*>(out), Hq, Hkv,
      Sq, Sk, Dh, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_wgmma_groups(const void* q, const void* k,
                                  const void* v, const int* kv_len, void* out,
                                  int B, int Hq, int Hkv, int Sq, int Sk,
                                  int Dh, float scale, int causal,
                                  cudaStream_t st) {
  // two query heads a CTA where the group divides by two, else one
  if ((Hq / Hkv) % 2 == 0)
    return launch_wgmma<D, 2>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                              scale, causal, st);
  return launch_wgmma<D, 1>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                            scale, causal, st);
}

cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           const int* kv_len, void* out, int B, int Hq,
                           int Hkv, int Sq, int Sk, int Dh, float scale,
                           int causal, cudaStream_t st) {
  if (Dh <= 64)
    return dispatch_wgmma_groups<64>(q, k, v, kv_len, out, B, Hq, Hkv, Sq,
                                     Sk, Dh, scale, causal, st);
  return dispatch_wgmma_groups<128>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk,
                                    Dh, scale, causal, st);
}

// ------------------------------------------------------------------
// decode: each KV head read once for its group, 16-byte loads

constexpr int kDecodeWarps = 8;
constexpr int kDecodeTile = 32;           // keys a warp takes, one a lane
constexpr int kLoadBatch = 8;             // loads in flight a lane

// A piece of a row as one load: 16 bytes (8 bf16 or 4 float), or one
// element where the row is not a whole number of 16-byte pieces.
template <typename T, int VEC>
using Piece = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ Piece<T, VEC> load_piece(const T* p, bool ok) {
  if constexpr (VEC == 1) {
    return ok ? *p : T(0.f);
  } else {
    return ok ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Piece<T, VEC>& piece,
                                       float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f(piece);
  } else {
    const T* e = reinterpret_cast<const T*>(&piece);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f(e[i]);
  }
}

// One CTA per (KV head, batch row, ROWS of the group's G·Sq query rows);
// row rr of the group is query head hk·G + rr / Sq, query position
// rr % Sq.
template <typename T, int ROWS, int VEC>
__global__ void __launch_bounds__(kDecodeWarps * 32)
attention_decode(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ out, int Hq, int Hkv, int Sq, int Sk, int Dh,
                 float scale, int causal) {
  // the pieces of a V row a lane holds: one, or four single elements
  constexpr int kPer = VEC == 1 ? kMaxHeadDim / 32 : 1;
  __shared__ float qs[ROWS][kMaxHeadDim];
  __shared__ float part_m[kDecodeWarps][ROWS], part_l[kDecodeWarps][ROWS];
  __shared__ float part_o[kDecodeWarps][ROWS][kMaxHeadDim];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y, rr0 = blockIdx.z * ROWS;
  const int G = Hq / Hkv, R = G * Sq;
  const int kvl = kv_len ? min(max(kv_len[b], 0), Sk) : Sk;
  const int off = Sk - Sq;
  auto q_index = [&](int rr) {
    return ((static_cast<long>(b) * Hq + hk * G + rr / Sq) * Sq + rr % Sq) *
           Dh;
  };
  for (int i = threadIdx.x; i < ROWS * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    qs[r][d] = rr0 + r < R ? to_f(q[q_index(rr0 + r) + d]) : 0.f;
  }
  int lim[ROWS];                             // row r sees keys j < lim[r]
  int k_end = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int rr = rr0 + r;
    lim[r] = rr >= R ? 0 : causal ? min(kvl, rr % Sq + off + 1) : kvl;
    k_end = max(k_end, lim[r]);
  }
  __syncthreads();

  const long kv_base = (static_cast<long>(b) * Hkv + hk) * Sk * Dh;
  const int n_pieces = Dh / VEC;             // pieces of a K or V row
  int lanes = 1;                             // lanes over a V row
  while (lanes < n_pieces && lanes < 32) lanes <<= 1;
  const int keys_at_once = 32 / lanes, vi = lane % lanes, kk = lane / lanes;

  float m[ROWS], l[ROWS], acc[ROWS][kPer * VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer * VEC; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = warp * kDecodeTile; t0 < k_end;
       t0 += kDecodeWarps * kDecodeTile) {
    // lane j scores key t0 + j against every row
    const int key = t0 + lane;
    const bool live = key < k_end;
    const T* kr = k + kv_base + static_cast<long>(key) * Dh;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    for (int p0 = 0; p0 < n_pieces; p0 += kLoadBatch) {
      Piece<T, VEC> piece[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        piece[u] = load_piece<T, VEC>(kr + (p0 + u) * VEC,
                                      live && p0 + u < n_pieces);
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        if (p0 + u >= n_pieces) break;
        float f[VEC];
        unpack<T, VEC>(piece[u], f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            s[r] = fmaf(qs[r][(p0 + u) * VEC + e], f[e], s[r]);
      }
    }
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sv = key < lim[r] ? s[r] * scale : -INFINITY;
      float corr, base;
      softmax_step(m[r], warp_max(sv), corr, base);
      p[r] = expf(sv - base);                // 0 for a masked key
      l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
      for (int e = 0; e < kPer * VEC; ++e) acc[r][e] *= corr;
    }

    // P·V: `lanes` lanes over a V row, `keys_at_once` keys at a time
    for (int i0 = 0; i0 < lanes; i0 += kLoadBatch) {
      Piece<T, VEC> piece[kLoadBatch][kPer];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int j = t0 + (i0 + u) * keys_at_once + kk;
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          piece[u][c] = load_piece<T, VEC>(
              v + kv_base + static_cast<long>(j) * Dh + (vi + 32 * c) * VEC,
              i0 + u < lanes && j < k_end && vi + 32 * c < n_pieces);
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        if (i0 + u >= lanes) break;
        const int src = (i0 + u) * keys_at_once + kk;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pj = __shfl_sync(kFull, p[r], src);
#pragma unroll
          for (int c = 0; c < kPer; ++c) {
            float f[VEC];
            unpack<T, VEC>(piece[u][c], f);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[r][c * VEC + e] = fmaf(pj, f[e], acc[r][c * VEC + e]);
          }
        }
      }
    }
  }

  // the lanes that took other keys of the same columns, then the warps
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < kPer * VEC; ++e)
      for (int o = lanes; o < 32; o <<= 1)
        acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], o);
  if (kk == 0) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int piece = vi + 32 * c;
      if (piece >= n_pieces) break;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part_o[warp][r][piece * VEC + e] = acc[r][c * VEC + e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      part_m[warp][r] = m[r];
      part_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i - r * Dh;
    if (rr0 + r >= R) break;
    float mx = -INFINITY;
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, part_m[w][r]);
    float sum = 0.f, o = 0.f;                // NaN where no key is valid
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = expf(part_m[w][r] - mx);
      sum += part_l[w][r] * e;
      o += part_o[w][r][d] * e;
    }
    store(out + q_index(rr0 + r) + d, o / sum);
  }
}

template <typename T, int ROWS>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* kv_len, void* out, int B, int Hq,
                          int Hkv, int Sq, int Sk, int Dh, float scale,
                          int causal, cudaStream_t st) {
  const int rows = Hq / Hkv * Sq;
  const dim3 grid(Hkv, B, (rows + ROWS - 1) / ROWS);
  constexpr int kVec = 16 / sizeof(T);
  auto kernel = Dh % kVec == 0 ? attention_decode<T, ROWS, kVec>
                               : attention_decode<T, ROWS, 1>;
  kernel<<<grid, kDecodeWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), Hq, Hkv, Sq, Sk,
      Dh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(const void* q, const void* k, const void* v,
                            const int* kv_len, void* out, int B, int Hq,
                            int Hkv, int Sq, int Sk, int Dh, float scale,
                            int causal, cudaStream_t st) {
  const int rows = Hq / Hkv * Sq;            // a group's query rows
  if (rows <= 1)
    return launch_decode<T, 1>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                               scale, causal, st);
  if (rows <= 2)
    return launch_decode<T, 2>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                               scale, causal, st);
  if (rows <= 4)
    return launch_decode<T, 4>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                               scale, causal, st);
  return launch_decode<T, 8>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                             scale, causal, st);
}

template <typename T>
cudaError_t dispatch(int variant, const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, int B, int Hq, int Hkv,
                     int Sq, int Sk, int Dh, float scale, int causal,
                     cudaStream_t st) {
  switch (variant) {
    case kCudaCores:                         // as it was for every call
      if (Sq <= 4)                           // one row a warp
        return launch_cuda_cores<4, 1, T>(q, k, v, kv_len, out, B, Hq, Hkv,
                                          Sq, Sk, Dh, scale, causal, st);
      return launch_cuda_cores<4, 16, T>(q, k, v, kv_len, out, B, Hq, Hkv, Sq,
                                         Sk, Dh, scale, causal, st);
    case kDecode:
      return dispatch_decode<T>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                                scale, causal, st);
    case kPrefillWgmma:
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (Dh % 8 == 0)
          return dispatch_wgmma(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Sk, Dh,
                                scale, causal, st);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh] (bf16 != 0: __nv_bfloat16,
// else float), contiguous; kv_len int [B] or null (every key valid).
// `variant` is the wrapper's choice: 0 cuda_cores, 1 prefill_wgmma (bf16,
// Dh % 8 == 0), 2 decode; prefill_wgmma and decode take 16-byte-aligned
// operands.  Logits are scaled by Dh^-0.5, rounded
// once to float as the plain version's Python scalar is.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* kv_len,
                                      void* out, int B, int Hq, int Hkv,
                                      int Sq, int Sk, int Dh, int causal,
                                      int bf16, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(Dh)));
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(variant, q, k, v, kv_len, out, B, Hq,
                                     Hkv, Sq, Sk, Dh, scale, causal, st)
           : dispatch<float>(variant, q, k, v, kv_len, out, B, Hq, Hkv, Sq,
                             Sk, Dh, scale, causal, st);
  return static_cast<int>(e);
}

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
