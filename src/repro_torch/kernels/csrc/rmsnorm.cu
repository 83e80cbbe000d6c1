// Kernel B7: RMSNorm over rows, with a weight per chain (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` of the reference
// (src/repro/kernels/rmsnorm.py:12) in the form the models call
// (`models/layers.py` `rmsnorm`): x [C, R, D] in float32 or bf16, w
// float32 [C, D]; row r of chain c becomes
//   y = x * rsqrt(mean(x^2) + eps) * w[c],
// in float32, cast back to x's type.  The TPU kernel's w [D] is C = 1.
//
// Bound: bytes (x read, y written, w read; a few operations per element).
// Two variants, chosen by the wrapper from dtype and D
// (`rmsnorm.variant`):
//
// * rows_in_registers (D a whole number of 16-byte pieces, at most 2,048
//   of them).  Each row is read once: TPR threads hold it in registers,
//   one 16-byte piece (8 bf16 or 4 float) a thread, up to a block of 256
//   threads, then 2, 4 or 8 pieces a thread; piece i of thread s at
//   (i·TPR + s)·VEC, so each load of the row's threads is contiguous.
//   Short rows (D = 128 in bf16, q_norm and k_norm: 16 threads) share a
//   block 16 to a block; D 2048 in bf16 takes a block, 4096 in float32 a
//   block of 4 pieces a thread.  The squares are summed in float32 in
//   VEC running sums, one per position in a piece, then pairwise, then
//   over the row's lanes by shuffles and over its warps in order through
//   shared memory; the registers are scaled (the weights were loaded
//   beside the row) and stored as 16-byte pieces.  x is read evict-first
//   (`__ldcs`): no kernel reads it again before the residual add, by which
//   the layer's weights have streamed through L2.  A block holds rows of
//   one chain (blockIdx.y), so the weight row needs no division.
// * two_pass (any other D).  One warp per row reads the row in 32-element
//   pieces to sum its squares, and again (from L1/L2) to scale it.
//
// The squares are summed in float32; the mean and the inverse root are
// taken in float64 and carried as a float32 pair hi + lo, and
// y = x·inv·w takes one rounding (`scale`): closer to the float64 RMSNorm
// than the plain version's two roundings after rsqrt of a float32 mean.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // a block of rows_in_registers
constexpr int kWarps = 4;                  // a block of two_pass
constexpr unsigned kFull = 0xffffffffu;

// The variants, as the wrapper numbers them.
constexpr int kRowsInRegisters = 0;
constexpr int kTwoPass = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 1 / sqrt(ss / D + eps) from the float32 sum of squares, in float64, as
// hi + lo (hi within half an ulp, the pair within some 2^-46): rsqrtf's
// estimate and one Newton step in float64 (error 1.5·(2^-22)^2), with
// 1 / D from the host, so no float64 division or root a row.
struct InvRms {
  float hi, lo;
};
__device__ __forceinline__ InvRms inv_rms(float ss, double inv_d, float eps) {
  const double m = fma(static_cast<double>(ss), inv_d,
                       static_cast<double>(eps));
  const double y = rsqrtf(static_cast<float>(m));
  const double inv = y * fma(-0.5 * m, y * y, 1.5);
  const float hi = static_cast<float>(inv);
  return {hi, static_cast<float>(inv - hi)};
}

// x·inv·w rounded once: x·hi splits exactly into t + e (fmaf), and
// (t + e)·w takes its one rounding in the last fmaf.
__device__ __forceinline__ float scale(float x, InvRms inv, float w) {
  const float t = x * inv.hi;
  const float e = fmaf(x, inv.lo, fmaf(x, inv.hi, -t));
  return fmaf(t, w, e * w);
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// TPR threads a row (kThreads / TPR rows a block), NV pieces a thread.
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_in_registers(const T* __restrict__ x,
                          const float* __restrict__ w, T* __restrict__ out,
                          int R, int D, double inv_d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kLanes = TPR < 32 ? TPR : 32;        // a row's lanes a warp
  constexpr int kWarpsPerRow = TPR / kLanes;
  __shared__ float warp_ss[kThreads / 32];
  const int sub = threadIdx.x % TPR, c = blockIdx.y;
  const long row =
      static_cast<long>(blockIdx.x) * (kThreads / TPR) + threadIdx.x / TPR;
  const bool live = row < R;                 // every thread reduces below
  const long at = (static_cast<long>(c) * R + row) * D;

  // the row's pieces and their weights, all loads in flight at once
  const float* wr = w + static_cast<long>(c) * D;
  uint4 piece[NV];
  float4 wv[NV][VEC / 4];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = (i * TPR + sub) * VEC;
    const bool in = live && d < D;
    piece[i] = in ? __ldcs(reinterpret_cast<const uint4*>(x + at + d))
                  : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      wv[i][j] = in ? __ldg(reinterpret_cast<const float4*>(wr + d + 4 * j))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float part[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[e] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[VEC];
    unpack(piece[i], f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[e] += f[e] * f[e];
  }
#pragma unroll
  for (int n = VEC / 2; n > 0; n >>= 1)
#pragma unroll
    for (int e = 0; e < n; ++e) part[e] += part[e + n];
  float ss = part[0];
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  if constexpr (kWarpsPerRow > 1) {          // the row's warps, in order
    if (threadIdx.x % 32 == 0) warp_ss[threadIdx.x / 32] = ss;
    __syncthreads();
    const int first = threadIdx.x / TPR * kWarpsPerRow;
    ss = 0.f;
#pragma unroll
    for (int j = 0; j < kWarpsPerRow; ++j) ss += warp_ss[first + j];
  }
  if (!live) return;
  const InvRms inv = inv_rms(ss, inv_d, eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d = (i * TPR + sub) * VEC;
    if (d >= D) break;
    float f[VEC];
    unpack(piece[i], f);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      f[4 * j] = scale(f[4 * j], inv, wv[i][j].x);
      f[4 * j + 1] = scale(f[4 * j + 1], inv, wv[i][j].y);
      f[4 * j + 2] = scale(f[4 * j + 2], inv, wv[i][j].z);
      f[4 * j + 3] = scale(f[4 * j + 3], inv, wv[i][j].w);
    }
    *reinterpret_cast<uint4*>(out + at + d) = pack(f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_two_pass(const T* __restrict__ x, const float* __restrict__ w,
                 T* __restrict__ out, int R, int D, double inv_d, float eps) {
  const int lane = threadIdx.x & 31, c = blockIdx.y;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;                      // the whole warp leaves
  const T* xr = x + (static_cast<long>(c) * R + row) * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f(xr[d]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  const InvRms inv = inv_rms(ss, inv_d, eps);
  const float* wr = w + static_cast<long>(c) * D;
  T* orow = out + (static_cast<long>(c) * R + row) * D;
  for (int d = lane; d < D; d += 32)
    store(orow + d, scale(to_f(xr[d]), inv, wr[d]));
}

template <typename T, int TPR, int NV>
cudaError_t launch_registers(const T* x, const float* w, T* out, int C,
                             int R, int D, float eps, cudaStream_t st) {
  constexpr int kRows = kThreads / TPR;
  const dim3 grid((R + kRows - 1) / kRows, C);
  rmsnorm_rows_in_registers<T, TPR, NV>
      <<<grid, kThreads, 0, st>>>(x, w, out, R, D, 1.0 / D, eps);
  return cudaGetLastError();
}

// One piece a thread, as many threads a row as that needs (at least 4, at
// most a block: the most loads in flight at once); 2, 4 or 8 pieces a
// thread past a block's worth.
template <typename T>
cudaError_t dispatch_registers(const T* x, const float* w, T* out, int C,
                               int R, int D, float eps, cudaStream_t st) {
  const int n = D / (16 / static_cast<int>(sizeof(T)));
#define REPRO_B7(TPR, NV)                                              \
  if (n <= (TPR) * (NV))                                               \
    return launch_registers<T, TPR, NV>(x, w, out, C, R, D, eps, st);
  REPRO_B7(4, 1)
  REPRO_B7(8, 1)
  REPRO_B7(16, 1)
  REPRO_B7(32, 1)
  REPRO_B7(64, 1)
  REPRO_B7(128, 1)
  REPRO_B7(256, 1)
  REPRO_B7(256, 2)
  REPRO_B7(256, 4)
  REPRO_B7(256, 8)
#undef REPRO_B7
  return cudaErrorInvalidValue;              // the wrapper's two_pass
}

template <typename T>
cudaError_t dispatch(int variant, const void* x, const float* w, void* out,
                     int C, int R, int D, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (variant == kRowsInRegisters) {
    if (D % (16 / static_cast<int>(sizeof(T)))) return cudaErrorInvalidValue;
    return dispatch_registers<T>(xt, w, ot, C, R, D, eps, st);
  }
  if (variant != kTwoPass) return cudaErrorInvalidValue;
  const dim3 grid((R + kWarps - 1) / kWarps, C);
  rmsnorm_two_pass<T>
      <<<grid, kWarps * 32, 0, st>>>(xt, w, ot, R, D, 1.0 / D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out [C, R, D] (bf16 != 0: __nv_bfloat16, else float); w float [C, D].
// `variant` is the wrapper's choice: 0 rows_in_registers (16-byte-aligned
// operands, D a whole number of 16-byte pieces, at most 2,048), 1
// two_pass.
extern "C" int rmsnorm_launch(const void* x, const float* w, void* out,
                              int C, int R, int D, float eps, int bf16,
                              int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(variant, x, w, out, C, R, D, eps, st)
           : dispatch<float>(variant, x, w, out, C, R, D, eps, st);
  return static_cast<int>(e);
}

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
