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
// One warp per row: the lanes read the row in coalesced 32-element
// pieces, sum their squares in float32, reduce by shuffles, and read the
// row again (from L1/L2) to scale it.  No shared memory.  The mean is the
// sum over D, divided by D; the inverse root is 1 / sqrtf (IEEE, as the
// build has no fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, long rows_per_chain, long n_rows, int D,
               float eps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;                // the whole warp leaves
  const T* xr = x + row * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f(xr[d]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  const float* wr = w + (row / rows_per_chain) * D;
  T* orow = out + row * D;
  for (int d = lane; d < D; d += 32) store(orow + d, to_f(xr[d]) * inv * wr[d]);
}

}  // namespace

// x, out [C, R, D] (bf16 != 0: __nv_bfloat16, else float); w float [C, D].
extern "C" int rmsnorm_launch(const void* x, const float* w, void* out,
                              int C, int R, int D, float eps, int bf16,
                              void* stream) {
  const long n_rows = static_cast<long>(C) * R;
  const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w,
        static_cast<__nv_bfloat16*>(out), R, n_rows, D, eps);
  else
    rmsnorm_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), w, static_cast<float*>(out), R, n_rows,
        D, eps);
  return static_cast<int>(cudaGetLastError());
}

// The launchers return cudaGetLastError() as an int; this names it.  Each
// source builds into its own shared library, so each defines it once.
extern "C" const char* slda_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
