// Fused RMSNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel repro/kernels/rmsnorm.py:
// rmsnorm_fwd (_rmsnorm_kernel). Per row of D values, with float32
// statistics:
//
//     out = round(x * rsqrt(mean(x^2) + eps) * scale)
//
// multiplied in float32 and rounded once to x's type, as the TPU kernel does
// (rmsnorm.py:15-17). The model's plain rmsnorm rounds x * rsqrt(...) to x's
// type first and then multiplies by scale (models/layers.py:34); the two
// differ by at most one rounding of the output type.
//
// Design: one block of 256 threads per row. Each thread sums x^2 over the
// columns i = tid, tid + 256, ...; a warp-shuffle reduction, then one across
// the 8 warps in shared memory, gives the row's sum. The second pass reads x
// again (from L1/L2) and writes the output. Rows are contiguous: the wrapper
// (repro_torch/kernels/rmsnorm.py) checks that. x and out are float32 or
// bfloat16; scale is float32 or bfloat16, independently.
//
// What bounds it: bytes. It reads x once and scale once and writes out once.
// On the serving path (llama3.2-3b, D = 3072, bf16): a decode step norms
// 4 rows, about 55 KB, which the card's 3.35 TB/s moves in 16 ns, so each
// launch is bound by launch latency; a prefill of 4 x 128 tokens norms 512
// rows, about 6.3 MB, bound at about 1.9 us. It launches 57 times per forward
// pass (2 per layer and the final norm).
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the wrapper raises when it is not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);

  __shared__ float partial[kWarps];
  __shared__ float inv_rms;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
    if (threadIdx.x == 0) inv_rms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads)
    store(orow + i, to_f32(xr[i]) * r * to_f32(scale[i]));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int64_t rows, int d,
           float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, S><<<(unsigned)rows, kThreads, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Launches on `stream` without
// synchronising; returns cudaGetLastError().
int repro_rmsnorm(const void* x, const void* scale, void* out, int64_t rows,
                  int d, float eps, int x_dtype, int scale_dtype,
                  void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
