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
// Design: one block per row, one pass. On the vector path each thread reads
// up to kVecs 16-byte vectors of the row (8 bf16 or 4 float32 values each,
// neighbouring threads on neighbouring vectors) and the matching values of
// scale, all before the reduction, so a launch waits for memory once, and
// keeps them in registers; a warp-shuffle reduction, then one across the
// warps through shared memory, gives the row's sum of squares to every
// warp; each thread then scales its vectors and writes them back 16 bytes
// at a time. The block has
// as many warps as the row needs (3 for D = 3072 in bf16, 5 for 5120), so
// the decode step's 4 rows are 4 short blocks and a prefill's 512 rows fill
// the card in one wave. The scalar path, for a D that is not a multiple of
// the vector or a row that is not 16-byte aligned (the wrapper,
// repro_torch/kernels/rmsnorm.py, chooses it), reads the row twice with
// 2- or 4-byte loads, the second time from L1. Rows are contiguous. x and
// out are float32 or bfloat16; scale is float32 or bfloat16, independently.
//
// What bounds it: bytes. It reads x once and scale once and writes out once.
// On the serving path (llama3.2-3b, D = 3072, bf16): a decode step norms
// 4 rows, about 55 KB, which the card's 3.35 TB/s moves in 16 ns, so each
// launch is bound by launch latency and the host's launch path; a prefill
// of 4 x 128 tokens norms 512 rows, about 6.3 MB, bound at about 1.9 us. It
// launches 57 times per forward pass (2 per layer and the final norm).
//
// A C launcher, called from Python through the extension module that
// csrc/launch.cuh makes of the library: it returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // 128 registers a thread, no spills
constexpr int kScalarThreads = 256;
constexpr int kVecs = 4;   // 16-byte vectors a thread holds on the vector path
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// N values of type U, aligned so that a copy is one 16-byte load or store
// (two for 32 bytes of float32 scale, one 8-byte load for 8 bytes).
template <typename U, int N>
struct alignas(N * sizeof(U) < 16 ? N * sizeof(U) : 16) Vec {
  U v[N];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum of v over the block, returned to every thread: each warp reduces
// the warps' partial sums itself, so one barrier suffices.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kMaxThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  const int warps = (blockDim.x + 31) >> 5;
  return warp_sum(lane < warps ? partial[lane] : 0.0f);
}

template <typename T, typename S, bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  if constexpr (kVector) {
    // x and scale are both read before the reduction: one round trip
    constexpr int V = 16 / (int)sizeof(T);   // values of one 16-byte vector
    using XV = Vec<T, V>;
    using SV = Vec<S, V>;
    const int nvec = d / V;
    XV xv[kVecs];
    SV sv[kVecs];
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        xv[j] = reinterpret_cast<const XV*>(xr)[i];
        sv[j] = reinterpret_cast<const SV*>(scale)[i];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float v = to_f32(xv[j].v[e]);
          ss += v * v;
        }
      }
    }
    const float r = rsqrtf(block_sum(ss) / (float)d + eps);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < nvec) {
        XV o;
#pragma unroll
        for (int e = 0; e < V; ++e)
          store(o.v + e, to_f32(xv[j].v[e]) * r * to_f32(sv[j].v[e]));
        reinterpret_cast<XV*>(orow)[i] = o;
      }
    }
  } else {
    float ss = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    const float r = rsqrtf(block_sum(ss) / (float)d + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      store(orow + i, to_f32(xr[i]) * r * to_f32(scale[i]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int64_t rows, int d,
           float eps, int vector, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vector) {
    if (d % V != 0 || d > kMaxThreads * kVecs * V ||
        ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int per_thread = (d / V + kVecs - 1) / kVecs;
    const int threads = (per_thread + 31) / 32 * 32;
    rmsnorm_kernel<T, S, true><<<(unsigned)rows, threads, 0, stream>>>(
        (const T*)x, (const S*)scale, (T*)out, d, eps);
  } else {
    rmsnorm_kernel<T, S, false><<<(unsigned)rows, kScalarThreads, 0,
                                  stream>>>((const T*)x, (const S*)scale,
                                            (T*)out, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. vector: 1 for the one-pass path
// with 16-byte vectors (d a multiple of 16 bytes' worth of x, at most
// 2048 vectors, the three pointers 16-byte aligned), 0 for the scalar path.
// Launches on `device`'s `stream` without synchronising; returns
// cudaGetLastError().
int repro_rmsnorm(const void* x, const void* scale, void* out, int64_t rows,
                  int d, float eps, int x_dtype, int scale_dtype, int vector,
                  int device, void* stream) {
  if (rows <= 0 || rows > 0x7fffffff || d <= 0)
    return (int)cudaErrorInvalidValue;
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, eps, vector, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, vector,
                                        s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, vector,
                                        s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                 vector, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(rmsnorm, repro_rmsnorm)
