// Capacity-layout grouped expert GEMM, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel repro/kernels/moe_gemm.py:
// moe_gemm (_moe_kernel). For each expert e:
//
//     out[e] = x[e] @ w[e]        x (E, C, K), w (E, K, N), out (E, C, N)
//
// with float32 sums and the output rounded once to x's type, as the TPU
// kernel's float32 accumulator does (moe_gemm.py:22-36). Any C, K and N:
// the ragged edges of every tile are masked (the TPU kernel asserts each
// dimension divides its block). All three tensors contiguous.
//
// Design: a tiled kernel over (N tile, C tile, expert), 256 threads, each
// thread owning TM x 4 outputs of a (16 TM) x 64 tile. The K loop stages a
// (16 TM) x 32 tile of x (stored transposed, padded a column against bank
// conflicts) and a 32 x 64 tile of w in shared memory as float32, and loads
// the next tiles into registers while the current ones are multiplied, so
// one tile's global loads overlap the other's arithmetic. TM = 1 (16 rows)
// for the decode step's C = 8, where every row of w is read once and the
// bytes of w are all that matters; TM = 4 (64 rows) for the prefill's
// C = 60, so that each w element read feeds 64 rows. FMA on CUDA cores;
// mma.sync / wgmma tensor-core tiles are the next speed item.
//
// What bounds it: on the serving path (deepseek-moe-16b: E 64, K 2048 and
// N 1408, or K 1408 and N 2048, bf16) every launch reads the whole 369 MB
// of its expert weights: 110 us at 3.35 TB/s, at decode (C = 8) and at
// prefill (C = 60, 22 GFLOP, 22 us at the bf16 tensor-core peak) alike.
// It launches 81 times per prefill and per decode step (three products in
// each of 27 MoE layers).
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the wrapper raises when it is not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// TM rows per thread: the tile is BM = 16 * TM rows by kBN columns.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int C, int K, int N) {
  constexpr int BM = 16 * TM;
  constexpr int XPT = BM * kBK / kThreads;   // x elements a thread stages
  constexpr int WPT = kBK * kBN / kThreads;  // w elements a thread stages
  __shared__ float xs[kBK][BM + 1];
  __shared__ float ws[kBK][kBN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xe = x + (int64_t)e * C * K;
  const T* we = w + (int64_t)e * K * N;

  float xr[XPT], wr[WPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < XPT; ++l) {
      const int idx = tid + l * kThreads;
      const int i = idx / kBK, kk = idx % kBK;
      const int gm = m0 + i, gk = k0 + kk;
      xr[l] = (gm < C && gk < K) ? to_f32(xe[(int64_t)gm * K + gk]) : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < WPT; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx / kBN, j = idx % kBN;
      const int gk = k0 + kk, gn = n0 + j;
      wr[l] = (gk < K && gn < N) ? to_f32(we[(int64_t)gk * N + gn]) : 0.0f;
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < XPT; ++l) {
      const int idx = tid + l * kThreads;
      xs[idx % kBK][idx / kBK] = xr[l];
    }
#pragma unroll
    for (int l = 0; l < WPT; ++l) {
      const int idx = tid + l * kThreads;
      ws[idx / kBN][idx % kBN] = wr[l];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], bv[4];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = xs[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = ws[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * bv[c];
    }
    __syncthreads();
  }

  T* oe = out + (int64_t)e * C * N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + ty + 16 * r;
    if (gm >= C) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + tx + 16 * c;
      if (gn < N) store(oe + (int64_t)gm * N + gn, acc[r][c]);
    }
  }
}

template <typename T, int TM>
int launch(const void* x, const void* w, void* out, int E, int C, int K,
           int N, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kBN - 1) / kBN),
                  (unsigned)((C + 16 * TM - 1) / (16 * TM)), (unsigned)E);
  moe_gemm_kernel<T, TM><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)out, C, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int E, int C, int K,
             int N, cudaStream_t stream) {
  if (C <= 16) return launch<T, 1>(x, w, out, E, C, K, N, stream);
  return launch<T, 4>(x, w, out, E, C, K, N, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). Launches on
// `stream` without synchronising; returns cudaGetLastError().
int repro_moe_gemm(const void* x, const void* w, void* out, int E, int C,
                   int K, int N, int dtype, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || K <= 0 || N <= 0 ||
      (C + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(x, w, out, E, C, K, N, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, E, C, K, N, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
