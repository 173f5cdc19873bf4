// Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel repro/kernels/ssd_scan.py:
// ssd_scan (_ssd_kernel). For each (batch b, head h), over chunks of L
// positions, with a = dt * A (A < 0, so every a <= 0) and cum the inclusive
// prefix sum of a inside the chunk:
//
//     y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) (x_j dt_j)
//           + exp(cum_i) (C_i . S[p, :])                      for each p
//     S'  = exp(cum_L) S + sum_j exp(cum_L - cum_j) (x_j dt_j) (x) B_j
//
// with B and C shared across heads, the (P, N) state S in float32, and y
// rounded once to x's type, as the TPU kernel computes (ssd_scan.py:22-56).
// Extended by what the model path needs: S starts from an optional float32
// initial state (B, H, P, N) instead of zeros, and the final S is written
// out (models/ssm.py:mamba2_block carries it into decode, and into the next
// prefill as the reference does).
//
// Layouts: x (B, S, H, P), dt (B, S, H), B and C (B, S, N), each given by
// element strides with the last axis contiguous, so the model's slices of
// its conv output pass without a copy; y (B, S, H, P) and both states
// (B, H, P, N) contiguous.
//
// Design: one block of 256 threads per (h, b). A loop over chunks takes the
// place of the TPU's sequential grid axis, and the state stays in shared
// memory from the first chunk to the last. Per chunk the block stages x*dt
// (L, P), B and C (L, N+1: padded so that threads reading consecutive rows
// hit distinct banks) and cum in shared memory, forms the causal score tile
// G_ij = (C_i . B_j) exp(cum_i - cum_j) for j <= i only (the exponent is
// masked before the exp, so it is never positive and cannot overflow), then
// y from G and the state, then the new state. At P = N = L = 64 that is
// about 83 KB of shared memory, above the 48 KB default, so the launcher
// raises the kernel's dynamic shared memory limit. C . B_j is the same for
// every head (B and C are shared); computing it once per (b, chunk) is a
// later speed item. CUDA cores only, no tensor cores yet.
//
// What bounds it: on the serving path (zamba2-2.7b prefill: B 4, S 128,
// H 80, P 64, N 64, bf16 x, B, C) it moves about 21 MB (x and y 5.2 MB each,
// the states in and out 5.2 MB each, dt, B and C 0.3 MB): 6.4 us at
// 3.35 TB/s. Its 1.3 GFLOP are 20 us at the card's 67 TFLOP/s of float32
// FMA, so on CUDA cores the operations bound it. It launches 54 times per
// prefill (once per Mamba2 layer).
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

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  const float* s0;  // may be null: start from zeros
  void* y;
  float* s_out;
  int64_t xb, xs, xh;  // element strides of x over B, S, H
  int64_t db, ds, dh;  // of dt
  int64_t bb, bs;      // of B
  int64_t cb, cs;      // of C
  int seqlen, heads, p, n, chunk;
};

// Shared memory floats of one block; the wrapper's smem_bytes agrees.
size_t smem_floats(int p, int n, int l) {
  return (size_t)p * (n + 1) + (size_t)l * p + 2 * (size_t)l * (n + 1) +
         (size_t)l * l + 3 * (size_t)l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int P = a.p, N = a.n, L = a.chunk, N1 = N + 1;
  float* st = smem;               // (P, N+1) state S[p][n]
  float* xd = st + P * N1;        // (L, P)   x * dt
  float* bsm = xd + L * P;        // (L, N+1) B
  float* csm = bsm + L * N1;      // (L, N+1) C
  float* g = csm + L * N1;        // (L, L)   masked, decayed C.B
  float* cum = g + L * L;         // (L)      dt, then cumsum of dt * A
  float* ecum = cum + L;          // (L)      exp(cum_i)
  float* wdec = ecum + L;         // (L)      exp(cum_L - cum_j)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* x = (const T*)a.x;
  const T* bm = (const T*)a.bm;
  const T* cm = (const T*)a.cm;
  T* y = (T*)a.y;
  const float A = a.A[h];
  const int64_t sbase = ((int64_t)b * a.heads + h) * P * N;

  for (int idx = tid; idx < P * N; idx += kThreads)
    st[(idx / N) * N1 + idx % N] = a.s0 ? a.s0[sbase + idx] : 0.0f;

  for (int t0 = 0; t0 < a.seqlen; t0 += L) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < L; i += kThreads)
      cum[i] = a.dt[b * a.db + (int64_t)(t0 + i) * a.ds + h * a.dh];
    __syncthreads();
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int i = idx / P, pp = idx % P;
      xd[idx] = to_f32(x[b * a.xb + (int64_t)(t0 + i) * a.xs + h * a.xh + pp]) *
                cum[i];
    }
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int i = idx / N, nn = idx % N;
      bsm[i * N1 + nn] = to_f32(bm[b * a.bb + (int64_t)(t0 + i) * a.bs + nn]);
      csm[i * N1 + nn] = to_f32(cm[b * a.cb + (int64_t)(t0 + i) * a.cs + nn]);
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int i = 0; i < L; ++i) {
        run += cum[i] * A;
        cum[i] = run;
      }
    }
    __syncthreads();

    const float cum_last = cum[L - 1];
    for (int i = tid; i < L; i += kThreads) {
      ecum[i] = expf(cum[i]);
      wdec[i] = expf(cum_last - cum[i]);
    }
    for (int idx = tid; idx < L * L; idx += kThreads) {
      const int i = idx / L, j = idx % L;
      float v = 0.0f;
      if (j <= i) {
        const float* ci = csm + i * N1;
        const float* bj = bsm + j * N1;
        float dot = 0.0f;
        for (int nn = 0; nn < N; ++nn) dot += ci[nn] * bj[nn];
        v = dot * expf(cum[i] - cum[j]);  // exponent <= 0: masked first
      }
      g[idx] = v;
    }
    __syncthreads();

    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int i = idx / P, pp = idx % P;
      const float* gi = g + i * L;
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc += gi[j] * xd[j * P + pp];
      const float* ci = csm + i * N1;
      const float* sp = st + pp * N1;
      float off = 0.0f;
      for (int nn = 0; nn < N; ++nn) off += ci[nn] * sp[nn];
      acc += off * ecum[i];
      store(y + (((int64_t)b * a.seqlen + t0 + i) * a.heads + h) * P + pp,
            acc);
    }
    __syncthreads();  // every y has read the old state

    const float chunk_decay = expf(cum_last);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int pp = idx / N, nn = idx % N;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j)
        acc += xd[j * P + pp] * (bsm[j * N1 + nn] * wdec[j]);
      float* s = st + pp * N1 + nn;
      *s = *s * chunk_decay + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads)
    a.s_out[sbase + idx] = st[(idx / N) * N1 + idx % N];
}

template <typename T>
int launch(const Args& a, int batch, int device, cudaStream_t stream) {
  const size_t smem = smem_floats(a.p, a.n, a.chunk) * sizeof(float);
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(ssd_scan_kernel<T>, (int)smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.heads, (unsigned)batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); dt, A and the
// states are float32. strides: 10 element strides, x (B, S, H), dt (B, S,
// H), B (B, S), C (B, S). s0 may be null. Launches on `device`'s
// `stream` without synchronising; returns cudaGetLastError().
int repro_ssd_scan(const void* x, const void* dt, const void* A,
                   const void* bm, const void* cm, const void* s0, void* y,
                   void* s_out, const int64_t* strides, int batch, int seqlen,
                   int heads, int p, int n, int chunk, int dtype,
                   int device, void* stream) {
  if (batch <= 0 || batch > 65535 || seqlen <= 0 || heads <= 0 || p <= 0 ||
      n <= 0 || chunk <= 0 || seqlen % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.bm = bm;
  a.cm = cm;
  a.s0 = (const float*)s0;
  a.y = y;
  a.s_out = (float*)s_out;
  a.xb = strides[0], a.xs = strides[1], a.xh = strides[2];
  a.db = strides[3], a.ds = strides[4], a.dh = strides[5];
  a.bb = strides[6], a.bs = strides[7];
  a.cb = strides[8], a.cs = strides[9];
  a.seqlen = seqlen, a.heads = heads, a.p = p, a.n = n, a.chunk = chunk;
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, batch, device, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, batch, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(ssd_scan, repro_ssd_scan)
