// RWKV6 WKV chunked scan, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel repro/kernels/rwkv6_scan.py:
// rwkv6_scan (_rwkv_kernel). For each (batch b, head h), over chunks of L
// positions, with logw already clipped to [-6, 0] by the wrapper, cum the
// inclusive and cum_ex the exclusive prefix sum of logw inside the chunk
// (per channel k), and the (K, V) state S in float32:
//
//     A_ij = sum_k r_ik k_jk exp(cum_ex_ik - cum_jk)          for j < i
//     o_i  = sum_{j<i} A_ij v_j + (r_i . (u * k_i)) v_i
//            + sum_k r_ik exp(cum_ex_ik) S[k, :]
//     S'   = diag(exp(cum_L)) S + sum_j (k_j exp(cum_L - cum_j))^T v_j
//
// with o rounded once to r's type, as the TPU kernel computes
// (rwkv6_scan.py:21-55). Extended by what the model path needs: S starts
// from an optional float32 initial state (B, H, K, V) instead of zeros, and
// the final S is written out (models/rwkv.py:rwkv6_time_mix carries it).
//
// Layouts: r, k, logw (B, S, H, K), v and o (B, S, H, V), u (H, K), both
// states (B, H, K, V), all contiguous.
//
// Design: one block of 256 threads per (h, b), looping over chunks, with the
// state in shared memory throughout. The TPU kernel materialises the
// (L, L, K) decay tensor, 256 KB in float32 at L = 32, K = 64: more than a
// block has. Here A_ij is summed over k directly, each exponent
// cum_ex_ik - cum_jk = sum of logw over positions j+1..i-1, so <= 0 for
// j < i (no overflow). The (L, K) tiles are padded to K + 1 columns so that
// the 32 threads of a warp, reading 32 rows j of one column, hit 32 banks.
// r exp(cum_ex) and k exp(cum_L - cum) are formed once per chunk. About
// 79 KB of shared memory at L = 32, K = V = 64, above the 48 KB default, so
// the launcher raises the kernel's dynamic shared memory limit. CUDA cores
// only, no tensor cores yet.
//
// What bounds it: on the serving path (rwkv6-3b prefill: B 4, S 128, H 40,
// K = V = 64, bf16 r, k, v) it moves about 21 MB (r, k, v and o 2.6 MB each
// in bf16, logw 5.2 MB in float32, the states in and out 2.6 MB each):
// 6.3 us at 3.35 TB/s. Its operations (about 0.3 GFLOP and 2.6 M
// exponentials) are under 5 us at the card's float32 peak, so bytes bound
// it. It launches 32 times per prefill (once per layer).
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
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;  // may be null: start from zeros
  void* o;
  float* s_out;
  int seqlen, heads, kd, vd, chunk;
};

// Shared memory floats of one block; the wrapper's smem_bytes agrees.
size_t smem_floats(int kd, int vd, int l) {
  return 6 * (size_t)l * (kd + 1) + (size_t)l * vd + (size_t)kd * vd +
         (size_t)l * l + (size_t)l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int K = a.kd, V = a.vd, L = a.chunk, K1 = K + 1;
  float* rr = smem;               // (L, K+1) r
  float* kk = rr + L * K1;        // (L, K+1) k
  float* cum = kk + L * K1;       // (L, K+1) logw, then its inclusive cumsum
  float* cex = cum + L * K1;      // (L, K+1) exclusive cumsum
  float* rdec = cex + L * K1;     // (L, K+1) r exp(cum_ex)
  float* kdec = rdec + L * K1;    // (L, K+1) k exp(cum_L - cum)
  float* vv = kdec + L * K1;      // (L, V)
  float* st = vv + L * V;         // (K, V)   state S[k][v]
  float* att = st + K * V;        // (L, L)   A_ij, j < i
  float* bonus = att + L * L;     // (L)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* r = (const T*)a.r;
  const T* kp = (const T*)a.k;
  const T* vp = (const T*)a.v;
  T* o = (T*)a.o;
  const float* u = a.u + (int64_t)h * K;
  const int64_t sbase = ((int64_t)b * a.heads + h) * K * V;

  for (int idx = tid; idx < K * V; idx += kThreads)
    st[idx] = a.s0 ? a.s0[sbase + idx] : 0.0f;

  for (int t0 = 0; t0 < a.seqlen; t0 += L) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int idx = tid; idx < L * K; idx += kThreads) {
      const int i = idx / K, c = idx % K;
      const int64_t g = (((int64_t)b * a.seqlen + t0 + i) * a.heads + h) * K + c;
      rr[i * K1 + c] = to_f32(r[g]);
      kk[i * K1 + c] = to_f32(kp[g]);
      cum[i * K1 + c] = a.logw[g];
    }
    for (int idx = tid; idx < L * V; idx += kThreads) {
      const int i = idx / V, c = idx % V;
      vv[idx] = to_f32(vp[(((int64_t)b * a.seqlen + t0 + i) * a.heads + h) * V + c]);
    }
    __syncthreads();
    for (int c = tid; c < K; c += kThreads) {
      float run = 0.0f;
      for (int i = 0; i < L; ++i) {
        cex[i * K1 + c] = run;
        run += cum[i * K1 + c];
        cum[i * K1 + c] = run;
      }
    }
    __syncthreads();

    const float* cum_last = cum + (L - 1) * K1;
    for (int idx = tid; idx < L * L; idx += kThreads) {
      const int i = idx / L, j = idx % L;
      float acc = 0.0f;
      if (j < i) {
        const float* ri = rr + i * K1;
        const float* ei = cex + i * K1;
        const float* kj = kk + j * K1;
        const float* cj = cum + j * K1;
        for (int c = 0; c < K; ++c) acc += ri[c] * kj[c] * expf(ei[c] - cj[c]);
      }
      att[idx] = acc;
    }
    for (int i = tid; i < L; i += kThreads) {
      float acc = 0.0f;
      for (int c = 0; c < K; ++c) acc += rr[i * K1 + c] * (u[c] * kk[i * K1 + c]);
      bonus[i] = acc;
    }
    for (int idx = tid; idx < L * K; idx += kThreads) {
      const int i = idx / K, c = idx % K;
      rdec[i * K1 + c] = rr[i * K1 + c] * expf(cex[i * K1 + c]);
      kdec[i * K1 + c] = kk[i * K1 + c] * expf(cum_last[c] - cum[i * K1 + c]);
    }
    __syncthreads();

    for (int idx = tid; idx < L * V; idx += kThreads) {
      const int i = idx / V, c = idx % V;
      const float* ai = att + i * L;
      float acc = 0.0f;
      for (int j = 0; j < i; ++j) acc += ai[j] * vv[j * V + c];
      acc += bonus[i] * vv[i * V + c];
      const float* ri = rdec + i * K1;
      for (int q = 0; q < K; ++q) acc += ri[q] * st[q * V + c];
      store(o + (((int64_t)b * a.seqlen + t0 + i) * a.heads + h) * V + c, acc);
    }
    __syncthreads();  // every o has read the old state

    for (int idx = tid; idx < K * V; idx += kThreads) {
      const int q = idx / V, c = idx % V;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc += kdec[j * K1 + q] * vv[j * V + c];
      st[idx] = st[idx] * expf(cum_last[q]) + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < K * V; idx += kThreads)
    a.s_out[sbase + idx] = st[idx];
}

template <typename T>
int launch(const Args& a, int batch, int device, cudaStream_t stream) {
  const size_t smem = smem_floats(a.kd, a.vd, a.chunk) * sizeof(float);
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(rwkv6_scan_kernel<T>, (int)smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.heads, (unsigned)batch);
  rwkv6_scan_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o share it); logw, u and the
// states are float32. s0 may be null. Launches on `device`'s `stream`
// without synchronising; returns cudaGetLastError().
int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0, void* o,
                     void* s_out, int batch, int seqlen, int heads, int kd,
                     int vd, int chunk, int dtype, int device, void* stream) {
  if (batch <= 0 || batch > 65535 || seqlen <= 0 || heads <= 0 || kd <= 0 ||
      vd <= 0 || chunk <= 0 || seqlen % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.logw = (const float*)logw;
  a.u = (const float*)u;
  a.s0 = (const float*)s0;
  a.o = o;
  a.s_out = (float*)s_out;
  a.seqlen = seqlen, a.heads = heads, a.kd = kd, a.vd = vd, a.chunk = chunk;
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, batch, device, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, batch, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(rwkv6_scan, repro_rwkv6_scan)
