// One-query (decode) attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/decode_attention.py:decode_attention_fwd (_decode_kernel).
// For each (batch b, query head h), with kh = h / G the KV head it reads:
//
//     s_t = (q . k_t) / sqrt(D), masked to -1e30 where t >= cur_len
//     out = sum_t exp(s_t - m) v_t / max(sum_t exp(s_t - m), 1e-30)
//
// with an online softmax in float32 and p kept in float32 until it is
// normalised after the PV sum, as the TPU kernel does (decode_attention.py:
// 45-47). The model's plain decode_attention normalises first and rounds p
// to the cache's type before the PV product (models/layers.py:186-188).
//
// Layouts: q (B, Hq, D), k and v (B, Hkv, T, D), each given by its element
// strides for B, H and T, with the D axis contiguous. Hq = G * Hkv. The
// TPU kernel's layout is G = 1 with (B, H, T, D) strides; the model's cache
// (B, T, Hkv, D) passes through as a transposed view with G = Hq / Hkv, so
// no copy and no repeat of the cache is made. cur_len is a plain int
// argument: no device scalar, no host sync.
//
// Design: one block of 8 warps per (b, h). Lane i holds the columns
// d = i, i + 32, ... of q and of its own accumulator. Warp w walks the keys
// t = w, w + 8, ... below min(cur_len, T): a warp all-reduce gives s_t in
// every lane, then each warp carries its own (m, l, acc). The 8 partial
// states merge in shared memory with the split-KV merge of models/layers.py:
// 217-222. Keys at or past cur_len are skipped, which equals masking them
// once any key is valid; when cur_len <= 0 every key is visited and masked,
// which gives the TPU kernel's answer there (the mean of v).
//
// What bounds it: bytes. It reads q once, the cur_len valid positions of
// K and V once (G query heads read the same KV head; the repeats hit L2),
// and writes out once. On the serving path (llama3.2-3b, B = 4, 8 KV heads,
// D = 128, bf16, max_len T = 168), a step at cur_len c reads 16,384 c bytes
// of cache: 2.1 MB at the first step (c = 129), 0.63 us at 3.35 TB/s, and
// 2.75 MB at c = T. It launches 28 times per decode step (once per layer).
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

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  int64_t b, h, t;
};

// NC = number of 32-column chunks a lane holds: D <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        int hq, int group, int t_len, int d,
                        int64_t cur_len, float scale) {
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int kh = h / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kh * ks.h;
  const T* vp = v + b * vs.b + kh * vs.h;

  float qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = lane + 32 * c;
    qr[c] = col < d ? to_f32(qp[col]) : 0.0f;
    acc[c] = 0.0f;
  }
  float m = kNeg, l = 0.0f;

  const int n_keys = cur_len <= 0 ? t_len
                                  : (int)(cur_len < t_len ? cur_len : t_len);
  for (int t = warp; t < n_keys; t += kWarps) {
    const T* kt = kp + t * ks.t;
    const T* vt = vp + t * vs.t;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) part += qr[c] * to_f32(kt[col]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    const float s = t < cur_len ? part * scale : kNeg;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      const float vv = col < d ? to_f32(vt[col]) : 0.0f;
      acc[c] = acc[c] * corr + p * vv;
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][32 * NC];
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) sacc[warp][lane + 32 * c] = acc[c];
  __syncthreads();

  float m_all = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm[w]);
  float l_all = 0.0f;
  float corr[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    corr[w] = expf(sm[w] - m_all);
    l_all += sl[w] * corr[w];
  }
  const float inv = 1.0f / fmaxf(l_all, 1e-30f);
  T* op = out + b * os.b + h * os.h;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sacc[w][col] * corr[w];
    store(op + col, o * inv);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int batch, int hq,
           int group, int t_len, int d, int64_t cur_len, float scale,
           cudaStream_t stream) {
  decode_attention_kernel<T, NC><<<(unsigned)(batch * hq), kThreads, 0,
                                   stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os, hq,
      group, t_len, d, cur_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             Strides qs, Strides ks, Strides vs, Strides os, int batch,
             int hq, int group, int t_len, int d, int64_t cur_len,
             float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        t_len, d, cur_len, scale, stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        t_len, d, cur_len, scale, stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        t_len, d, cur_len, scale, stream);
  return launch<T, 8>(q, k, v, out, qs, ks, vs, os, batch, hq, group, t_len,
                      d, cur_len, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements, three per tensor (B, H, T; T is unused for q and out).
// Launches on `device`'s `stream` without synchronising; returns
// cudaGetLastError().
int repro_decode_attention(const void* q, const void* k, const void* v,
                           void* out, const int64_t* strides, int batch,
                           int hq, int hkv, int t_len, int d,
                           int64_t cur_len, float scale, int dtype,
                           int device, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || t_len <= 0 ||
      d <= 0 || d > 256 || (int64_t)batch * hq > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  const int group = hq / hkv;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                           t_len, d, cur_len, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, batch, hq,
                                   group, t_len, d, cur_len, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(decode_attention, repro_decode_attention)
