// FlashAttention-2 forward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/flash_attention.py:flash_attention_fwd (_flash_kernel). For
// each (batch b, query head h, query position i), with kh = h / G the KV
// head it reads:
//
//     s_ij = (q_i . k_j) / sqrt(D), masked to -1e30 where causal and j > i
//     out_i = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
//
// with the running max, sum and accumulator in float32 and p kept in float32
// until it is normalised after the PV sum, as the TPU kernel does
// (flash_attention.py:54-56, 65-67). The model's plain blocked_attention
// rounds p to v's type before the PV product (models/layers.py:156-158).
// The causal mask is aligned top-left (i >= j), as in the TPU kernel and
// blocked_attention; the wrapper takes causal inputs only at S = T, where
// every alignment agrees (see ROADMAP queue 3, item 2).
//
// Layouts: q (B, Hq, S, D), k and v (B, Hkv, T, D), out (B, Hq, S, D), each
// given by its element strides for B, H and S|T, with the D axis
// contiguous. Hq = G * Hkv. The TPU kernel's layout is G = 1 with
// (B, H, S, D) strides; the model's (B, S, H, D) activations pass through
// as transposed views with G = Hq / Hkv, so nothing is copied or repeated.
// Any S and T work: the tail tiles are masked, and the wrapper pads nothing.
//
// Design: one block of 8 warps per (query tile of 64 rows, h, b). The
// tile's queries sit in shared memory as float32; K and V are staged in
// tiles of 32 keys (the K tile padded by one column so that lane j reading
// key j hits 32 distinct banks). Warp w owns 8 query rows; lane j computes
// the scores of key j against them on CUDA cores (no tensor cores yet), the
// row max is a warp all-reduce, and each lane keeps a partial row sum. For
// the PV product lane i owns the columns d = i, i + 32, ... of its warp's
// 8 accumulator rows, and p_ij reaches it by a warp shuffle from lane j.
// Causal tiles strictly above the diagonal are skipped. Shared memory is
// (128 D + 32) * 4 bytes: 64.1 KB at D = 128, above the 48 KB default, so
// the launcher raises the kernel's dynamic shared memory limit.
//
// What bounds it: on the serving path (llama3.2-3b prefill, B = 4,
// S = T = 128, 24 query heads over 8 KV heads, D = 128, bf16) the causal
// work is about 0.41 GFLOP, 0.41 us at the bf16 tensor-core peak, and the
// bytes (q, k, v read once, out written once) are about 8.4 MB, 2.5 us at
// 3.35 TB/s: bytes bound it. It launches 28 times per prefill (once per
// layer). A wgmma/TMA version is later work.
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
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows
constexpr int kBlockK = 32;                     // keys per tile, one a lane
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
  int64_t b, h, s;
};

size_t smem_bytes(int d) {
  return (size_t)(kBlockQ * d + kBlockK * (d + 1) + kBlockK * d) *
         sizeof(float);
}

// NC = number of 32-column chunks a lane holds: D <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int group, int s_len, int t_len, int d, int causal,
                       float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kBlockQ][d]
  float* k_s = q_s + kBlockQ * d;             // [kBlockK][d + 1]
  float* v_s = k_s + kBlockK * (d + 1);       // [kBlockK][d]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * kRowsPerWarp;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kh * ks.h;
  const T* vp = v + b * vs.b + kh * vs.h;

  for (int e = threadIdx.x; e < kBlockQ * d; e += kThreads) {
    const int r = e / d, col = e - r * d;
    const int i = q0 + r;
    q_s[e] = i < s_len ? to_f32(qp[i * qs.s + col]) : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  // causal: keys past the tile's last query row contribute nothing
  const int kv_end = causal ? min(t_len, q0 + kBlockQ) : t_len;
  for (int t0 = 0; t0 < kv_end; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int e = threadIdx.x; e < kBlockK * d; e += kThreads) {
      const int j = e / d, col = e - j * d;
      const int t = t0 + j;
      const bool in = t < t_len;
      k_s[j * (d + 1) + col] = in ? to_f32(kp[t * ks.s + col]) : 0.0f;
      v_s[e] = in ? to_f32(vp[t * vs.s + col]) : 0.0f;
    }
    __syncthreads();

    // scores of key t = t0 + lane against the warp's 8 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    const float* krow = k_s + lane * (d + 1);
    const float* qrow = q_s + r0 * d;
    for (int col = 0; col < d; ++col) {
      const float kv = krow[col];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] += qrow[r * d + col] * kv;
    }
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + r0 + r;
      const bool valid = t < t_len && (!causal || t <= i);
      s[r] = valid ? s[r] * scale : kNeg;
    }

    // online softmax: s becomes p
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mx = s[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      s[r] = expf(s[r] - m_new);
      l[r] = l[r] * corr + s[r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }

    // acc += p v over the tile's keys
    const int n_keys = min(kBlockK, t_len - t0);
    for (int j = 0; j < n_keys; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < d ? v_s[j * d + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += p * vj[c];
      }
    }
  }

  T* op = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float tot = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tot += __shfl_xor_sync(kFull, tot, off);
    const int i = q0 + r0 + r;
    if (i >= s_len) continue;
    const float inv = 1.0f / fmaxf(tot, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(op + i * os.s + col, acc[r][c] * inv);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int batch, int hq,
           int group, int s_len, int t_len, int d, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kBlockQ - 1) / kBlockQ), (unsigned)hq,
                  (unsigned)batch);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os, group,
      s_len, t_len, d, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             Strides qs, Strides ks, Strides vs, Strides os, int batch,
             int hq, int group, int s_len, int t_len, int d, int causal,
             float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        s_len, t_len, d, causal, scale, stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        s_len, t_len, d, causal, scale, stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        s_len, t_len, d, causal, scale, stream);
  return launch<T, 8>(q, k, v, out, qs, ks, vs, os, batch, hq, group, s_len,
                      t_len, d, causal, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements, three per tensor (B, H, S|T). Launches on `device`'s
// `stream` without synchronising; returns cudaGetLastError().
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, const int64_t* strides, int batch,
                          int hq, int hkv, int s_len, int t_len, int d,
                          int causal, float scale, int dtype, int device,
                          void* stream) {
  if (batch <= 0 || batch > 65535 || hq <= 0 || hq > 65535 || hkv <= 0 ||
      hq % hkv != 0 || s_len <= 0 || t_len <= 0 || d <= 0 || d > 256)
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
                           s_len, t_len, d, causal, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, batch, hq,
                                   group, s_len, t_len, d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(flash_attention, repro_flash_attention)
