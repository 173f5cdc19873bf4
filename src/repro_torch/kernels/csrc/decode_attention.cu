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
// argument: no device scalar, no host sync. Keys at or past cur_len are
// skipped, which equals masking them once any key is valid; when
// cur_len <= 0 every key is visited and masked, which gives the TPU
// kernel's answer there (the mean of v).
//
// Two kernels; the wrapper (repro_torch/kernels/decode_attention.py:
// variant) names the one to run:
//
// decode_attention_kernel_split, the serving path: float32 or bf16, D a
// multiple of 8, K and V 16-byte aligned with strides that are multiples
// of a 16-byte vector. One thread-block cluster per (b, KV head) (and per
// 8 of its query heads, where G > 8), of n <= 8 blocks of 4 warps; rank r
// takes the r-th contiguous share of the keys below min(cur_len, T), so K
// and V are read from device memory once for all G query heads, by n SMs
// at once. Within a block, L = 8..32 lanes (a power of two) take one key:
// 16-byte vectors, a D-128 bf16 row in 16 lanes, so a warp takes two keys
// at a time and reduces each dot product in log2 L shuffle steps within
// its lanes. Each lane group requests four keys (two for 8 heads; before
// q, so the two loads overlap), computes their dot products with every
// query head, and then takes one online-softmax step (m, l, acc) per head
// over them, in base 2: the scores are scaled by log2 e and exp2f (one
// MUFU operation, within 2 float32 ulps) takes the place of expf. The
// states merge with the split-KV merge of models/layers.py:217-222, by
// shuffles within a warp and through shared memory within a block. Output
// column e belongs to rank e % n: each block writes each merged column of
// its state into its owner's shared memory, and its m and l into every
// rank's, through distributed shared memory (stores, which do not wait);
// after one cluster.sync() each rank merges its columns of the n states,
// normalises and writes them from its own shared memory. One launch
// (cudaLaunchKernelEx with a cluster dimension), no workspace, no second
// kernel. n = min(8, enough clusters for two blocks an SM, one block per
// 16 keys). A cluster computes HC = 1, 2, 4 or 8 query heads (G rounded up
// to a power of two), a template argument, so a G = 1 model keeps one
// head's state in registers and not eight.
//
// decode_attention_kernel_head, every other call (misaligned or off-grid
// K and V): one block of 8 warps per (b, h). Lane i holds the columns
// d = i, i + 32, ... of q and of its own accumulator. Warp w walks the
// keys t = w, w + 8, ...: a warp all-reduce gives s_t in every lane, then
// each warp carries its own (m, l, acc), and the 8 states merge in shared
// memory. G query heads read the same KV head; the repeats hit L2.
//
// What bounds it: bytes. It reads q once, the valid positions of K and V
// once and writes out once. On the serving path (llama3.2-3b, B = 4, 8 KV
// heads, D = 128, bf16, max_len T = 168), a step at cur_len c reads
// 16,384 c bytes of cache: 2.1 MB at the first step (c = 129), 0.63 us at
// 3.35 TB/s, and 2.75 MB at c = T; the split kernel runs 32 clusters of 8
// blocks there. It launches 28 times per decode step (once per layer).
//
// A C launcher, called from Python through the extension module that
// csrc/launch.cuh makes of the library: it returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"

#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

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

// ---- the split kernel: a cluster per KV head ------------------------------

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kMaxHeads = 8;   // query heads a cluster computes, at most
constexpr int kMaxSplit = 8;   // blocks a cluster: the portable limit
// Keys a lane group loads before it computes: four, so that a share of up
// to 4 x 128 / L keys (32 at D = 128 in bf16) takes one round trip to
// memory; two for 8 heads, whose state fills the registers.
__host__ __device__ constexpr int unroll(int heads) {
  return heads >= 8 ? 2 : 4;
}
constexpr float kLog2e = 1.4426950408889634f;

// The score of a key past the block's share: -inf, so it adds nothing.
__device__ __forceinline__ float no_key() { return __int_as_float(0xff800000); }

// A 16-byte vector of T as floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The split-KV merge of a state of max m with one of max mo, in base 2:
// the new max into m, and the scales cs and co of the two states' l and
// acc. A state with no key (m = -1e30, l = 0) adds nothing; where every
// key was masked (both m = -1e30) both scales are 1, so the sums run on.
__device__ __forceinline__ void merge_scales(float& m, float mo, float& cs,
                                             float& co) {
  const float mn = fmaxf(m, mo);
  cs = exp2f(m - mn);
  co = exp2f(mo - mn);
  m = mn;
}

// Shared floats of one block: q [hc][d], the warps' states
// [kSplitWarps][hc][d + 2], and the cluster's states [n][hc][d + 2], of
// which a rank receives its own output columns and every m and l.
__host__ __device__ inline int split_smem_floats(int hc, int d, int n) {
  return hc * d + (kSplitWarps + n) * hc * (d + 2);
}

// L lanes (a power of two, 8..32) take one key, each lane NVL 16-byte
// vectors of it, so D <= 16 / sizeof(T) * L * NVL; a cluster computes HC
// (1, 2, 4 or 8) of the KV head's query heads.
template <typename T, int L, int NVL, int HC>
__global__ void __launch_bounds__(kSplitThreads)
decode_attention_kernel_split(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              Strides qs, Strides ks, Strides vs, Strides os,
                              int group, int t_len, int d, int64_t cur_len,
                              float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);   // elements a vector
  constexpr int NGRP = kSplitThreads / L;    // lane groups a block
  constexpr int W = NVL * VEC;               // columns a lane holds
  constexpr int U = unroll(HC);              // keys a lane group loads
  constexpr int STEP = NGRP * U;             // keys a block loads at once
  // every block of the cluster has started before any writes to another
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = gridDim.x, rank = blockIdx.x;
  const int n_hg = (group + HC - 1) / HC;
  const int kh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int h0 = kh * group + hg * HC;   // first query head
  const int hc = min(HC, group - hg * HC);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / L, gl = tid % L;
  const int dp = d + 2;   // a state row: acc[0..d), m, l

  extern __shared__ float smem[];
  float* q_s = smem;
  float* wst = q_s + hc * d;
  float* cst = wst + kSplitWarps * hc * dp;

  // this rank's share of the keys
  const int n_keys =
      cur_len <= 0 ? t_len : (int)(cur_len < t_len ? cur_len : t_len);
  const bool all_masked = cur_len <= 0;
  const int share = (n_keys + n_split - 1) / n_split;
  const int start = min(n_keys, rank * share);
  const int end = min(n_keys, start + share);
  const T* kp = k + b * ks.b + kh * ks.h;
  const T* vp = v + b * vs.b + kh * vs.h;

  // the first keys are requested before q, so the two loads overlap
  uint4 kv[U][NVL], vv[U][NVL];
  auto load_keys = [&](int t0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NGRP + grp;
#pragma unroll
      for (int c = 0; c < NVL; ++c) {
        const int col = (gl + c * L) * VEC;
        const bool ok = t < end && col < d;
        kv[u][c] = ok ? __ldg(reinterpret_cast<const uint4*>(
                            kp + t * ks.t + col))
                      : make_uint4(0, 0, 0, 0);
        vv[u][c] = ok ? __ldg(reinterpret_cast<const uint4*>(
                            vp + t * vs.t + col))
                      : make_uint4(0, 0, 0, 0);
      }
    }
  };
  load_keys(start);
#pragma unroll 4
  for (int e = tid; e < hc * d; e += kSplitThreads) {
    const int g = e / d, c = e - g * d;
    q_s[e] = to_f32(q[b * qs.b + (h0 + g) * qs.h + c]);
  }

  // running max (base 2), sum and accumulator of each query head
  float m[HC], l[HC], acc[HC][W];
#pragma unroll
  for (int g = 0; g < HC; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) acc[g][w] = 0.0f;
  }
  const float scale2 = scale * kLog2e;   // exp(x) = exp2(x log2 e)
  __syncthreads();   // q_s is written

  // the loop's bounds are the block's, so every lane reaches every shuffle.
  // A batch of U keys a lane group: every dot product first, then one
  // online-softmax step per query head over the batch; a key past the share
  // scores -inf and adds nothing
  for (int t0 = start; t0 < end; t0 += STEP) {
    float s[U][HC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[W];
#pragma unroll
      for (int c = 0; c < NVL; ++c) {
        float tmp[VEC];
        unpack(kv[u][c], tmp, k);
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[c * VEC + e] = tmp[e];
      }
      const bool valid = t0 + u * NGRP + grp < end;
#pragma unroll
      for (int g = 0; g < HC; ++g) {
        if (g >= hc) break;
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < NVL; ++c) {
          const int col = (gl + c * L) * VEC;
          if (col < d) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part += q_s[g * d + col + e] * kf[c * VEC + e];
          }
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(kFull, part, off);
        s[u][g] = !valid ? no_key() : all_masked ? kNeg : part * scale2;
      }
    }
#pragma unroll
    for (int g = 0; g < HC; ++g) {
      if (g >= hc) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float corr = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[g][w] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[u][g] - mx);
        l[g] += p;
#pragma unroll
        for (int c = 0; c < NVL; ++c) {
          float vf[VEC];
          unpack(vv[u][c], vf, k);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][c * VEC + e] += p * vf[e];
        }
      }
    }
    if (t0 + STEP < end) load_keys(t0 + STEP);
  }

  // the lane groups of a warp, by shuffles across groups
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < HC; ++g) {
      if (g >= hc) break;
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      float cs, co;
      merge_scales(m[g], mo, cs, co);
      l[g] = l[g] * cs + lo * co;
#pragma unroll
      for (int w = 0; w < W; ++w)
        acc[g][w] =
            acc[g][w] * cs + __shfl_xor_sync(kFull, acc[g][w], off) * co;
    }
  }
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < HC; ++g) {
      if (g >= hc) break;
      float* row = wst + (warp * hc + g) * dp;
#pragma unroll
      for (int c = 0; c < NVL; ++c) {
        const int col = (gl + c * L) * VEC;
        if (col < d) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) row[col + e] = acc[g][c * VEC + e];
        }
      }
      if (gl == 0) {
        row[d] = m[g];
        row[d + 1] = l[g];
      }
    }
  }
  __syncthreads();   // every warp's state is written

  // the warps of the block. Output column e of the cluster belongs to rank
  // e % n: this block's merged acc column goes to its owner's shared memory,
  // and its m and l to every rank's, through distributed shared memory
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < hc * dp; e += kSplitThreads) {
    const int g = e / dp, c = e - g * dp;
    float mb = kNeg;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mb = fmaxf(mb, wst[(w * hc + g) * dp + d]);
    float x = mb;
    if (c != d) {   // a column of acc, or l (c = d + 1): a scaled sum
      x = 0.0f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float* row = wst + (w * hc + g) * dp;
        x += row[c] * exp2f(row[d] - mb);
      }
    }
    const int at = (rank * hc + g) * dp + c;
    if (c < d) {
      *cluster.map_shared_rank(cst + at, (g * d + c) % n_split) = x;
    } else {
      for (int r = 0; r < n_split; ++r) *cluster.map_shared_rank(cst + at, r) = x;
    }
  }
  cluster.sync();   // every block's state has reached its owners

  // this rank's output columns: the n blocks' states merged, normalised and
  // rounded once, from its own shared memory
  for (int e = rank + n_split * tid; e < hc * d;
       e += n_split * kSplitThreads) {
    const int g = e / d, c = e - g * d;
    float mc = kNeg;
    for (int r = 0; r < n_split; ++r)
      mc = fmaxf(mc, cst[(r * hc + g) * dp + d]);
    float a = 0.0f, lc = 0.0f;
    for (int r = 0; r < n_split; ++r) {
      const float* row = cst + (r * hc + g) * dp;
      const float sc = exp2f(row[d] - mc);
      a += row[c] * sc;
      lc += row[d + 1] * sc;
    }
    store(out + b * os.b + (h0 + g) * os.h + c, a / fmaxf(lc, 1e-30f));
  }
}

int sm_count(int device) {
  static std::atomic<int> counts[64];
  if (device < 0 || device >= 64) return 132;
  int n = counts[device].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    counts[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, int L, int NVL, int HC>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 Strides qs, Strides ks, Strides vs, Strides os, int batch,
                 int hkv, int group, int t_len, int d, int64_t cur_len,
                 float scale, int device, cudaStream_t stream) {
  const int n_hg = (group + HC - 1) / HC;
  if ((int64_t)hkv * n_hg > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_keys =
      cur_len <= 0 ? t_len : (int)(cur_len < t_len ? cur_len : t_len);
  const int64_t clusters = (int64_t)batch * hkv * n_hg;
  const int64_t fill = (2 * (int64_t)sm_count(device) + clusters - 1) /
                       clusters;   // clusters of n blocks for two an SM
  const int n = (int)std::max<int64_t>(
      1, std::min<int64_t>({kMaxSplit, fill, (n_keys + 15) / 16}));
  const int smem =
      split_smem_floats(std::min(HC, group), d, n) * (int)sizeof(float);
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(decode_attention_kernel_split<T, L, NVL, HC>,
                                 smem, device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n, (unsigned)(hkv * n_hg), (unsigned)batch);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel_split<T, L, NVL, HC>, (const T*)q,
      (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os, group, t_len, d,
      cur_len, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// HC: the query heads of a KV head rounded up to a power of two, at most 8.
template <typename T, int L, int NVL>
int dispatch_heads(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int batch,
                   int hkv, int group, int t_len, int d, int64_t cur_len,
                   float scale, int device, cudaStream_t stream) {
#define REPRO_SPLIT_HEADS(HC)                                                \
  return launch_split<T, L, NVL, HC>(q, k, v, out, qs, ks, vs, os, batch,   \
                                     hkv, group, t_len, d, cur_len, scale,  \
                                     device, stream)
  if (group <= 1) REPRO_SPLIT_HEADS(1);
  if (group <= 2) REPRO_SPLIT_HEADS(2);
  if (group <= 4) REPRO_SPLIT_HEADS(4);
  REPRO_SPLIT_HEADS(kMaxHeads);
#undef REPRO_SPLIT_HEADS
}

// L: the lanes that cover a row of D / VEC 16-byte vectors, at least 8.
template <typename T>
int dispatch_split(const void* q, const void* k, const void* v, void* out,
                   Strides qs, Strides ks, Strides vs, Strides os, int batch,
                   int hkv, int group, int t_len, int d, int64_t cur_len,
                   float scale, int device, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int nv = d / VEC;   // vectors a row
  if (nv <= 8)
    return dispatch_heads<T, 8, 1>(q, k, v, out, qs, ks, vs, os, batch, hkv,
                                   group, t_len, d, cur_len, scale, device,
                                   stream);
  if (nv <= 16)
    return dispatch_heads<T, 16, 1>(q, k, v, out, qs, ks, vs, os, batch, hkv,
                                    group, t_len, d, cur_len, scale, device,
                                    stream);
  if (nv <= 32)
    return dispatch_heads<T, 32, 1>(q, k, v, out, qs, ks, vs, os, batch, hkv,
                                    group, t_len, d, cur_len, scale, device,
                                    stream);
  if constexpr (VEC == 4)   // float32 rows of 33-64 vectors (D <= 256)
    return dispatch_heads<T, 32, 2>(q, k, v, out, qs, ks, vs, os, batch, hkv,
                                    group, t_len, d, cur_len, scale, device,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

// ---- the general kernel: a block per query head ---------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// NC = number of 32-column chunks a lane holds: D <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_head(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_head(const void* q, const void* k, const void* v, void* out,
                Strides qs, Strides ks, Strides vs, Strides os, int batch,
                int hq, int group, int t_len, int d, int64_t cur_len,
                float scale, cudaStream_t stream) {
  decode_attention_kernel_head<T, NC><<<(unsigned)(batch * hq), kThreads, 0,
                                        stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os, hq,
      group, t_len, d, cur_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head(const void* q, const void* k, const void* v, void* out,
                  Strides qs, Strides ks, Strides vs, Strides os, int batch,
                  int hq, int group, int t_len, int d, int64_t cur_len,
                  float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch_head<T, 1>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                             t_len, d, cur_len, scale, stream);
  if (d <= 64)
    return launch_head<T, 2>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                             t_len, d, cur_len, scale, stream);
  if (d <= 128)
    return launch_head<T, 4>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                             t_len, d, cur_len, scale, stream);
  return launch_head<T, 8>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                           t_len, d, cur_len, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements, three per tensor (B, H, T; T is unused for q and out).
// split: 1 runs decode_attention_kernel_split, which takes D a multiple of
// 8, and K and V 16-byte aligned with B, H and T strides that are multiples
// of a 16-byte vector (anything else is refused, not rerouted); 0 runs
// decode_attention_kernel_head. Launches on `device`'s `stream` without
// synchronising; returns cudaGetLastError().
int repro_decode_attention(const void* q, const void* k, const void* v,
                           void* out, const int64_t* strides, int batch,
                           int hq, int hkv, int t_len, int d,
                           int64_t cur_len, float scale, int dtype, int split,
                           int device, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || t_len <= 0 ||
      d <= 0 || d > 256 || (int64_t)batch * hq > 0x7fffffff ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  const int group = hq / hkv;
  if (split) {
    const int vec = dtype == 0 ? 4 : 8;   // elements of a 16-byte vector
    bool ok = d % 8 == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
    for (int i = 3; i < 9; ++i) ok = ok && strides[i] % vec == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return dispatch_split<float>(q, k, v, out, qs, ks, vs, os, batch, hkv,
                                   group, t_len, d, cur_len, scale, device,
                                   s);
    return dispatch_split<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, batch,
                                         hkv, group, t_len, d, cur_len, scale,
                                         device, s);
  }
  if (dtype == 0)
    return dispatch_head<float>(q, k, v, out, qs, ks, vs, os, batch, hq,
                                group, t_len, d, cur_len, scale, s);
  return dispatch_head<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, batch,
                                      hq, group, t_len, d, cur_len, scale, s);
}

}  // extern "C"

REPRO_PY_MODULE(decode_attention, repro_decode_attention)
