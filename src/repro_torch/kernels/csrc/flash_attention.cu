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
// blocked_attention, at any S and T: for S > T the rows i >= T see every
// key, and each tile's last key (kv_end) is min(T, its last row + 1).
//
// Layouts: q (B, Hq, S, D), k and v (B, Hkv, T, D), out (B, Hq, S, D), each
// given by its element strides for B, H and S|T, with the D axis
// contiguous. Hq = G * Hkv. The TPU kernel's layout is G = 1 with
// (B, H, S, D) strides; the model's (B, S, H, D) activations pass through
// as transposed views with G = Hq / Hkv, so nothing is copied or repeated.
// Any S and T work: the tail tiles are masked, and the wrapper pads nothing.
//
// Two kernels; the wrapper (repro_torch/kernels/flash_attention.py:variant)
// names the one to run, by dtype, D and alignment:
//
// flash_attention_kernel_mma, the serving path: bf16, D a multiple of 16 up
// to 128, every B, H and S|T stride a multiple of 8 elements and the four
// pointers 16-byte aligned. One block of 4 warps per (query tile of 64
// rows, h, b), the heaviest causal tiles first; warp w owns rows 16w..16w+15
// of the tile. The Q tile and tiles of 64 keys of K and V arrive by 16-byte
// cp.async.cg copies (zero-filled past S and T) in a ring of two stages, so
// the next K/V tile is in flight while this one is multiplied. Rows are
// padded from D to D + 8 elements in shared memory: an odd number of
// 16-byte chunks a row, so ldmatrix's eight rows hit eight bank groups at
// every D of the grid, D = 80 (ten chunks) among them. Q is loaded once
// into A fragments that stay in registers. S = Q K^T is mma.sync.m16n8k16
// with float32 sums; the products of two bf16 values are exact in float32,
// so this is the TPU kernel's float32 dot up to the order of the sums. The
// online softmax runs on the accumulator registers, a row's max and sum
// reduced over the quad of lanes that holds it, in base 2: the scores are
// scaled by log2 e and exp2f (one MUFU operation, within 2 float32 ulps)
// takes the place of expf. Only tiles that cross the diagonal or the end of
// T are masked, and tiles above the diagonal are skipped. The C
// fragments of S are the A fragments of P V (the m16n8 C layout of two
// adjacent key tiles is the m16k16 A layout), and p is split
// into p_hi = bf16(p) and p_lo = bf16(p - p_hi): two products, P_hi V and
// P_lo V, carry p to about 16 bits, well past the one rounding of the
// output, where a single bf16 p would be the model layer's function and
// not the kernel's. V feeds the B fragments through ldmatrix.trans. The
// sums are normalised by max(l, 1e-30), rounded once to bf16, staged
// through the warp's rows of the Q tile and stored 16 bytes a lane.
//
// flash_attention_kernel_fma, every other call (float32, D off the grid or
// above 128, misaligned views): one block of 8 warps per (query tile of 64
// rows, h, b). The tile's queries sit in shared memory as float32; K and V
// are staged in tiles of 32 keys (the K tile padded by one column so that
// lane j reading key j hits 32 distinct banks). Warp w owns 8 query rows;
// lane j computes the scores of key j against them on CUDA cores, the row
// max is a warp all-reduce, and each lane keeps a partial row sum. For the
// PV product lane i owns the columns d = i, i + 32, ... of its warp's 8
// accumulator rows, and p_ij reaches it by a warp shuffle from lane j.
//
// What bounds it: on the serving path (llama3.2-3b prefill, B = 4,
// S = T = 128, 24 query heads over 8 KV heads, D = 128, bf16) the causal
// work is about 0.41 GFLOP (0.62 with the p_lo products), 0.6 us at the
// bf16 tensor-core peak, and the bytes (q, k, v read once, out written
// once) are about 8.4 MB, 2.5 us at 3.35 TB/s: bytes bound it. The grid is
// 2 x 24 x 4 = 192 blocks of 87 KB of shared memory, two a SM. It launches
// 28 times per prefill (once per layer). A kernel's dynamic shared memory
// limit is raised once per device and size (repro::SmemLimit), not on every
// launch.
//
// A C launcher, called from Python through the extension module that
// csrc/launch.cuh makes of the library: it returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"
#include "mma.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---- the general kernel: CUDA cores ---------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 64 query rows
constexpr int kBlockK = 32;                     // keys per tile, one a lane

size_t smem_bytes(int d) {
  return (size_t)(kBlockQ * d + kBlockK * (d + 1) + kBlockK * d) *
         sizeof(float);
}

// NC = number of 32-column chunks a lane holds: D <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_fma(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_fma(const void* q, const void* k, const void* v, void* out,
               Strides qs, Strides ks, Strides vs, Strides os, int batch,
               int hq, int group, int s_len, int t_len, int d, int causal,
               float scale, int device, cudaStream_t stream) {
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(flash_attention_kernel_fma<T, NC>,
                                 (int)smem_bytes(d), device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kBlockQ - 1) / kBlockQ), (unsigned)hq,
                  (unsigned)batch);
  flash_attention_kernel_fma<T, NC><<<grid, kThreads, smem_bytes(d),
                                      stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qs, ks, vs, os, group,
      s_len, t_len, d, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fma(const void* q, const void* k, const void* v, void* out,
                 Strides qs, Strides ks, Strides vs, Strides os, int batch,
                 int hq, int group, int s_len, int t_len, int d, int causal,
                 float scale, int device, cudaStream_t stream) {
  if (d <= 32)
    return launch_fma<T, 1>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                            s_len, t_len, d, causal, scale, device, stream);
  if (d <= 64)
    return launch_fma<T, 2>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                            s_len, t_len, d, causal, scale, device, stream);
  if (d <= 128)
    return launch_fma<T, 4>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                            s_len, t_len, d, causal, scale, device, stream);
  return launch_fma<T, 8>(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                          s_len, t_len, d, causal, scale, device, stream);
}

// ---- the tensor-core kernel: bf16 mma.sync fed by cp.async -----------------

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTileQ = 16 * kMmaWarps;   // 64 query rows, 16 a warp
constexpr int kTileK = 64;               // keys a K/V tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the Q tile, then two stages of a K tile and a V tile, each
// row padded to D + 8 bf16 elements.
template <int D>
constexpr int mma_smem_bytes() {
  return (kTileQ + 2 * 2 * kTileK) * (D + 8) * (int)sizeof(bf16);
}

// Two floats as a bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), pairwise: p_hi + p_lo holds p
// to about 16 bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_kernel_mma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int group, int s_len, int t_len, int causal,
                           float scale) {
  constexpr int LD = D + 8;     // padded row, elements
  constexpr int CH = D / 8;     // 16-byte chunks a row
  constexpr int KD = D / 16;    // k-steps of Q K^T
  constexpr int ND = D / 8;     // n-tiles of P V
  extern __shared__ __align__(16) bf16 tiles[];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + kh * ks.h;
  const bf16* vp = v + b * vs.b + kh * vs.h;

  const uint32_t q_tile = (uint32_t)__cvta_generic_to_shared(tiles);
  auto k_tile = [&](int slot) {
    return q_tile + (kTileQ + slot * 2 * kTileK) * LD * (int)sizeof(bf16);
  };
  auto v_tile = [&](int slot) {
    return k_tile(slot) + kTileK * LD * (int)sizeof(bf16);
  };
  // rows r0 .. r0 + 63 of a (len, D) operand with row stride `st`, zero
  // past len
  static_assert(kTileQ == kTileK, "one tile height");
  auto load_rows = [&](uint32_t dst, const bf16* src, int64_t st, int r0,
                       int len) {
#pragma unroll
    for (int i = 0; i < kTileK * CH / kMmaThreads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int r = idx / CH, ch = idx % CH;
      const bool ok = r0 + r < len;
      cp_async16(dst + (r * LD + ch * 8) * (int)sizeof(bf16),
                 ok ? src + (r0 + r) * st + ch * 8 : src, ok);
    }
  };
  auto load_kv = [&](int slot, int t0) {
    load_rows(k_tile(slot), kp, ks.s, t0, t_len);
    load_rows(v_tile(slot), vp, vs.s, t0, t_len);
  };

  // causal: keys past the tile's last query row contribute nothing
  const int kv_end = causal ? min(t_len, q0 + kTileQ) : t_len;
  const float scale2 = scale * kLog2e;
  const int n_tiles = (kv_end + kTileK - 1) / kTileK;
  load_rows(q_tile, qp, qs.s, q0, s_len);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();

  // ldmatrix: lanes 8j..8j+7 give the rows of the j-th 8 x 8 matrix; the
  // mma fragments: g = lane / 4 is the row (A, C) or column (B), t4 = lane
  // % 4 the pair of columns (A, C) or rows (B)
  const int mj = lane >> 3, mr = lane & 7;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;              // the warp's rows in the tile
  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  // rows g and g + 8: running max (base 2) and sum
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  cp_async_wait<1>();   // Q has landed; the first K/V tile may be in flight
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], q_tile + ((row0 + (mj & 1) * 8 + mr) * LD + kk * 16 +
                                  (mj >> 1) * 8) *
                                     (int)sizeof(bf16));

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, (j + 1) * kTileK);
    cp_async_commit();
    cp_async_wait<1>();   // tile j has landed
    __syncthreads();
    const uint32_t kt = k_tile(j & 1), vt = v_tile(j & 1);
    const int t0 = j * kTileK;

    // s = q k^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), then keys 8-15
        uint32_t r[4];
        ldmatrix_x4(r, kt + ((p * 16 + (mj >> 1) * 8 + mr) * LD + kk * 16 +
                             (mj & 1) * 8) *
                                (int)sizeof(bf16));
        mma_bf16(s[2 * p], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * p + 1], qf[kk], r[2], r[3]);
      }

    // scale into base 2 (exp(x) = exp2(x log2 e)); mask only a tile that
    // crosses the end of T or the diagonal
    const int i0 = q0 + row0 + g;          // this lane's first row
    const bool edge =
        t0 + kTileK > t_len || (causal && t0 + kTileK - 1 > q0 + row0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + n * 8 + 2 * t4 + (e & 1);
        const int i = i0 + (e >> 1) * 8;
        const bool masked = key >= t_len || (causal && key > i);
        s[n][e] = edge && masked ? kNeg : s[n][e] * scale2;
      }

    // online softmax over the rows g and g + 8, each held by a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p v, p = p_hi + p_lo: the C fragments of key tiles 2kk and
    // 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        // matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7), then d 8-15,
        // each transposed
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + ((kk * 16 + (mj & 1) * 8 + mr) * LD +
                                   dp * 16 + (mj >> 1) * 8) *
                                      (int)sizeof(bf16));
        mma_bf16(o[2 * dp], ph, r[0], r[1]);
        mma_bf16(o[2 * dp], pl, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  // normalise, round once, stage the warp's 16 rows in its own rows of the
  // Q tile (Q is in registers), and store 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  bf16* tile = tiles + row0 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(tile + g * LD + col) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(tile + (g + 8) * LD + col) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* op = out + b * os.b + h * os.h;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, ch = idx % CH;
    const int i = q0 + row0 + r;
    if (i < s_len)
      *reinterpret_cast<uint4*>(op + i * os.s + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + r * LD + ch * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               Strides qs, Strides ks, Strides vs, Strides os, int batch,
               int hq, int group, int s_len, int t_len, int causal,
               float scale, int device, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(flash_attention_kernel_mma<D>, smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kTileQ - 1) / kTileQ), (unsigned)hq,
                  (unsigned)batch);
  flash_attention_kernel_mma<D><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, qs, ks, vs,
      os, group, s_len, t_len, causal, scale);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* out,
                 Strides qs, Strides ks, Strides vs, Strides os, int batch,
                 int hq, int group, int s_len, int t_len, int d, int causal,
                 float scale, int device, cudaStream_t stream) {
#define REPRO_FLASH_MMA(D)                                                 \
  case D:                                                                  \
    return launch_mma<D>(q, k, v, out, qs, ks, vs, os, batch, hq, group,  \
                         s_len, t_len, causal, scale, device, stream);
  switch (d) {
    REPRO_FLASH_MMA(16)
    REPRO_FLASH_MMA(32)
    REPRO_FLASH_MMA(48)
    REPRO_FLASH_MMA(64)
    REPRO_FLASH_MMA(80)
    REPRO_FLASH_MMA(96)
    REPRO_FLASH_MMA(112)
    REPRO_FLASH_MMA(128)
  }
#undef REPRO_FLASH_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Strides are
// in elements, three per tensor (B, H, S|T). tensor_cores: 1 runs
// flash_attention_kernel_mma, which takes bf16 only, D a multiple of 16 up
// to 128, strides that are multiples of 8 and 16-byte aligned pointers
// (anything else is refused, not rerouted); 0 runs
// flash_attention_kernel_fma. Launches on `device`'s `stream` without
// synchronising; returns cudaGetLastError().
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, const int64_t* strides, int batch,
                          int hq, int hkv, int s_len, int t_len, int d,
                          int causal, float scale, int dtype,
                          int tensor_cores, int device, void* stream) {
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
  if (tensor_cores) {
    bool ok = dtype == 1 && d % 16 == 0 && d <= 128 &&
              ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
               (uintptr_t)out) % 16 == 0;
    for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 8 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    return dispatch_mma(q, k, v, out, qs, ks, vs, os, batch, hq, group,
                        s_len, t_len, d, causal, scale, device, s);
  }
  if (dtype == 0)
    return dispatch_fma<float>(q, k, v, out, qs, ks, vs, os, batch, hq,
                               group, s_len, t_len, d, causal, scale, device,
                               s);
  if (dtype == 1)
    return dispatch_fma<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, batch,
                                       hq, group, s_len, t_len, d, causal,
                                       scale, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(flash_attention, repro_flash_attention)
