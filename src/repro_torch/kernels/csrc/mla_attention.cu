// MLA's causal prefill attention (DeepSeek-V2, arXiv:2405.04434), for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's MLA prefill
// (repro/models/attention.py:mla_attention) runs the plain blocked attention
// (repro/models/layers.py:blocked_attention) on keys of qk_nope + qk_rope
// columns and values of v_dim, which its flash kernel cannot take (one D for
// k and v). The port's plain twin (models/layers.py:blocked_attention on
// `cat`-built keys) spends its time in float32 passes over the score blocks;
// this kernel keeps the scores on chip. For each (batch b, head h, query
// position i):
//
//     s_ij = scale * (qn_i . kn_j + qr_i . kr_j), masked where j > i
//     out_i = sum_j bf16(exp(s_ij - m_i)) v_j / max(sum_j exp(s_ij - m_i),
//                                                   1e-30)
//
// with `scale` the caller's (YaRN's temperature over sqrt(qk_nope +
// qk_rope)), the running max, sum and accumulator in float32, and p rounded
// once to bf16 for a single P V product, as the reference's blocked
// attention rounds it (repro/models/layers.py:156-158, `p.astype(v.dtype)`)
// and the port's plain path does. The D-128 flash kernel
// (flash_attention.cu) carries p in two bf16 parts, the TPU flash kernel's
// function; the two kernels share only mma.cuh and launch.cuh. The causal
// mask is aligned top-left (query i sees keys j <= i, rows i >= T every
// key).
//
// Layouts, each given by element strides with the last axis contiguous:
// q (B, S, H, DN + DR), its nope and rope parts in one row; kn (B, T, H,
// DN); the rope key kr (B, T, DR), one for all heads, read once a tile and
// never expanded over heads; v (B, T, H, DV); out (B, S, H, DV).
//
// mla_attention_kernel_mma: one block of 4 warps per (query tile of 128
// rows, h, b), the heaviest causal tiles first; warp w owns rows
// 32w..32w+31 as two m-tiles of 16, so each K and V fragment it loads feeds
// two products. The Q tile stays in shared memory (its A fragments for 32
// rows and DN + DR columns would take 96 registers a thread), read a k-step
// at a time. Tiles of 64 keys arrive by 16-byte cp.async.cg copies
// (zero-filled past S and T) into one K and one V buffer, as in
// FlashAttention-2: V_j lands while Q K_j^T is computed, K_{j+1} while P V_j
// is. A K tile holds kn in its first DN columns and kr in its last DR, so
// Q K^T is one product over DN + DR. Rows are padded by 8 elements in
// shared memory (DN + DR + 8 and DV + 8: 25 and 17 chunks of 16 bytes at
// 192 and 128, odd, so ldmatrix's eight rows hit eight bank groups). S = Q
// K^T is mma.sync.m16n8k16 with float32 sums; the online softmax runs on
// the accumulators in base 2, a row's max and sum reduced over its quad:
// the max is taken over the unscaled products (scale > 0 keeps their
// order), and exp2((s - m) scale log2 e) is one FFMA and one MUFU
// ex2.approx.ftz (a p below 2^-126 is flushed to 0: a row's sum is at
// least 1). The accumulators are rescaled only when a row's max
// moved. The C fragments of S, rounded to bf16 as soon as the row sums have
// them, are the A fragments of P V; V feeds the B fragments through
// ldmatrix.trans. Key tiles above the diagonal are skipped: the block loads
// those up to its last row, and a warp computes those up to its own; only
// tiles that cross the diagonal or the end of T are masked. The sums are
// normalised after P V, rounded once to bf16, staged through the warp's
// rows of the Q tile and stored 16 bytes a lane.
//
// What bounds it: a layer of dsv2-tp4-prefill on one card (B 8, S = T =
// 4096, 32 heads, qk 192, v 128) is 2 S (S + 1) / 2 (192 + 128) B H = 1.38
// TFLOP, 1.4 ms at the bf16 tensor-core peak, against 1.2 GB of q, k, v and
// out, 0.36 ms at 3.35 TB/s: the products bound it. mma.sync is fed from
// shared memory through ldmatrix, whose bandwidth caps it below the peak;
// 32 rows a warp read 0.33 ldmatrix.x4 a product against 0.5 at 16 rows a
// warp (4.6 against 6.0 ms a layer on an H100). The shared memory is 92 KB
// (two blocks an SM). The grid is 32 x 32 x 8 blocks, the q tiles of one
// (b, h) side by side, so its K and V come from L2.
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

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::exp2_ftz;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsQ = 32 * kWarps;   // 128 query rows a block, 32 a warp
constexpr int kTileK = 64;            // keys a K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemPerSm = 233472;   // an H100 SM's shared memory, bytes
constexpr int kSmemPerBlock = 232448;

struct Strides {
  int64_t b, h, s;
};

// Shared memory: the Q tile and one K tile (rows of DN + DR + 8), then one
// V tile (rows of DV + 8), bf16.
template <int DN, int DR, int DV>
constexpr int smem_bytes() {
  return ((kRowsQ + kTileK) * (DN + DR + 8) + kTileK * (DV + 8)) *
         (int)sizeof(bf16);
}

// Two floats as a bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows r0 .. r0 + ROWS - 1 of a (len, 8 CH) operand with row stride `st`
// into columns col0 .. col0 + 8 CH of a tile with rows of LD elements; zero
// past len.
template <int ROWS, int CH, int LD>
__device__ __forceinline__ void load_rows(uint32_t dst, int col0,
                                          const bf16* src, int64_t st, int r0,
                                          int len) {
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx % CH;
    const bool ok = r0 + r < len;
    cp_async16(dst + (r * LD + col0 + ch * 8) * (int)sizeof(bf16),
               ok ? src + (r0 + r) * st + ch * 8 : src, ok);
  }
}

template <int DN, int DR, int DV>
__global__ void __launch_bounds__(kThreads, 2)
mla_attention_kernel_mma(const bf16* __restrict__ q,
                         const bf16* __restrict__ kn,
                         const bf16* __restrict__ kr,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int64_t kr_b, int64_t kr_s, int s_len, int t_len,
                         float scale) {
  constexpr int DQ = DN + DR;
  constexpr int LQ = DQ + 8;     // padded Q and K rows, elements
  constexpr int LV = DV + 8;     // padded V rows
  constexpr int KD = DQ / 16;    // k-steps of Q K^T
  constexpr int ND = DV / 8;     // n-tiles of P V
  constexpr int CHV = DV / 8;    // 16-byte chunks of an output row
  constexpr int B2 = (int)sizeof(bf16);
  static_assert(DN % 8 == 0 && DR % 8 == 0 && DQ % 16 == 0 && DV % 16 == 0,
                "widths on the 16-byte and k-step grid");
  static_assert((LQ * B2 / 16) % 2 == 1 && (LV * B2 / 16) % 2 == 1,
                "an odd number of 16-byte chunks a row: no ldmatrix "
                "bank conflicts");
  static_assert(DV <= LQ, "the output is staged in the Q tile's rows");
  extern __shared__ __align__(16) bf16 tiles[];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* knp = kn + b * ks.b + h * ks.h;
  const bf16* krp = kr + b * kr_b;
  const bf16* vp = v + b * vs.b + h * vs.h;

  const uint32_t q_tile = (uint32_t)__cvta_generic_to_shared(tiles);
  const uint32_t k_tile = q_tile + kRowsQ * LQ * B2;
  const uint32_t v_tile = k_tile + kTileK * LQ * B2;
  auto load_k = [&](int t0) {
    load_rows<kTileK, DN / 8, LQ>(k_tile, 0, knp, ks.s, t0, t_len);
    load_rows<kTileK, DR / 8, LQ>(k_tile, DN, krp, kr_s, t0, t_len);
  };

  // causal: keys past the tile's last query row contribute nothing
  const int kv_end = min(t_len, q0 + kRowsQ);
  const float scale2 = scale * kLog2e;
  const int n_tiles = (kv_end + kTileK - 1) / kTileK;
  load_rows<kRowsQ, DQ / 8, LQ>(q_tile, 0, qp, qs.s, q0, s_len);
  load_k(0);
  cp_async_commit();

  // ldmatrix: lanes 8j..8j+7 give the rows of the j-th 8 x 8 matrix; the
  // mma fragments: g = lane / 4 is the row (A, C) or column (B), t4 = lane
  // % 4 the pair of columns (A, C) or rows (B)
  const int mj = lane >> 3, mr = lane & 7;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 32;              // the warp's rows in the tile
  float o[2][ND][4];                       // [m-tile][n-tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
  // rows g and g + 8 of each m-tile: running max (of the unscaled
  // products) and sum
  float m[2][2] = {{kNeg, kNeg}, {kNeg, kNeg}};
  float l[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kTileK;
    cp_async_wait<0>();   // K_j (and at j = 0 Q) has landed
    __syncthreads();      // and every warp is done with V_{j-1}
    load_rows<kTileK, DV / 8, LV>(v_tile, 0, vp, vs.s, t0, t_len);
    cp_async_commit();
    // a warp whose rows all lie above the tile's first key skips it
    const bool active = t0 <= q0 + row0 + 31;
    uint32_t pa[2][4][4];  // bf16 p: [m-tile][16 keys][A fragment]
    if (active) {
      // s = q k^T over DN + DR columns: 8 n-tiles of 8 keys a m-tile
      float s[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], q_tile + ((row0 + mt * 16 + (mj & 1) * 8 + mr) *
                                           LQ + kk * 16 + (mj >> 1) * 8) * B2);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15), then keys 8-15
          uint32_t r[4];
          ldmatrix_x4(r, k_tile + ((p * 16 + (mj >> 1) * 8 + mr) * LQ +
                                   kk * 16 + (mj & 1) * 8) * B2);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(s[mt][2 * p], a[mt], r[0], r[1]);
            mma_bf16(s[mt][2 * p + 1], a[mt], r[2], r[3]);
          }
        }
      }

      // mask only a tile that crosses the end of T or the warp's diagonal
      if (t0 + kTileK > t_len || t0 + kTileK - 1 > q0 + row0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = t0 + n * 8 + 2 * t4 + (e & 1);
              const int i = q0 + row0 + mt * 16 + g + (e >> 1) * 8;
              if (key >= t_len || key > i) s[mt][n][e] = kNeg;
            }
      }

      // online softmax over the rows g and g + 8 of each m-tile, each held
      // by a quad; p leaves as bf16 A fragments
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float corr[2], ms[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          corr[r] = exp2_ftz((m[mt][r] - mx[r]) * scale2);
          m[mt][r] = mx[r];
          ms[r] = mx[r] * scale2;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][n][e] = exp2_ftz(fmaf(s[mt][n][e], scale2, -ms[e >> 1]));
            rs[e >> 1] += s[mt][n][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * corr[r] + rs[r];
        if (corr[0] != 1.0f || corr[1] != 1.0f) {
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[mt][n][0] *= corr[0];
            o[mt][n][1] *= corr[0];
            o[mt][n][2] *= corr[1];
            o[mt][n][3] *= corr[1];
          }
        }
        // the C fragments of key tiles 2kk and 2kk + 1 are the A fragment
        // of keys 16kk .. 16kk + 15
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0],
                                    s[mt][2 * kk + 1][1]);
          pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2],
                                    s[mt][2 * kk + 1][3]);
        }
      }
    }
    cp_async_wait<0>();   // V_j has landed
    __syncthreads();      // and every warp is done with K_j
    if (j + 1 < n_tiles) load_k(t0 + kTileK);
    cp_async_commit();
    if (active) {
      // o += bf16(p) v
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          // matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7), then d 8-15,
          // each transposed
          uint32_t r[4];
          ldmatrix_x4_trans(r, v_tile + ((kk * 16 + (mj & 1) * 8 + mr) * LV +
                                         dp * 16 + (mj >> 1) * 8) * B2);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(o[mt][2 * dp], pa[mt][kk], r[0], r[1]);
            mma_bf16(o[mt][2 * dp + 1], pa[mt][kk], r[2], r[3]);
          }
        }
    }
  }
  cp_async_wait<0>();

  // normalise, round once, stage the warp's 32 rows in its own rows of the
  // Q tile (no other warp reads them), and store 16 bytes a lane
  bf16* tile = tiles + row0 * LQ;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(kFull, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(kFull, l[mt][r], 2);
      inv[r] = 1.0f / fmaxf(l[mt][r], 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(tile + (mt * 16 + g) * LQ + col) =
          pack_bf16(o[mt][n][0] * inv[0], o[mt][n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(tile + (mt * 16 + g + 8) * LQ + col) =
          pack_bf16(o[mt][n][2] * inv[1], o[mt][n][3] * inv[1]);
    }
  }
  __syncwarp();
  bf16* op = out + b * os.b + h * os.h;
  for (int idx = lane; idx < 32 * CHV; idx += 32) {
    const int r = idx / CHV, ch = idx % CHV;
    const int i = q0 + row0 + r;
    if (i < s_len)
      *reinterpret_cast<uint4*>(op + i * os.s + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + r * LQ + ch * 8);
  }
}

// DeepSeek-V2's widths take two blocks an SM (each block also holds 1 KB
// the system reserves)
static_assert(smem_bytes<128, 64, 128>() <= kSmemPerBlock &&
                  2 * (smem_bytes<128, 64, 128>() + 1024) <= kSmemPerSm,
              "two blocks an SM at qk 128 + 64, v 128");

template <int DN, int DR, int DV>
int launch(const void* q, const void* kn, const void* kr, const void* v,
           void* out, Strides qs, Strides ks, Strides vs, Strides os,
           int64_t kr_b, int64_t kr_s, int batch, int heads, int s_len,
           int t_len, float scale, int device, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DN, DR, DV>();
  static_assert(smem <= kSmemPerBlock, "one block's shared memory");
  static repro::SmemLimit limit;
  cudaError_t err =
      limit.ensure(mla_attention_kernel_mma<DN, DR, DV>, smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kRowsQ - 1) / kRowsQ), (unsigned)heads,
                  (unsigned)batch);
  mla_attention_kernel_mma<DN, DR, DV><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)kn, (const bf16*)kr, (const bf16*)v,
      (bf16*)out, qs, ks, vs, os, kr_b, kr_s, s_len, t_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 throughout; scale > 0 (the max is taken before scaling). Strides are
// in elements: three each for q, kn, v and out
// (B, H, S|T), then two for kr (B, T); each a multiple of 8, the five
// pointers 16-byte aligned, and (dn, dr, dv) one of the compiled widths
// (kernels/mla_attention.py:WIDTHS); anything else is refused. Launches
// on `device`'s `stream` without synchronising; returns cudaGetLastError().
int repro_mla_attention(const void* q, const void* kn, const void* kr,
                        const void* v, void* out, const int64_t* strides,
                        int batch, int heads, int s_len, int t_len, int dn,
                        int dr, int dv, float scale, int device,
                        void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      s_len <= 0 || t_len <= 0 || !(scale > 0.0f))
    return (int)cudaErrorInvalidValue;
  bool ok = ((uintptr_t)q | (uintptr_t)kn | (uintptr_t)kr | (uintptr_t)v |
             (uintptr_t)out) % 16 == 0;
  for (int i = 0; i < 14; ++i) ok = ok && strides[i] % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_MLA(DN, DR, DV)                                              \
  if (dn == DN && dr == DR && dv == DV)                                    \
    return launch<DN, DR, DV>(q, kn, kr, v, out, qs, ks, vs, os,          \
                              strides[12], strides[13], batch, heads,     \
                              s_len, t_len, scale, device, s);
  REPRO_MLA(128, 64, 128)   // DeepSeek-V2
  REPRO_MLA(32, 16, 32)     // the reduced MLA configs (configs.reduce_config)
#undef REPRO_MLA
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(mla_attention, repro_mla_attention)
