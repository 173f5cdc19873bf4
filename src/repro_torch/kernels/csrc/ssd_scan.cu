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
// Two kernels; the wrapper (repro_torch/kernels/ssd_scan.py:variant) names
// the one to run, by shape and alignment, before the launch:
//
// ssd_scan_kernel_tiled, the serving path, in float32 and bf16: L <= 64,
// N <= 64, P and N whole 16-byte runs of elements, and x, B and C on the
// 16-byte grid (pointers and strides). y[:, p] and S[p, :] depend on p only
// through (x dt)[:, p] and S[p, :], so one block of 128 threads owns a slab
// of kSlab = 32 columns of P for one (h, b): y[:, slab] and
// S[slab, :], with no second pass. At zamba2's shape that is 2 x 80 x 4 =
// 640 blocks, 66 KB of shared memory each in bf16, 3 to an SM. Each
// chunk's x slab, dt, B and C arrive by cp.async (16-byte copies, dt 4
// bytes a row) into the other of two stages while this chunk computes, and
// the first chunk's copies are in flight while the initial state is read.
// Warp 0 scans dt A over the chunk with shuffles (two halves of 32 rows).
//   - In bf16, every product runs on tensor cores (mma.sync.m16n8k16,
//     float32 sums), warp w owning rows 16w .. 16w + 15 of the chunk and
//     columns 16w .. 16w + 15 of the state. G = C B^T is exact (products
//     of bf16 values are exact in float32), only the column tiles left of
//     the diagonal; G' = G exp(cum_i - cum_j) dt_j for j <= i (the exponent
//     is never positive) stays in the accumulator registers, which are the
//     A fragments of y = G' x; y += exp(cum_i) C S^T; S' = exp(cum_L) S +
//     (x dt exp(cum_L - cum))^T B. Each product has one exact bf16 operand
//     (C, B or x); the float32 one (G', S, x dt exp(..)) is split into
//     bf16 hi + lo parts and multiplied twice (about 16 bits), as
//     flash_attention_kernel_mma does for p. The state stays in the
//     accumulator registers across chunks, its hi and lo parts in shared
//     memory for the next chunk's y.
//   - In float32, the products run on CUDA cores at float32 precision, as
//     register tiles: G^T a 4 x 8 tile a thread, stored; y a 4 x 4 tile
//     (a 16-byte load of four rows of G^T and one of x dt feed 16
//     FMAs); the state a 4 x 4 tile, in registers across chunks and
//     mirrored in shared memory.
// G is recomputed by each of the 2 slabs of a head and each of the 80
// heads; on tensor cores in bf16 that costs little.
//
// ssd_scan_kernel, every other call: one block of 256 threads per (h, b),
// the state in shared memory from the first chunk to the last. Per chunk
// the block stages x*dt (L, P), B and C (L, N+1: padded so that threads
// reading consecutive rows hit distinct banks) and cum in shared memory,
// forms the causal score tile for j <= i only, then y from G and the
// state, then the new state. At P = N = L = 64 that is about 83 KB of
// shared memory. CUDA cores only.
//
// What bounds it, counted as chip_smoke.py:ssd_work counts it: on the
// serving path (zamba2-2.7b prefill: B 4, S 128, H 80, P 64, N 64, L 64,
// bf16 x, B, C) it must move 21.3 MB (x and y 5.2 MB each, the states in
// and out 5.2 MB each, dt, B and C 0.3 MB): 6.35 us at 3.35 TB/s. Its
// float32-precision products (intra-chunk y, y from the state and the
// state update, 0.84 G operations) take two bf16 products each on tensor
// cores, as this kernel does them, 1.68 G at 989 TFLOP/s: 1.70 us, with
// C B^T once per (b, chunk) and the decays at 67 TFLOP/s of float32 next
// to nothing. So the bytes bound it: 6.35 us. It launches 54 times per
// prefill (once per Mamba2 layer).
//
// A C launcher, called from Python through the extension module that
// csrc/launch.cuh makes of the library: it returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// ---- ssd_scan_kernel_tiled ---------------------------------------------------

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int kTiledThreads = 128;
constexpr int kMaxL = 64;  // rows of a chunk a block holds
constexpr int kMaxN = 64;  // columns of B, C and the state a block holds
constexpr int kSlab = 32;  // columns of P a block owns
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes, checked below against the SM.
// Both layouts start with two stages of the chunk's inputs: the x slab
// (L, kXl) and B and C (L, kLd) in T, dt (L) float. Rows of B and C are
// padded by 16 bytes.
template <typename T>
struct TiledSmem;
// float32: then x dt (L, kSlab), G^T (L, kGt), the state slab (kSlab, kSt)
// and cum, exp(cum) and exp(cum_L - cum) (L each), all float.
template <>
struct TiledSmem<float> {
  static constexpr int kLd = kMaxN + 4;
  static constexpr int kXl = kSlab;
  static constexpr int kGt = kMaxL + 4;
  static constexpr int kSt = kMaxN + 4;
  static constexpr int kX = 0;
  static constexpr int kB = kX + kMaxL * kXl * 4;
  static constexpr int kC = kB + kMaxL * kLd * 4;
  static constexpr int kDt = kC + kMaxL * kLd * 4;
  static constexpr int kStage = kDt + kMaxL * 4;
  static constexpr int kXd = 2 * kStage;
  static constexpr int kG = kXd + kMaxL * kSlab * 4;
  static constexpr int kS = kG + kMaxL * kGt * 4;
  static constexpr int kCum = kS + kSlab * kSt * 4;
  static constexpr int kBytes = kCum + 3 * kMaxL * 4;
};
// bf16: then x dt exp(cum_L - cum) split into bf16 hi and lo parts (L, kXl)
// each, the state slab split alike (kSlab, kLd) each, and cum log2 e,
// exp(cum) and exp(cum_L - cum) (L each) float. Every bf16 row is an odd
// number of 16-byte chunks, so ldmatrix's eight rows hit eight bank groups.
template <>
struct TiledSmem<bf16> {
  static constexpr int kLd = kMaxN + 8;
  static constexpr int kXl = kSlab + 8;
  static constexpr int kX = 0;
  static constexpr int kB = kX + kMaxL * kXl * 2;
  static constexpr int kC = kB + kMaxL * kLd * 2;
  static constexpr int kDt = kC + kMaxL * kLd * 2;
  static constexpr int kStage = kDt + kMaxL * 4;
  static constexpr int kXwHi = 2 * kStage;
  static constexpr int kXwLo = kXwHi + kMaxL * kXl * 2;
  static constexpr int kSHi = kXwLo + kMaxL * kXl * 2;
  static constexpr int kSLo = kSHi + kSlab * kLd * 2;
  static constexpr int kCum = kSLo + kSlab * kLd * 2;
  static constexpr int kBytes = kCum + 3 * kMaxL * 4;
};
// a block fits the 227 KB a block may use; in bf16 three share an SM (228
// KB, 1 KB of each reserved)
static_assert(TiledSmem<float>::kBytes <= 227 * 1024, "one block an SM");
static_assert(3 * (TiledSmem<bf16>::kBytes + 1024) <= 228 * 1024,
              "three blocks an SM");

// chunk t0's inputs into the stage at shared address `base`; rows past L
// and columns past P or N are zero-filled
template <typename T>
__device__ __forceinline__ void load_chunk(const Args& a, uint32_t base,
                                           int t0, int p0, int h, int b) {
  using Sm = TiledSmem<T>;
  constexpr int V = 16 / (int)sizeof(T), XC = kSlab / V, BC = kMaxN / V;
  const int tid = threadIdx.x, L = a.chunk;
  const T* x = (const T*)a.x;
  const T* bm = (const T*)a.bm;
  const T* cm = (const T*)a.cm;
  for (int idx = tid; idx < kMaxL * XC; idx += kTiledThreads) {
    const int i = idx / XC, c = idx % XC, p = p0 + c * V;
    const bool ok = i < L && p < a.p;
    const T* src = x + b * a.xb + (int64_t)(t0 + i) * a.xs + h * a.xh + p;
    cp_async16(base + Sm::kX + (i * Sm::kXl + c * V) * (int)sizeof(T),
               ok ? src : x, ok);
  }
  for (int idx = tid; idx < kMaxL * BC; idx += kTiledThreads) {
    const int i = idx / BC, c = idx % BC;
    const bool ok = i < L && c * V < a.n;
    const int64_t t = t0 + i;
    const int off = (i * Sm::kLd + c * V) * (int)sizeof(T);
    cp_async16(base + Sm::kB + off, ok ? bm + b * a.bb + t * a.bs + c * V
                                       : bm, ok);
    cp_async16(base + Sm::kC + off, ok ? cm + b * a.cb + t * a.cs + c * V
                                       : cm, ok);
  }
  if (tid < kMaxL) {
    const bool ok = tid < L;
    cp_async4(base + Sm::kDt + tid * 4,
              ok ? a.dt + b * a.db + (int64_t)(t0 + tid) * a.ds + h * a.dh
                 : a.dt, ok);
  }
}

// Warp 0: cum = the inclusive cumsum of dt A over the chunk, as a shuffle
// scan over its two halves of 32 rows (rows past L have dt = 0, so they
// hold cum_{L-1}); writes cum (times log2 e when kBase2), exp(cum) and
// exp(cum_{L-1} - cum).
template <bool kBase2>
__device__ __forceinline__ void scan_chunk(const float* dts, float A, int L,
                                           float* cum, float* ecum,
                                           float* wdec) {
  const int lane = threadIdx.x & 31;
  float s0 = dts[lane] * A, s1 = dts[lane + 32] * A;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(kFull, s0, off);
    const float u1 = __shfl_up_sync(kFull, s1, off);
    if (lane >= off) s0 += u0, s1 += u1;
  }
  s1 += __shfl_sync(kFull, s0, 31);
  const float last = L > 32 ? __shfl_sync(kFull, s1, L - 33)
                            : __shfl_sync(kFull, s0, L - 1);
  const float scale = kBase2 ? kLog2e : 1.0f;
  cum[lane] = s0 * scale, cum[lane + 32] = s1 * scale;
  ecum[lane] = expf(s0), ecum[lane + 32] = expf(s1);
  wdec[lane] = expf(last - s0), wdec[lane + 32] = expf(last - s1);
}

// n consecutive floats of a row in shared memory (n = 2, 4, 8; the
// address is aligned to n elements).
template <int n>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (n == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < n; h += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + h);
      out[h] = v.x, out[h + 1] = v.y, out[h + 2] = v.z, out[h + 3] = v.w;
    }
  }
}

// Two floats as a bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// hi = bf16(v) and lo = bf16(v - hi), pairwise: hi + lo holds v to about
// 16 bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// The float32 kernel: every product on CUDA cores at float32 precision.
__device__ __forceinline__ void tiled_fma(const Args& a,
                                          unsigned char* tiles) {
  using Sm = TiledSmem<float>;
  constexpr int LD = Sm::kLd, GT = Sm::kGt, ST = Sm::kSt;
  constexpr int CP = kSlab / 8;  // y columns and state rows a thread
  float* xd = reinterpret_cast<float*>(tiles + Sm::kXd);
  float* gt = reinterpret_cast<float*>(tiles + Sm::kG);
  float* st = reinterpret_cast<float*>(tiles + Sm::kS);
  float* cum = reinterpret_cast<float*>(tiles + Sm::kCum);
  float* ecum = cum + kMaxL;
  float* wdec = ecum + kMaxL;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int p0 = blockIdx.x * kSlab, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, N = a.n, P = a.p;
  float* y = (float*)a.y;
  const float A = a.A[h];
  const int64_t sbase = ((int64_t)b * a.heads + h) * P * N;
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(tiles);

  // the state: thread (tp, tn) owns rows CP tp.. and columns 4 tn.. of the
  // slab, in registers, mirrored in shared memory for y
  const int tp = tid >> 4, tn = tid & 15;
  load_chunk<float>(a, smem0, 0, p0, h, b);  // in flight while s0 is read
  cp_async_commit();
  float sreg[CP][4];
#pragma unroll
  for (int q = 0; q < CP; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = CP * tp + q, n = 4 * tn + c;
      sreg[q][c] = a.s0 && p0 + p < P && n < N
                       ? a.s0[sbase + (int64_t)(p0 + p) * N + n] : 0.0f;
      st[p * ST + n] = sreg[q][c];
    }

  const int n_chunks = a.seqlen / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * L;
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last one is consumed
    if (ch + 1 < n_chunks)
      load_chunk<float>(a, smem0 + ((ch + 1) & 1) * Sm::kStage, t0 + L,
                            p0, h, b);
    cp_async_commit();
    const unsigned char* sg = tiles + (ch & 1) * Sm::kStage;
    const float* xs = reinterpret_cast<const float*>(sg + Sm::kX);
    const float* bs = reinterpret_cast<const float*>(sg + Sm::kB);
    const float* cs = reinterpret_cast<const float*>(sg + Sm::kC);
    const float* dts = reinterpret_cast<const float*>(sg + Sm::kDt);

    for (int idx = tid; idx < kMaxL * kSlab; idx += kTiledThreads)
      xd[idx] = xs[idx] * dts[idx / kSlab];
    if (warp == 0) scan_chunk<false>(dts, A, L, cum, ecum, wdec);
    __syncthreads();

    // G^T[j][i] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0: rows
    // 4 ti .. 4 ti + 3, columns tj + 8c, so lanes read consecutive rows of
    // B, which the padding spreads over the banks
    {
      const int ti = tid >> 3, tj = tid & 7;
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float cv[4][4], bv[8][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) load_row<4>(cs + (4 * ti + r) * LD + n, cv[r]);
#pragma unroll
        for (int c = 0; c < 8; ++c) load_row<4>(bs + (tj + 8 * c) * LD + n, bv[c]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][c] += cv[r][e] * bv[c][e];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = 4 * ti + r, j = tj + 8 * c;
          gt[j * GT + i] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.0f;
        }
    }
    __syncthreads();

    // y: rows 4 ti .. 4 ti + 3 and columns CP tj .. of the slab
    {
      const int ti = tid >> 3, tj = tid & 7;
      float acc[4][CP], off[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = off[r][q] = 0.0f;
      const int j_end = min(4 * ti + 4, L);
      for (int j = 0; j < j_end; ++j) {
        float gv[4], xv[CP];
        load_row<4>(gt + j * GT + 4 * ti, gv);
        load_row<CP>(xd + j * kSlab + CP * tj, xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[r][q] += gv[r] * xv[q];
      }
      for (int n = 0; n < N; n += 8) {
        float cv[4][8], sv[CP][8];
#pragma unroll
        for (int r = 0; r < 4; ++r) load_row<8>(cs + (4 * ti + r) * LD + n, cv[r]);
#pragma unroll
        for (int q = 0; q < CP; ++q) load_row<8>(st + (CP * tj + q) * ST + n, sv[q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < CP; ++q)
#pragma unroll
            for (int e = 0; e < 8; ++e) off[r][q] += cv[r][e] * sv[q][e];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        if (i >= L) continue;
        float* yrow = y + (((int64_t)b * a.seqlen + t0 + i) * a.heads + h) * P;
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int p = p0 + CP * tj + q;
          if (p < P) yrow[p] = acc[r][q] + off[r][q] * ecum[i];
        }
      }
    }
    __syncthreads();  // every y has read the old state

    // S' = exp(cum_L) S + sum_j (x dt)_j exp(cum_L - cum_j) B_j
    {
      float acc[CP][4];
#pragma unroll
      for (int q = 0; q < CP; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
      for (int j = 0; j < L; ++j) {
        const float w = wdec[j];
        float xv[CP], bv[4];
        load_row<CP>(xd + j * kSlab + CP * tp, xv);
        load_row<4>(bs + j * LD + 4 * tn, bv);
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const float xw = xv[q] * w;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][c] += xw * bv[c];
        }
      }
      const float decay = ecum[L - 1];
#pragma unroll
      for (int q = 0; q < CP; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sreg[q][c] = sreg[q][c] * decay + acc[q][c];
          st[(CP * tp + q) * ST + 4 * tn + c] = sreg[q][c];
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int q = 0; q < CP; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + CP * tp + q, n = 4 * tn + c;
      if (p < P && n < N) a.s_out[sbase + (int64_t)p * N + n] = sreg[q][c];
    }
}

// The bf16 kernel: every product on tensor cores (mma.sync.m16n8k16,
// float32 sums), warp w owning rows 16w .. 16w + 15 of the chunk for G and
// y and columns 16w .. 16w + 15 of the state. Each product has one exact
// bf16 operand (C, B or x) and, where the other is float32, that one split
// into bf16 hi + lo parts and multiplied twice (about 16 bits), as
// flash_attention_kernel_mma does for p:
//   G = C B^T (both bf16: exact products), then G' = G 2^(cum_i - cum_j)
//   dt_j for j <= i in the accumulator registers, which are the A
//   fragments of y = G' x (the m16n8 C layout of two adjacent column tiles
//   is the m16k16 A layout);
//   y += exp(cum_i) C S^T, with S split;
//   S' = exp(cum_L) S + (x dt exp(cum_L - cum))^T B, with x dt exp(..)
//   split, its transpose read by ldmatrix.trans.
__device__ __forceinline__ void tiled_mma(const Args& a,
                                          unsigned char* tiles) {
  using Sm = TiledSmem<bf16>;
  constexpr int LD = Sm::kLd, XL = Sm::kXl;
  constexpr int NY = kSlab / 8;   // column tiles of y
  constexpr int MS = kSlab / 16;  // row tiles of the state
  float* cum2 = reinterpret_cast<float*>(tiles + Sm::kCum);  // cum log2 e
  float* ecum = cum2 + kMaxL;
  float* wdec = ecum + kMaxL;
  bf16* xw_hi = reinterpret_cast<bf16*>(tiles + Sm::kXwHi);
  bf16* xw_lo = reinterpret_cast<bf16*>(tiles + Sm::kXwLo);
  bf16* s_hi = reinterpret_cast<bf16*>(tiles + Sm::kSHi);
  bf16* s_lo = reinterpret_cast<bf16*>(tiles + Sm::kSLo);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mj = lane >> 3, mr = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int p0 = blockIdx.x * kSlab, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, N = a.n, P = a.p;
  bf16* y = (bf16*)a.y;
  const float A = a.A[h];
  const int64_t sbase = ((int64_t)b * a.heads + h) * P * N;
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(tiles);
  const uint32_t xw_hi_a = smem0 + Sm::kXwHi, xw_lo_a = smem0 + Sm::kXwLo;
  const uint32_t s_hi_a = smem0 + Sm::kSHi, s_lo_a = smem0 + Sm::kSLo;
  const int row0 = 16 * warp;

  // the state slab in C fragments: row p = 16 m + g + 8 (e >> 1), column
  // n = 16 warp + 8 c + 2 t4 + (e & 1); its hi and lo parts in shared
  // memory for y
  float sreg[MS][2][4];
  auto put_state = [&]() {
#pragma unroll
    for (int m = 0; m < MS; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int p = 16 * m + g + 8 * (e >> 1);
          const int n = row0 + 8 * c + 2 * t4;
          uint32_t hi, lo;
          split_bf16(sreg[m][c][e], sreg[m][c][e + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + p * LD + n) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + p * LD + n) = lo;
        }
  };
  load_chunk<bf16>(a, smem0, 0, p0, h, b);  // in flight while s0 is read
  cp_async_commit();
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * m + g + 8 * (e >> 1);
        const int n = row0 + 8 * c + 2 * t4 + (e & 1);
        sreg[m][c][e] = a.s0 && p0 + p < P && n < N
                            ? a.s0[sbase + (int64_t)(p0 + p) * N + n] : 0.0f;
      }
  put_state();

  const int n_chunks = a.seqlen / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * L;
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last one is consumed
    if (ch + 1 < n_chunks)
      load_chunk<bf16>(a, smem0 + ((ch + 1) & 1) * Sm::kStage, t0 + L,
                           p0, h, b);
    cp_async_commit();
    const uint32_t sg = smem0 + (ch & 1) * Sm::kStage;
    const uint32_t xs_a = sg + Sm::kX, bs_a = sg + Sm::kB, cs_a = sg + Sm::kC;
    const unsigned char* sgp = tiles + (ch & 1) * Sm::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(sgp + Sm::kX);
    const float* dts = reinterpret_cast<const float*>(sgp + Sm::kDt);

    if (warp == 0) scan_chunk<true>(dts, A, L, cum2, ecum, wdec);
    __syncthreads();

    // x dt exp(cum_L - cum), split, for the state update (read after the
    // next barrier)
    for (int idx = tid; idx < kMaxL * kSlab / 2; idx += kTiledThreads) {
      const int j = idx / (kSlab / 2), p = 2 * (idx % (kSlab / 2));
      const float w = dts[j] * wdec[j];
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(xs + j * XL + p);
      uint32_t hi, lo;
      split_bf16(__low2float(xv) * w, __high2float(xv) * w, hi, lo);
      *reinterpret_cast<uint32_t*>(xw_hi + j * XL + p) = hi;
      *reinterpret_cast<uint32_t*>(xw_lo + j * XL + p) = lo;
    }

    // G = C B^T: the warp's 16 rows, column tiles of 8 up to its diagonal
    uint32_t cf[kMaxN / 16][4];
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (kk * 16 >= N) break;
      ldmatrix_x4(cf[kk], cs_a + ((row0 + (mj & 1) * 8 + mr) * LD + kk * 16 +
                                  (mj >> 1) * 8) * 2);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp)
        if (pp <= warp) {
          uint32_t r[4];
          ldmatrix_x4(r, bs_a + ((pp * 16 + (mj >> 1) * 8 + mr) * LD +
                                 kk * 16 + (mj & 1) * 8) * 2);
          mma_bf16(s[2 * pp], cf[kk], r[0], r[1]);
          mma_bf16(s[2 * pp + 1], cf[kk], r[2], r[3]);
        }
    }
    // G' = G 2^(cum_i - cum_j) dt_j for j <= i (the exponent is never
    // positive there), 0 above
    {
      const int i_lo = row0 + g, i_hi = i_lo + 8;
      const float c_lo = cum2[i_lo], c_hi = cum2[i_hi];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n <= 2 * warp + 1)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * n + 2 * t4 + e;
            const float cj = cum2[j], dj = dts[j];
            s[n][e] = j <= i_lo ? s[n][e] * repro::exp2_ftz(c_lo - cj) * dj
                                : 0.0f;
            s[n][e + 2] = j <= i_hi
                              ? s[n][e + 2] * repro::exp2_ftz(c_hi - cj) * dj
                              : 0.0f;
          }
    }

    // y = G' x + exp(cum_i) C S^T
    float yi[NY][4], ys[NY][4];
#pragma unroll
    for (int n = 0; n < NY; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[n][e] = ys[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < NY / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, xs_a + ((kk * 16 + (mj & 1) * 8 + mr) * XL +
                                     dp * 16 + (mj >> 1) * 8) * 2);
        mma_bf16(yi[2 * dp], ph, r[0], r[1]);
        mma_bf16(yi[2 * dp], pl, r[0], r[1]);
        mma_bf16(yi[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(yi[2 * dp + 1], pl, r[2], r[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (kk * 16 >= N) break;
#pragma unroll
      for (int dp = 0; dp < NY / 2; ++dp) {
        const int off = ((dp * 16 + (mj >> 1) * 8 + mr) * LD + kk * 16 +
                         (mj & 1) * 8) * 2;
        uint32_t rh[4], rl[4];
        ldmatrix_x4(rh, s_hi_a + off);
        ldmatrix_x4(rl, s_lo_a + off);
        mma_bf16(ys[2 * dp], cf[kk], rh[0], rh[1]);
        mma_bf16(ys[2 * dp], cf[kk], rl[0], rl[1]);
        mma_bf16(ys[2 * dp + 1], cf[kk], rh[2], rh[3]);
        mma_bf16(ys[2 * dp + 1], cf[kk], rl[2], rl[3]);
      }
    }
    {
      const float e_lo = ecum[row0 + g], e_hi = ecum[row0 + g + 8];
#pragma unroll
      for (int n = 0; n < NY; ++n) {
        const int p = p0 + 8 * n + 2 * t4;
        if (p >= P) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = row0 + g + 8 * half;
          if (i >= L) continue;
          const float ec = half ? e_hi : e_lo;
          bf16* yp = y + (((int64_t)b * a.seqlen + t0 + i) * a.heads + h) * P + p;
          *reinterpret_cast<uint32_t*>(yp) =
              pack_bf16(yi[n][2 * half] + ys[n][2 * half] * ec,
                        yi[n][2 * half + 1] + ys[n][2 * half + 1] * ec);
        }
      }
    }
    __syncthreads();  // every y has read the old state; x w is written

    // S' = exp(cum_L) S + (x dt exp(cum_L - cum))^T B over the warp's 16
    // columns
    float upd[MS][2][4];
#pragma unroll
    for (int m = 0; m < MS; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) upd[m][c][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kMaxL / 16; ++kk) {
      if (kk * 16 >= L) break;
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs_a + ((kk * 16 + (mj & 1) * 8 + mr) * LD + row0 +
                                   (mj >> 1) * 8) * 2);
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const int off = ((kk * 16 + (mj >> 1) * 8 + mr) * XL + 16 * m +
                         (mj & 1) * 8) * 2;
        uint32_t ah[4], al[4];
        ldmatrix_x4_trans(ah, xw_hi_a + off);
        ldmatrix_x4_trans(al, xw_lo_a + off);
        mma_bf16(upd[m][0], ah, r[0], r[1]);
        mma_bf16(upd[m][0], al, r[0], r[1]);
        mma_bf16(upd[m][1], ah, r[2], r[3]);
        mma_bf16(upd[m][1], al, r[2], r[3]);
      }
    }
    const float decay = ecum[L - 1];
#pragma unroll
    for (int m = 0; m < MS; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sreg[m][c][e] = sreg[m][c][e] * decay + upd[m][c][e];
    put_state();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < MS; ++m)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * m + g + 8 * (e >> 1);
        const int n = row0 + 8 * c + 2 * t4 + (e & 1);
        if (p < P && n < N) a.s_out[sbase + (int64_t)p * N + n] = sreg[m][c][e];
      }
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
ssd_scan_kernel_tiled(Args a) {
  extern __shared__ __align__(16) unsigned char tiles[];
  if constexpr (sizeof(T) == 2)
    tiled_mma(a, tiles);
  else
    tiled_fma(a, tiles);
}

template <typename T>
int launch_tiled(const Args& a, int batch, int device, cudaStream_t stream) {
  constexpr int smem = TiledSmem<T>::kBytes;
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(ssd_scan_kernel_tiled<T>, smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.p + kSlab - 1) / kSlab), (unsigned)a.heads,
                  (unsigned)batch);
  ssd_scan_kernel_tiled<T><<<grid, kTiledThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kernel(const Args& a, int batch, int tiled, int device,
                  cudaStream_t stream) {
  if (!tiled) return launch<T>(a, batch, device, stream);
  if (a.chunk > kMaxL || a.n > kMaxN || a.heads > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_tiled<T>(a, batch, device, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); dt, A and the
// states are float32. strides: 10 element strides, x (B, S, H), dt (B, S,
// H), B (B, S), C (B, S). s0 may be null. tiled: 0 runs ssd_scan_kernel,
// 1 ssd_scan_kernel_tiled.
// Launches on `device`'s `stream` without synchronising; returns
// cudaGetLastError().
int repro_ssd_scan(const void* x, const void* dt, const void* A,
                   const void* bm, const void* cm, const void* s0, void* y,
                   void* s_out, const int64_t* strides, int batch, int seqlen,
                   int heads, int p, int n, int chunk, int dtype,
                   int tiled, int device, void* stream) {
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
  if (dtype == 0) return launch_kernel<float>(a, batch, tiled, device, s);
  if (dtype == 1) return launch_kernel<bf16>(a, batch, tiled, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(ssd_scan, repro_ssd_scan)
