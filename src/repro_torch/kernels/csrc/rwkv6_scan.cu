// RWKV6 WKV chunked scan, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel repro/kernels/rwkv6_scan.py:
// rwkv6_scan (_rwkv_kernel). For each (batch b, head h), over chunks of L
// positions, with logw clipped to [-6, 0] as it is read (the TPU kernel's
// wrapper clips it, rwkv6_scan.py:69), cum the inclusive and cum_ex the
// exclusive prefix sum of logw inside the chunk (per channel k), and the
// (K, V) state S in float32:
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
// states (B, H, K, V), all contiguous; logw float32.
//
// Two kernels; the wrapper (repro_torch/kernels/rwkv6_scan.py:variant)
// names the one to run, by shape and alignment, before the launch:
//
// rwkv6_scan_kernel_tiled, the serving path, in float32 and bf16: L a
// multiple of 8 up to 32, K <= 64, K and V whole 16-byte runs of elements,
// r, k, v and logw on the 16-byte grid. o[:, v] and S[:, v] depend on v
// only through v[:, v] and S[:, v], so one block of 128 threads owns a slab
// of kSlab = 32 columns of V for one (h, b), with no second pass: at
// rwkv6's shape 2 x 40 x 4 = 320 blocks, 68 KB of shared memory each in
// bf16, 3 to an SM. The score tile is recomputed by every slab, so its
// cost is cut first. Per chunk:
//   - the clip, and the cumsum over L as a warp-shuffle scan (a lane a
//     row, four channels at a time), in base 2 (logw log2 e, so that one
//     MUFU ex2 takes the place of expf), in place of logw;
//   - factored exponentials: with the chunk cut into sub-chunks of 8 rows
//     and ref_I = cum_ex at the first row of query sub-chunk I, for j in an
//     earlier sub-chunk A_ij = sum_k (r_ik e^(cum_ex_ik - ref_Ik))
//     (k_jk e^(ref_Ik - cum_jk)): both exponents are <= 0, so neither
//     factor exceeds its r or k, and a factor that underflows loses only a
//     term below 1e-38. Those sub-blocks become dense products of two
//     stored factors (2 x 2 register tiles, four 16-byte loads to 16
//     FMAs); only the 8 x 8 diagonal sub-blocks keep the direct
//     exp(cum_ex_ik - cum_jk), spread over all 128 threads (four lanes a
//     pair (i, j), every fourth quad of channels each). That is L K (L/8 +
//     1) + L^2 K / 16 exponentials where the direct tile takes
//     L (L - 1) K / 2;
//   - o = A v + (r . u k) v + r e^(cum_ex) S and the state update S' =
//     e^(cum_L) S + (k e^(cum_L - cum))^T v, with r e^(cum_ex) and
//     k e^(cum_L - cum) formed once a chunk. In bf16 they run on tensor
//     cores (mma.sync.m16n8k16, float32 sums): v is exact, A and
//     k e^(cum_L - cum) are split into bf16 hi + lo parts and multiplied
//     twice, r e^(cum_ex) S with both split (hi hi + hi lo + lo hi), about
//     16 bits each, as flash_attention_kernel_mma does for p; the state
//     stays in accumulator registers across chunks, its parts in shared
//     memory for o. In float32 they run on CUDA cores as register tiles
//     (2 x 4 and 4 x 4 a thread);
//   - cp.async staging: v for the next chunk into the other of two stages
//     at the top of the chunk, r, k and logw once o is done with them.
//
// rwkv6_scan_kernel, every other call: one block of 256 threads per (h, b),
// looping over chunks, with the state in shared memory throughout. A_ij is
// summed over k directly, each exponent cum_ex_ik - cum_jk = sum of logw
// over positions j+1..i-1, so <= 0 for j < i (no overflow). The (L, K)
// tiles are padded to K + 1 columns so that the 32 threads of a warp,
// reading 32 rows j of one column, hit 32 banks. About 79 KB of shared
// memory at L = 32, K = V = 64. CUDA cores only.
//
// What bounds it, counted as chip_smoke.py:rwkv_work counts it: on the
// serving path (rwkv6-3b prefill: B 4, S 128, H 40, K = V = 64, L 32,
// bf16 r, k, v) it must move 21.0 MB (r, k, v and o 2.6 MB each in bf16,
// logw 5.2 MB in float32, the states in and out 2.6 MB each): 6.26 us at
// 3.35 TB/s. Its float32-precision products (the score tile, o and the
// state update) on bf16 tensor cores with the float32 operands split, two
// or three bf16 products each, are 1.04 G operations at 989 TFLOP/s:
// 1.05 us; the exponentials the factored score tile needs, the decays and
// the bonus, 0.03 G at 67 TFLOP/s of float32: 0.40 us. So the bytes bound
// it: 6.26 us. It launches 32 times per prefill (once per layer).
//
// A C launcher, called from Python through the extension module that
// csrc/launch.cuh makes of the library: it returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLogwMin = -6.0f;  // the wrapper's LOGW_MIN

// logw clipped to [kLogwMin, 0]; a NaN passes, as through torch.clamp
__device__ __forceinline__ float clip_logw(float w) {
  return w < kLogwMin ? kLogwMin : (w > 0.0f ? 0.0f : w);
}

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
      cum[i * K1 + c] = clip_logw(a.logw[g]);
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

// ---- rwkv6_scan_kernel_tiled -------------------------------------------------

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::exp2_ftz;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int kTiledThreads = 128;
constexpr int kMaxL = 32;  // rows of a chunk a block holds
constexpr int kMaxK = 64;  // channels of r, k and the state a block holds
constexpr int kSub = 8;    // rows of a sub-chunk of the score tile
constexpr int kSlab = 32;  // columns of V a block owns
constexpr int kQuads = kMaxK / 4;  // quads of channels a row
// rows of the stored k factors: 8 I for each query sub-chunk I >= 1
constexpr int kMaxKf = 4 * (kMaxL / kSub) * (kMaxL / kSub - 1);
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes, checked below against the SM.
// Both layouts hold r and k (L, kLdT) in T; logw, then its cumsum, (L,
// kLd) float; two stages of the v slab (L, kVl) in T; the r factors (L,
// kLd) and the k factors (kMaxKf, kLd) float; 2^cum_L (K) and the bonus
// (L) float. Then:
template <typename T>
struct TiledSmem;
// float32: k 2^(cum_L - cum) and r 2^cum_ex (L, kLd), A^T (L, kAt) and the
// state slab (K, kSt), float.
template <>
struct TiledSmem<float> {
  static constexpr int kLdT = kMaxK + 4;
  static constexpr int kLd = kMaxK + 4;
  static constexpr int kVl = kSlab;
  static constexpr int kAt = kMaxL + 4;
  static constexpr int kSt = kSlab + 4;
  static constexpr int kR = 0;
  static constexpr int kK = kR + kMaxL * kLdT * 4;
  static constexpr int kW = kK + kMaxL * kLdT * 4;
  static constexpr int kV = kW + kMaxL * kLd * 4;
  static constexpr int kVStage = kMaxL * kVl * 4;
  static constexpr int kRf = kV + 2 * kVStage;
  static constexpr int kKf = kRf + kMaxL * kLd * 4;
  static constexpr int kCdec = kKf + kMaxKf * kLd * 4;
  static constexpr int kBonus = kCdec + kMaxK * 4;
  static constexpr int kKd = kBonus + kMaxL * 4;
  static constexpr int kRdec = kKd + kMaxL * kLd * 4;
  static constexpr int kAtT = kRdec + kMaxL * kLd * 4;
  static constexpr int kS = kAtT + kMaxL * kAt * 4;
  static constexpr int kBytes = kS + kMaxK * kSt * 4;
};
// bf16: r 2^cum_ex (L, kLdT), A (L, kAl) and the state slab (K, kVl), each
// as bf16 hi and lo parts, the tensor cores' operands; k 2^(cum_L - cum)
// (L, kLdT) alike, over the r and k factors once the score tile is done.
// Every bf16 row read by ldmatrix is an odd number of 16-byte chunks.
template <>
struct TiledSmem<bf16> {
  static constexpr int kLdT = kMaxK + 8;
  static constexpr int kLd = kMaxK + 4;
  static constexpr int kVl = kSlab + 8;
  static constexpr int kAl = kMaxL + 8;
  static constexpr int kR = 0;
  static constexpr int kK = kR + kMaxL * kLdT * 2;
  static constexpr int kW = kK + kMaxL * kLdT * 2;
  static constexpr int kV = kW + kMaxL * kLd * 4;
  static constexpr int kVStage = kMaxL * kVl * 2;
  static constexpr int kRf = kV + 2 * kVStage;
  static constexpr int kKf = kRf + kMaxL * kLd * 4;
  static constexpr int kCdec = kKf + kMaxKf * kLd * 4;
  static constexpr int kBonus = kCdec + kMaxK * 4;
  static constexpr int kKdHi = kRf;
  static constexpr int kKdLo = kKdHi + kMaxL * kLdT * 2;
  static constexpr int kRdHi = kBonus + kMaxL * 4;
  static constexpr int kRdLo = kRdHi + kMaxL * kLdT * 2;
  static constexpr int kAHi = kRdLo + kMaxL * kLdT * 2;
  static constexpr int kALo = kAHi + kMaxL * kAl * 2;
  static constexpr int kSHi = kALo + kMaxL * kAl * 2;
  static constexpr int kSLo = kSHi + kMaxK * kVl * 2;
  static constexpr int kBytes = kSLo + kMaxK * kVl * 2;
};
// a block fits the 227 KB a block may use; in bf16 three share an SM (228
// KB, 1 KB of each reserved)
static_assert(TiledSmem<float>::kBytes <= 227 * 1024, "one block an SM");
static_assert(3 * (TiledSmem<bf16>::kBytes + 1024) <= 228 * 1024,
              "three blocks an SM");

// n consecutive values of a row in shared memory as floats (n = 2, 4; the
// address is aligned to n elements).
template <int n>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (n == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  }
}
template <int n>
__device__ __forceinline__ void load_row(const bf16* p, float* out) {
  if constexpr (n == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    out[0] = __low2float(v), out[1] = __high2float(v);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    out[0] = __low2float(h[0]), out[1] = __high2float(h[0]);
    out[2] = __low2float(h[1]), out[3] = __high2float(h[1]);
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
// four floats at p_hi and p_lo (8-byte aligned) as bf16 hi and lo parts
__device__ __forceinline__ void store_split4(bf16* p_hi, bf16* p_lo,
                                             float a, float b, float c,
                                             float d) {
  uint2 hi, lo;
  split_bf16(a, b, hi.x, lo.x);
  split_bf16(c, d, hi.y, lo.y);
  *reinterpret_cast<uint2*>(p_hi) = hi;
  *reinterpret_cast<uint2*>(p_lo) = lo;
}

// One block of 128 threads per (V-slab, h, b). The score tile, the
// factors and the bonus are computed alike in both types; o and the state
// update run on CUDA cores in float32 and on tensor cores in bf16 (see the
// header).
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
rwkv6_scan_kernel_tiled(Args a) {
  using Sm = TiledSmem<T>;
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int VEC = 16 / (int)sizeof(T), LDT = Sm::kLdT, LD = Sm::kLd,
                VL = Sm::kVl, NT = kTiledThreads;
  constexpr int CP = kSlab / 8;  // o and state columns a thread (float32)
  extern __shared__ __align__(16) unsigned char tiles[];
  const T* rs = reinterpret_cast<const T*>(tiles + Sm::kR);
  const T* ks = reinterpret_cast<const T*>(tiles + Sm::kK);
  float* cum = reinterpret_cast<float*>(tiles + Sm::kW);
  float* rf = reinterpret_cast<float*>(tiles + Sm::kRf);
  float* kf = reinterpret_cast<float*>(tiles + Sm::kKf);
  float* cdec = reinterpret_cast<float*>(tiles + Sm::kCdec);
  float* bonus = reinterpret_cast<float*>(tiles + Sm::kBonus);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mj = lane >> 3, mr = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int v0 = blockIdx.x * kSlab, h = blockIdx.y, b = blockIdx.z;
  const int L = a.chunk, K = a.kd, V = a.vd, n_sub = L / kSub;
  const T* r = (const T*)a.r;
  const T* kp = (const T*)a.k;
  const T* vp = (const T*)a.v;
  T* o = (T*)a.o;
  const float* u = a.u + (int64_t)h * K;
  const int64_t sbase = ((int64_t)b * a.heads + h) * K * V;
  const uint32_t smem0 = (uint32_t)__cvta_generic_to_shared(tiles);
  // the element offset of row t of a (B, S, H, width) tensor
  auto row = [&](int t, int width) {
    return (((int64_t)b * a.seqlen + t) * a.heads + h) * width;
  };

  // r, k and logw of chunk t0, rows past L and channels past K zero-filled
  auto load_rkw = [&](int t0) {
    constexpr int RC = kMaxK / VEC;
    for (int idx = tid; idx < kMaxL * RC; idx += NT) {
      const int i = idx / RC, c = idx % RC;
      const bool ok = i < L && c * VEC < K;
      const int64_t gofs = ok ? row(t0 + i, K) + c * VEC : 0;
      const int off = (i * LDT + c * VEC) * (int)sizeof(T);
      cp_async16(smem0 + Sm::kR + off, r + gofs, ok);
      cp_async16(smem0 + Sm::kK + off, kp + gofs, ok);
    }
    constexpr int WC = kMaxK / 4;
    for (int idx = tid; idx < kMaxL * WC; idx += NT) {
      const int i = idx / WC, c = idx % WC;
      const bool ok = i < L && c * 4 < K;
      cp_async16(smem0 + Sm::kW + (i * LD + c * 4) * 4,
                 a.logw + (ok ? row(t0 + i, K) + c * 4 : 0), ok);
    }
  };
  // the v slab of chunk t0 into stage s
  auto load_v = [&](int s, int t0) {
    constexpr int VC = kSlab / VEC;
    for (int idx = tid; idx < kMaxL * VC; idx += NT) {
      const int i = idx / VC, c = idx % VC, col = v0 + c * VEC;
      const bool ok = i < L && col < V;
      cp_async16(smem0 + Sm::kV + s * Sm::kVStage +
                     (i * VL + c * VEC) * (int)sizeof(T),
                 vp + (ok ? row(t0 + i, V) + col : 0), ok);
    }
  };
  // cum_ex of row i at channels k4 .. k4 + 3: the cumsum of the row before
  auto cum_ex = [&](int i, int k4, float* out) {
    if (i == 0) {
      out[0] = out[1] = out[2] = out[3] = 0.0f;
    } else {
      load_row<4>(cum + (i - 1) * LD + k4, out);
    }
  };

  // The state slab, in registers across chunks: in float32 thread (tk, tv)
  // owns rows 4 tk .. and columns CP tv ..; in bf16 warp w owns rows
  // 16w .. 16w + 15 in C fragments (row 16w + g + 8 (e >> 1), column
  // 8 n + 2 t4 + (e & 1)). Shared memory mirrors it for o.
  const int tk = tid >> 3, tv = tid & 7;
  constexpr int SR = kMma ? kSlab / 8 : 4, SC = kMma ? 4 : CP;
  float sreg[SR][SC];
  auto state_at = [&](int x, int y, int& k, int& col) {
    if constexpr (kMma) {
      k = 16 * warp + g + 8 * (y >> 1), col = 8 * x + 2 * t4 + (y & 1);
    } else {
      k = 4 * tk + x, col = CP * tv + y;
    }
  };
  auto put_state = [&]() {
    if constexpr (kMma) {
      bf16* s_hi = reinterpret_cast<bf16*>(tiles + Sm::kSHi);
      bf16* s_lo = reinterpret_cast<bf16*>(tiles + Sm::kSLo);
#pragma unroll
      for (int x = 0; x < SR; ++x)
#pragma unroll
        for (int y = 0; y < 4; y += 2) {
          int k, col;
          state_at(x, y, k, col);
          uint32_t hi, lo;
          split_bf16(sreg[x][y], sreg[x][y + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + k * VL + col) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + k * VL + col) = lo;
        }
    } else {
      float* st = reinterpret_cast<float*>(tiles + Sm::kS);
#pragma unroll
      for (int x = 0; x < SR; ++x)
#pragma unroll
        for (int y = 0; y < SC; ++y) {
          int k, col;
          state_at(x, y, k, col);
          st[k * Sm::kSt + col] = sreg[x][y];
        }
    }
  };

  const int n_chunks = a.seqlen / L;
  load_rkw(0);
  load_v(0, 0);
  cp_async_commit();
  // what no chunk writes stays 0: the upper triangle of A (o reads A_ii
  // and, on tensor cores, whole tiles), rows past L and channels past K
  if constexpr (kMma) {
    for (int idx = tid; idx < (Sm::kSHi - Sm::kRdHi) / 4; idx += NT)
      reinterpret_cast<uint32_t*>(tiles + Sm::kRdHi)[idx] = 0u;
  } else {
    float* at = reinterpret_cast<float*>(tiles + Sm::kAtT);
    if (tid < kMaxL) at[tid * Sm::kAt + tid] = 0.0f;
  }
  for (int k = tid; k < kMaxK; k += NT) cdec[k] = 0.0f;
#pragma unroll
  for (int x = 0; x < SR; ++x)
#pragma unroll
    for (int y = 0; y < SC; ++y) {
      int k, col;
      state_at(x, y, k, col);
      sreg[x][y] = a.s0 && k < K && v0 + col < V
                       ? a.s0[sbase + (int64_t)k * V + v0 + col] : 0.0f;
    }
  put_state();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * L;
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last one is consumed
    if (ch + 1 < n_chunks) load_v((ch + 1) & 1, t0 + L);
    cp_async_commit();
    const T* vs = reinterpret_cast<const T*>(tiles + Sm::kV +
                                             (ch & 1) * Sm::kVStage);

    // the clip, base 2, and the inclusive cumsum over the rows: a lane a
    // row, four channels at a time a warp, in place of logw
    for (int c = 4 * warp; c < K; c += 4 * (NT / 32)) {
      float w[4];
      load_row<4>(cum + lane * LD + c, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = clip_logw(w[e]) * kLog2e;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float up = __shfl_up_sync(kFull, w[e], off);
          if (lane >= off) w[e] += up;
        }
      *reinterpret_cast<float4*>(cum + lane * LD + c) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

    // the factors: r_ik 2^(cum_ex_ik - ref_Ik) and r_ik 2^cum_ex_ik; for
    // each query sub-chunk I >= 1 and row j < 8 I, k_jk 2^(ref_Ik -
    // cum_jk); k_jk 2^(cum_Lk - cum_jk); and 2^cum_L. Every exponent is
    // <= 0. (Rows by 16 quads of channels, those past K skipped: no
    // division.)
    const float* cum_l = cum + (L - 1) * LD;
    for (int idx = tid; idx < L * kQuads; idx += NT) {
      const int i = idx / kQuads, k4 = 4 * (idx % kQuads);
      if (k4 >= K) continue;
      float rv[4], ce[4], ref[4], d[4];
      load_row<4>(rs + i * LDT + k4, rv);
      cum_ex(i, k4, ce);
      cum_ex(i - i % kSub, k4, ref);
      *reinterpret_cast<float4*>(rf + i * LD + k4) = make_float4(
          rv[0] * exp2_ftz(ce[0] - ref[0]), rv[1] * exp2_ftz(ce[1] - ref[1]),
          rv[2] * exp2_ftz(ce[2] - ref[2]), rv[3] * exp2_ftz(ce[3] - ref[3]));
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = rv[e] * exp2_ftz(ce[e]);
      if constexpr (kMma) {
        store_split4(reinterpret_cast<bf16*>(tiles + Sm::kRdHi) + i * LDT + k4,
                     reinterpret_cast<bf16*>(tiles + Sm::kRdLo) + i * LDT + k4,
                     d[0], d[1], d[2], d[3]);
      } else {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(
            tiles + Sm::kRdec) + i * LD + k4) = make_float4(d[0], d[1], d[2],
                                                            d[3]);
      }
    }
    for (int idx = tid; idx < 4 * n_sub * (n_sub - 1) * kQuads; idx += NT) {
      const int kr = idx / kQuads, k4 = 4 * (idx % kQuads);
      if (k4 >= K) continue;
      int I = 1;
      while (4 * I * (I + 1) <= kr) ++I;
      const int j = kr - 4 * I * (I - 1);
      float kv[4], ref[4], cj[4];
      load_row<4>(ks + j * LDT + k4, kv);
      cum_ex(I * kSub, k4, ref);
      load_row<4>(cum + j * LD + k4, cj);
      *reinterpret_cast<float4*>(kf + kr * LD + k4) = make_float4(
          kv[0] * exp2_ftz(ref[0] - cj[0]), kv[1] * exp2_ftz(ref[1] - cj[1]),
          kv[2] * exp2_ftz(ref[2] - cj[2]), kv[3] * exp2_ftz(ref[3] - cj[3]));
    }
    // k 2^(cum_L - cum); in bf16 as hi and lo parts over the factors once
    // they are consumed, zero past L and K (the tensor cores read whole
    // tiles)
    auto k_decayed = [&]() {
      for (int idx = tid; idx < (kMma ? kMaxL : L) * kQuads; idx += NT) {
        const int j = idx / kQuads, k4 = 4 * (idx % kQuads);
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (j < L && k4 < K) {
          float kv[4], cl[4], cj[4];
          load_row<4>(ks + j * LDT + k4, kv);
          load_row<4>(cum_l + k4, cl);
          load_row<4>(cum + j * LD + k4, cj);
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = kv[e] * exp2_ftz(cl[e] - cj[e]);
        } else if (!kMma) {
          continue;
        }
        if constexpr (kMma) {
          store_split4(
              reinterpret_cast<bf16*>(tiles + Sm::kKdHi) + j * LDT + k4,
              reinterpret_cast<bf16*>(tiles + Sm::kKdLo) + j * LDT + k4,
              d[0], d[1], d[2], d[3]);
        } else {
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(
              tiles + Sm::kKd) + j * LD + k4) = make_float4(d[0], d[1], d[2],
                                                            d[3]);
        }
      }
    };
    if constexpr (!kMma) k_decayed();
    for (int k = tid; k < K; k += NT) cdec[k] = exp2_ftz(cum_l[k]);
    {  // the bonus r_i . (u * k_i): four lanes a row, channels apart
      constexpr int parts = NT / kMaxL;
      const int i = tid / parts, part = tid % parts;
      float acc = 0.0f;
      for (int c = part; c < K; c += parts)
        acc += to_f32(rs[i * LDT + c]) * (u[c] * to_f32(ks[i * LDT + c]));
#pragma unroll
      for (int off = 1; off < parts; off <<= 1)
        acc += __shfl_xor_sync(kFull, acc, off);
      if (part == 0) bonus[i] = acc;
    }
    __syncthreads();

    // A_ij, j < i: float32 stores it transposed, bf16 as hi and lo parts
    auto put_a = [&](int i, int j, float val) {
      if constexpr (kMma) {
        const bf16 hi = __float2bfloat16_rn(val);
        reinterpret_cast<bf16*>(tiles + Sm::kAHi)[i * Sm::kAl + j] = hi;
        reinterpret_cast<bf16*>(tiles + Sm::kALo)[i * Sm::kAl + j] =
            __float2bfloat16_rn(val - __bfloat162float(hi));
      } else {
        reinterpret_cast<float*>(tiles + Sm::kAtT)[j * Sm::kAt + i] = val;
      }
    };
    // the sub-blocks left of the diagonal from the factors, a 2 x 2 tile a
    // thread; blocks (I, J), J < I, in the order (1,0), (2,0), (2,1), ...
    if (tid < 8 * n_sub * (n_sub - 1)) {
      int I = 1, J = tid >> 4;
      while (J >= I) J -= I, ++I;
      const int w = tid & 15;
      const int i0 = kSub * I + 2 * (w >> 2), j0 = kSub * J + 2 * (w & 3);
      const float* kf_i = kf + 4 * I * (I - 1) * LD;
      float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
      for (int k4 = 0; k4 < K; k4 += 4) {
        float fr[2][4], fk[2][4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          load_row<4>(rf + (i0 + e) * LD + k4, fr[e]);
          load_row<4>(kf_i + (j0 + e) * LD + k4, fk[e]);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int z = 0; z < 2; ++z)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[x][z] += fr[x][e] * fk[z][e];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int z = 0; z < 2; ++z) put_a(i0 + x, j0 + z, acc[x][z]);
    }
    // ... and the diagonal sub-blocks directly: the 28 pairs j < i of each
    // sub-chunk, four lanes a pair, every fourth quad of channels each
    {
      const int total = n_sub * 28 * 4;
      for (int base = 0; base < total; base += NT) {
        const int e = base + tid;
        float sum = 0.0f;
        int i = 0, j = 0;
        if (e < total) {
          const int pair = e >> 2, part = e & 3, sub = pair / 28;
          int pr = pair % 28, ai = 1;
          while (pr >= ai) pr -= ai, ++ai;
          i = kSub * sub + ai, j = kSub * sub + pr;
          const T* ri = rs + i * LDT;
          const T* kj = ks + j * LDT;
          const float* ei = cum + (i - 1) * LD;  // cum_ex of row i
          const float* cj = cum + j * LD;
#pragma unroll
          for (int c = 4 * part; c < kMaxK; c += 16) {
            if (c >= K) break;
            float rv[4], kv[4], ev[4], cv[4];
            load_row<4>(ri + c, rv);
            load_row<4>(kj + c, kv);
            load_row<4>(ei + c, ev);
            load_row<4>(cj + c, cv);
#pragma unroll
            for (int x = 0; x < 4; ++x)
              sum += rv[x] * kv[x] * exp2_ftz(ev[x] - cv[x]);
          }
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if (e < total && (e & 3) == 0) put_a(i, j, sum);
      }
    }
    __syncthreads();
    if constexpr (kMma) k_decayed();

    if constexpr (kMma) {
      // o = A v + bonus_i v_i + (r 2^cum_ex) S on tensor cores: A split
      // against the exact bf16 v (two products), r 2^cum_ex against S both
      // split (hi hi + hi lo + lo hi); warp w: rows 16 (w & 1) .., column
      // pair (w >> 1) of the slab
      const int mt = warp & 1, np = warp >> 1;
      if (np < kSlab / 16 && 16 * mt < L) {
        const uint32_t vs_a = smem0 + Sm::kV + (ch & 1) * Sm::kVStage;
        float acc[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk > mt) break;
          const int off = ((16 * mt + (mj & 1) * 8 + mr) * Sm::kAl + kk * 16 +
                           (mj >> 1) * 8) * 2;
          uint32_t ah[4], al[4], bv[4];
          ldmatrix_x4(ah, smem0 + Sm::kAHi + off);
          ldmatrix_x4(al, smem0 + Sm::kALo + off);
          ldmatrix_x4_trans(bv, vs_a + ((kk * 16 + (mj & 1) * 8 + mr) * VL +
                                        16 * np + (mj >> 1) * 8) * 2);
          mma_bf16(acc[0], ah, bv[0], bv[1]);
          mma_bf16(acc[0], al, bv[0], bv[1]);
          mma_bf16(acc[1], ah, bv[2], bv[3]);
          mma_bf16(acc[1], al, bv[2], bv[3]);
        }
#pragma unroll
        for (int kk = 0; kk < kMaxK / 16; ++kk) {
          if (kk * 16 >= K) break;
          const int off = ((16 * mt + (mj & 1) * 8 + mr) * LDT + kk * 16 +
                           (mj >> 1) * 8) * 2;
          const int soff = ((kk * 16 + (mj & 1) * 8 + mr) * VL + 16 * np +
                            (mj >> 1) * 8) * 2;
          uint32_t ah[4], al[4], sh[4], sl[4];
          ldmatrix_x4(ah, smem0 + Sm::kRdHi + off);
          ldmatrix_x4(al, smem0 + Sm::kRdLo + off);
          ldmatrix_x4_trans(sh, smem0 + Sm::kSHi + soff);
          ldmatrix_x4_trans(sl, smem0 + Sm::kSLo + soff);
          mma_bf16(acc[0], ah, sh[0], sh[1]);
          mma_bf16(acc[0], ah, sl[0], sl[1]);
          mma_bf16(acc[0], al, sh[0], sh[1]);
          mma_bf16(acc[1], ah, sh[2], sh[3]);
          mma_bf16(acc[1], ah, sl[2], sl[3]);
          mma_bf16(acc[1], al, sh[2], sh[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = 16 * mt + g + 8 * half, c = 16 * np + 8 * n + 2 * t4;
            if (i >= L || v0 + c >= V) continue;
            float vv[2];
            load_row<2>(vs + i * VL + c, vv);
            *reinterpret_cast<uint32_t*>(o + row(t0 + i, V) + v0 + c) =
                pack_bf16(acc[n][2 * half] + bonus[i] * vv[0],
                          acc[n][2 * half + 1] + bonus[i] * vv[1]);
          }
      }
    } else {
      // o: rows 2 ti, 2 ti + 1 and columns CP tv .. of the slab
      const float* at = reinterpret_cast<const float*>(tiles + Sm::kAtT);
      const float* rdec = reinterpret_cast<const float*>(tiles + Sm::kRdec);
      const float* st = reinterpret_cast<const float*>(tiles + Sm::kS);
      const int i0 = 2 * tk;
      if (i0 < L) {
        float acc[2][CP];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[x][q] = 0.0f;
        for (int j = 0; j <= i0; ++j) {
          float av[2], vv[CP];
          load_row<2>(at + j * Sm::kAt + i0, av);
          load_row<CP>(vs + j * VL + CP * tv, vv);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int q = 0; q < CP; ++q) acc[x][q] += av[x] * vv[q];
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float vv[CP];
          load_row<CP>(vs + (i0 + x) * VL + CP * tv, vv);
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[x][q] += bonus[i0 + x] * vv[q];
        }
        for (int k4 = 0; k4 < K; k4 += 4) {
          float d0[4], d1[4];
          load_row<4>(rdec + i0 * LD + k4, d0);
          load_row<4>(rdec + (i0 + 1) * LD + k4, d1);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float sv[CP];
            load_row<CP>(st + (k4 + c) * Sm::kSt + CP * tv, sv);
#pragma unroll
            for (int q = 0; q < CP; ++q) {
              acc[0][q] += d0[c] * sv[q];
              acc[1][q] += d1[c] * sv[q];
            }
          }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          T* orow = o + row(t0 + i0 + x, V);
#pragma unroll
          for (int q = 0; q < CP; ++q) {
            const int col = v0 + CP * tv + q;
            if (col < V) store(orow + col, acc[x][q]);
          }
        }
      }
    }
    __syncthreads();  // every o has read the old state
    // r, k and logw are consumed: stage the next chunk's
    if (ch + 1 < n_chunks) load_rkw(t0 + L);
    cp_async_commit();

    // S' = 2^cum_L S + sum_j (k_j 2^(cum_L - cum_j))^T v_j
    if constexpr (kMma) {
      // on tensor cores, k 2^(cum_L - cum) split against the exact v: warp
      // w, rows 16w .. 16w + 15, every column
      const uint32_t vs_a = smem0 + Sm::kV + (ch & 1) * Sm::kVStage;
      float upd[kSlab / 8][4];
#pragma unroll
      for (int n = 0; n < kSlab / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) upd[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kMaxL / 16; ++kk) {
        if (kk * 16 >= L) break;
        const int off = ((kk * 16 + (mj >> 1) * 8 + mr) * LDT + 16 * warp +
                         (mj & 1) * 8) * 2;
        uint32_t ah[4], al[4];
        ldmatrix_x4_trans(ah, smem0 + Sm::kKdHi + off);
        ldmatrix_x4_trans(al, smem0 + Sm::kKdLo + off);
#pragma unroll
        for (int pp = 0; pp < kSlab / 16; ++pp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs_a + ((kk * 16 + (mj & 1) * 8 + mr) * VL +
                                        16 * pp + (mj >> 1) * 8) * 2);
          mma_bf16(upd[2 * pp], ah, bv[0], bv[1]);
          mma_bf16(upd[2 * pp], al, bv[0], bv[1]);
          mma_bf16(upd[2 * pp + 1], ah, bv[2], bv[3]);
          mma_bf16(upd[2 * pp + 1], al, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int x = 0; x < SR; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          int k, col;
          state_at(x, y, k, col);
          sreg[x][y] = sreg[x][y] * cdec[k] + upd[x][y];
        }
      put_state();
    } else if (4 * tk < K) {
      const float* kd = reinterpret_cast<const float*>(tiles + Sm::kKd);
      float acc[4][CP];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[c][q] = 0.0f;
      for (int j = 0; j < L; ++j) {
        float kv[4], vv[CP];
        load_row<4>(kd + j * LD + 4 * tk, kv);
        load_row<CP>(vs + j * VL + CP * tv, vv);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int q = 0; q < CP; ++q) acc[c][q] += kv[c] * vv[q];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < CP; ++q)
          sreg[c][q] = sreg[c][q] * cdec[4 * tk + c] + acc[c][q];
      put_state();
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int x = 0; x < SR; ++x)
#pragma unroll
    for (int y = 0; y < SC; ++y) {
      int k, col;
      state_at(x, y, k, col);
      if (k < K && v0 + col < V)
        a.s_out[sbase + (int64_t)k * V + v0 + col] = sreg[x][y];
    }
}

template <typename T>
int launch_tiled(const Args& a, int batch, int device, cudaStream_t stream) {
  constexpr int smem = TiledSmem<T>::kBytes;
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(rwkv6_scan_kernel_tiled<T>, smem,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.vd + kSlab - 1) / kSlab), (unsigned)a.heads,
                  (unsigned)batch);
  rwkv6_scan_kernel_tiled<T><<<grid, kTiledThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kernel(const Args& a, int batch, int tiled, int device,
                  cudaStream_t stream) {
  if (!tiled) return launch<T>(a, batch, device, stream);
  if (a.chunk > kMaxL || a.chunk % kSub || a.kd > kMaxK || a.kd % 4 ||
      a.heads > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_tiled<T>(a, batch, device, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o share it); logw, u and the
// states are float32. s0 may be null. tiled: 0 runs rwkv6_scan_kernel, 1
// rwkv6_scan_kernel_tiled. Launches on `device`'s `stream` without
// synchronising; returns cudaGetLastError().
int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0, void* o,
                     void* s_out, int batch, int seqlen, int heads, int kd,
                     int vd, int chunk, int dtype, int tiled, int device,
                     void* stream) {
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
  if (dtype == 0) return launch_kernel<float>(a, batch, tiled, device, s);
  if (dtype == 1) return launch_kernel<bf16>(a, batch, tiled, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(rwkv6_scan, repro_rwkv6_scan)
