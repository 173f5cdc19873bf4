// Capacity-layout grouped expert GEMM, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel repro/kernels/moe_gemm.py:
// moe_gemm (_moe_kernel). For each expert e:
//
//     out[e] = x[e] @ w[e]        x (E, C, K), w (E, K, N), out (E, C, N)
//
// with float32 sums and the output rounded once to x's type, as the TPU
// kernel's float32 accumulator does (moe_gemm.py:22-36). All three tensors
// contiguous. Two kernels; the wrapper (repro_torch/kernels/moe_gemm.py:
// variant) names the one to run, by dtype, shape and alignment:
//
// moe_gemm_kernel_mma, the serving path: bf16, K and N multiples of 8, the
// three pointers 16-byte aligned, any C. Tensor cores fed by a weight
// stream. It computes out^T = w^T x^T, so that N fills the 16-row side of
// mma.sync.m16n8k16 and C its 8-column side: the decode step's C = 8 is one
// n-tile and wastes no row; C = 60 at prefill is padded to 64 inside the
// tile and masked at the store. A block of 4 warps owns 128 columns of N
// (32 a warp) by BC = 8, 16, 32 or 64 columns of C, for one expert, and
// walks K in stages of 64: 16-byte cp.async.cg copies of the (64, 128) w
// tile and the (BC, 64) x tile into a ring of 4 stages in dynamic shared
// memory (68 KB at BC = 8, 96 KB at 64), so three stages, 48 KB of w, are
// in flight per block while the fourth is multiplied. Operands stay bf16
// in shared memory, their 16-byte chunks swizzled by XOR with the row's low
// three bits so that ldmatrix's eight rows hit eight bank groups; w, stored
// (K, N) with N contiguous, feeds the A fragments through ldmatrix.trans,
// x, (C, K) with K contiguous, the B fragments through plain ldmatrix.
// Edges past K, N or C are zero-filled by the copies (a 0-byte source).
// The float32 sums are rounded once to bf16, staged through shared memory
// and stored 16 bytes a thread.
//
// moe_gemm_kernel_fma, every other call (float32, any C, K and N, or
// misaligned bf16): a tiled kernel over (N tile, C tile, expert), 256
// threads, each owning TM x 4 outputs of a (16 TM) x 64 tile, K staged 32
// at a time in shared memory as float32 with the next tile prefetched into
// registers, FMA on CUDA cores (TF32 would not hold float32's 1e-4).
//
// What bounds it: on the serving path (deepseek-moe-16b: E 64, K 2048 and
// N 1408, or K 1408 and N 2048, bf16) every launch reads the whole 369 MB
// of its expert weights: 110 us at 3.35 TB/s, at decode (C = 8) and at
// prefill (C = 60, 22 GFLOP, 22 us at the bf16 tensor-core peak) alike.
// The grid, 11 or 16 N tiles by 64 experts (704 or 1024 blocks, two or
// three resident on each of the 132 SMs), keeps far more than the ~25 KB a
// SM needs in flight to stream at that rate. It launches 81 times per
// prefill and per decode step (three products in each of 27 MoE layers).
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

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x2;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- the general kernel: CUDA cores ---------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaBN = 64;
constexpr int kFmaBK = 32;

// TM rows per thread: the tile is BM = 16 * TM rows by kFmaBN columns.
template <typename T, int TM>
__global__ void __launch_bounds__(kFmaThreads)
moe_gemm_kernel_fma(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int C, int K, int N) {
  constexpr int BM = 16 * TM;
  constexpr int XPT = BM * kFmaBK / kFmaThreads;   // x elements a thread stages
  constexpr int WPT = kFmaBK * kFmaBN / kFmaThreads;  // w elements
  __shared__ float xs[kFmaBK][BM + 1];
  __shared__ float ws[kFmaBK][kFmaBN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kFmaBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xe = x + (int64_t)e * C * K;
  const T* we = w + (int64_t)e * K * N;

  float xr[XPT], wr[WPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < XPT; ++l) {
      const int idx = tid + l * kFmaThreads;
      const int i = idx / kFmaBK, kk = idx % kFmaBK;
      const int gm = m0 + i, gk = k0 + kk;
      xr[l] = (gm < C && gk < K) ? to_f32(xe[(int64_t)gm * K + gk]) : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < WPT; ++l) {
      const int idx = tid + l * kFmaThreads;
      const int kk = idx / kFmaBN, j = idx % kFmaBN;
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
  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
#pragma unroll
    for (int l = 0; l < XPT; ++l) {
      const int idx = tid + l * kFmaThreads;
      xs[idx % kFmaBK][idx / kFmaBK] = xr[l];
    }
#pragma unroll
    for (int l = 0; l < WPT; ++l) {
      const int idx = tid + l * kFmaThreads;
      ws[idx / kFmaBN][idx % kFmaBN] = wr[l];
    }
    __syncthreads();
    if (k0 + kFmaBK < K) load(k0 + kFmaBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
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
int launch_fma(const void* x, const void* w, void* out, int E, int C, int K,
               int N, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kFmaBN - 1) / kFmaBN),
                  (unsigned)((C + 16 * TM - 1) / (16 * TM)), (unsigned)E);
  moe_gemm_kernel_fma<T, TM><<<grid, kFmaThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)out, C, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fma(const void* x, const void* w, void* out, int E, int C,
                 int K, int N, cudaStream_t stream) {
  if (C <= 16) return launch_fma<T, 1>(x, w, out, E, C, K, N, stream);
  return launch_fma<T, 4>(x, w, out, E, C, K, N, stream);
}

// ---- the tensor-core kernel: bf16 mma.sync fed by cp.async -----------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;   // 4 warps, 32 columns of N each
constexpr int kBN = 128;           // columns of N a block owns
constexpr int kBK = 64;            // depth of one stage
constexpr int kStages = 4;
constexpr int kOutLd = kBN + 8;    // padded row of the staged output tile

// bf16 elements of one stage: the (kBK, kBN) w tile, then the (BC, kBK) x
// tile.
template <int BC>
__host__ __device__ constexpr int stage_elems() {
  return kBK * kBN + BC * kBK;
}
template <int BC>
__host__ __device__ constexpr int mma_smem_bytes() {
  return kStages * stage_elems<BC>() * (int)sizeof(bf16);
}

// Element offset of 16-byte chunk `ch` of row `row` in a tile of `ld`
// elements a row, the chunk swizzled by XOR with the row's low 3 bits.
__device__ __forceinline__ int swz(int row, int ch, int ld) {
  return row * ld + ((ch ^ (row & 7)) << 3);
}

// BC columns of C a block owns: 8, 16, 32 or 64.
template <int BC>
__global__ void __launch_bounds__(kMmaThreads)
moe_gemm_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ out, int C, int K, int N) {
  constexpr int NT = BC / 8;   // MMA n-tiles (8 columns of C each)
  extern __shared__ __align__(16) bf16 smem[];
  const int e = blockIdx.z;
  const int n0 = blockIdx.x * kBN, c0 = blockIdx.y * BC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* xe = x + (int64_t)e * C * K;
  const bf16* we = w + (int64_t)e * K * N;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);

  auto w_tile = [&](int slot) {
    return base + slot * stage_elems<BC>() * (int)sizeof(bf16);
  };
  auto x_tile = [&](int slot) {
    return w_tile(slot) + kBK * kBN * (int)sizeof(bf16);
  };

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kBK;
    const uint32_t ws = w_tile(slot), xs = x_tile(slot);
#pragma unroll
    for (int i = 0; i < kBK * kBN / 8 / kMmaThreads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int k = idx / (kBN / 8), ch = idx % (kBN / 8);
      const int gk = k0 + k, gn = n0 + ch * 8;
      const bool ok = gk < K && gn < N;
      cp_async16(ws + swz(k, ch, kBN) * 2,
                 ok ? we + (int64_t)gk * N + gn : we, ok);
    }
    for (int idx = tid; idx < BC * kBK / 8; idx += kMmaThreads) {
      const int c = idx / (kBK / 8), ch = idx % (kBK / 8);
      const int gc = c0 + c, gk = k0 + ch * 8;
      const bool ok = gc < C && gk < K;
      cp_async16(xs + swz(c, ch, kBK) * 2,
                 ok ? xe + (int64_t)gc * K + gk : xe, ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // ldmatrix: lanes 8j..8j+7 give the rows of the j-th 8 x 8 matrix
  const int mj = lane >> 3, mr = lane & 7;
  auto compute = [&](int slot) {
    const uint32_t ws = w_tile(slot), xs = x_tile(slot);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // A = w^T: matrices (n 0-7, k 0-7), (n 8-15, k 0-7), (n 0-7, k 8-15),
      // (n 8-15, k 8-15), each from 8 rows k of the (k, n) tile, transposed
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int k = ks * 16 + (mj >> 1) * 8 + mr;
        const int n = warp * 32 + mt * 16 + (mj & 1) * 8;
        ldmatrix_x4_trans(a[mt], ws + swz(k, n >> 3, kBN) * 2);
      }
      // B = x^T: matrices (c 0-7, k 0-7), (c 0-7, k 8-15), then c 8-15
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        const int k = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x2(b[0], xs + swz(mr, k >> 3, kBK) * 2);
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const int c = p * 16 + (mj >> 1) * 8 + mr;
          const int k = ks * 16 + (mj & 1) * 8;
          uint32_t r[4];
          ldmatrix_x4(r, xs + swz(c, k >> 3, kBK) * 2);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  };

  // the ring: stage kt + kStages - 1 is copied while stage kt is multiplied
  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();   // stage kt has landed
    __syncthreads();                // and every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();
    compute(kt % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: round once, stage the (BC, kBN) tile, store 16 bytes a thread
  bf16* tile = smem;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = warp * 32 + mt * 16 + g, c = nt * 8 + 2 * t4;
      tile[c * kOutLd + n] = __float2bfloat16_rn(acc[mt][nt][0]);
      tile[(c + 1) * kOutLd + n] = __float2bfloat16_rn(acc[mt][nt][1]);
      tile[c * kOutLd + n + 8] = __float2bfloat16_rn(acc[mt][nt][2]);
      tile[(c + 1) * kOutLd + n + 8] = __float2bfloat16_rn(acc[mt][nt][3]);
    }
  __syncthreads();
  bf16* oe = out + (int64_t)e * C * N;
  for (int idx = tid; idx < BC * kBN / 8; idx += kMmaThreads) {
    const int c = idx / (kBN / 8), ch = idx % (kBN / 8);
    const int gc = c0 + c, gn = n0 + ch * 8;
    if (gc < C && gn < N)
      *reinterpret_cast<uint4*>(oe + (int64_t)gc * N + gn) =
          *reinterpret_cast<const uint4*>(tile + c * kOutLd + ch * 8);
  }
}

template <int BC>
int launch_mma(const void* x, const void* w, void* out, int E, int C, int K,
               int N, int device, cudaStream_t stream) {
  static_assert(BC * kOutLd <= kStages * stage_elems<BC>(),
                "the output tile reuses the ring");
  constexpr int smem = mma_smem_bytes<BC>();
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(moe_gemm_kernel_mma<BC>, smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + kBN - 1) / kBN),
                  (unsigned)((C + BC - 1) / BC), (unsigned)E);
  moe_gemm_kernel_mma<BC><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)out, C, K, N);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* x, const void* w, void* out, int E, int C,
                 int K, int N, int device, cudaStream_t stream) {
  if (C <= 8) return launch_mma<8>(x, w, out, E, C, K, N, device, stream);
  if (C <= 16) return launch_mma<16>(x, w, out, E, C, K, N, device, stream);
  if (C <= 32) return launch_mma<32>(x, w, out, E, C, K, N, device, stream);
  return launch_mma<64>(x, w, out, E, C, K, N, device, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). tensor_cores:
// 1 runs moe_gemm_kernel_mma, which takes bf16 only, K and N multiples of 8
// and 16-byte aligned pointers (anything else is refused, not rerouted);
// 0 runs moe_gemm_kernel_fma. Launches on `device`'s `stream` without
// synchronising; returns cudaGetLastError().
int repro_moe_gemm(const void* x, const void* w, void* out, int E, int C,
                   int K, int N, int dtype, int tensor_cores, int device,
                   void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || K <= 0 || N <= 0 ||
      (C + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = (cudaStream_t)stream;
  if (tensor_cores) {
    if (dtype != 1 || K % 8 != 0 || N % 8 != 0 ||
        ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return dispatch_mma(x, w, out, E, C, K, N, device, s);
  }
  if (dtype == 0) return dispatch_fma<float>(x, w, out, E, C, K, N, s);
  if (dtype == 1) return dispatch_fma<bf16>(x, w, out, E, C, K, N, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

REPRO_PY_MODULE(moe_gemm, repro_moe_gemm)
