// FCFS prefix serialization of independent queues (one wavefront step of
// the GA prefilter's batched fitness), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/wavefront.py:serialize_prefix (_serialize_kernel). Each row
// is one FCFS queue of W ordered items. With S = inclusive cumsum(d):
//
//     fin[k]   = S[k] + max(free0, max_{j<=k} (r[j] - (S[j] - d[j])))
//     new_free = fin[W-1]
//
// An item that is not on the queue has d = 0 and r = -1e30, so it leaves the
// queue state as it was.
//
// Design: one warp per row. Lane i holds item t*32+i of tile t. Two
// inclusive warp-shuffle scans (__shfl_up_sync, offsets 1..16) give the sum
// and then the max; a carry of the running sum and the running max crosses
// tiles, so any W works. The sum scan adds in the same shift-doubling order
// as the plain version (repro_torch/kernels/ref.py:prefix_sum), so for
// W <= 32 the two agree bit for bit; above 32 the carry re-associates the
// float32 sum.
//
// Inputs are contiguous (rows, W) row-major float32; the Python wrapper
// (repro_torch/kernels/wavefront.py) checks that and lays the population-
// last tensors out so before the launch.
//
// What bounds it: it moves about 12 bytes per item (read r and d, write fin)
// plus 8 per row. At the main path's 1280 x 17 that is about 0.27 MB, which
// the card's 3.35 TB/s moves in under 0.1 us, so each launch is bound by
// launch latency, far below the memory rate. Fusing a whole wavefront step,
// or the whole scan over wavefronts, into one persistent kernel or a CUDA
// graph is later work.
//
// A C launcher, called from Python through the extension module that
// csrc/launch.cuh makes of the library: it returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void serialize_prefix_kernel(const float* __restrict__ free0,
                                        const float* __restrict__ release,
                                        const float* __restrict__ dur,
                                        float* __restrict__ fin,
                                        float* __restrict__ new_free,
                                        int64_t rows, int w) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const float* r_row = release + row * w;
  const float* d_row = dur + row * w;
  float* f_row = fin + row * w;

  float carry_s = 0.0f;         // sum of d over earlier tiles
  float carry_m = free0[row];   // max(free0, g over earlier tiles)
  float last = carry_m;
  for (int base = 0; base < w; base += kWarp) {
    const int k = base + lane;
    const bool in = k < w;
    const float d = in ? d_row[k] : 0.0f;
    const float r = in ? r_row[k] : kNeg;

    float s = d;  // inclusive prefix sum, shift-doubling order
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float up = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s = s + up;
    }
    if (base > 0) s = carry_s + s;

    float m = r - (s - d);  // inclusive prefix max of g
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float up = __shfl_up_sync(kFull, m, off);
      if (lane >= off) m = fmaxf(m, up);
    }
    const float run = fmaxf(m, carry_m);
    const float f = s + run;
    if (in) f_row[k] = f;

    const int tail = min(w - base, kWarp) - 1;  // last valid lane
    last = __shfl_sync(kFull, f, tail);
    carry_s = __shfl_sync(kFull, s, kWarp - 1);
    carry_m = __shfl_sync(kFull, run, kWarp - 1);
  }
  if (lane == 0) new_free[row] = last;
}

}  // namespace

extern "C" {

// Launches on `device`'s `stream` without synchronising; returns
// cudaGetLastError().
int repro_serialize_prefix_f32(const float* free0, const float* release,
                               const float* dur, float* fin, float* new_free,
                               int64_t rows, int w, int device, void* stream) {
  if (rows <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  serialize_prefix_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0,
                            (cudaStream_t)stream>>>(free0, release, dur, fin,
                                                    new_free, rows, w);
  return (int)cudaGetLastError();
}

}  // extern "C"

REPRO_PY_MODULE(wavefront, repro_serialize_prefix_f32)
