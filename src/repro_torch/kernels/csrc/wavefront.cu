// The GA prefilter's FCFS wavefront scan, for Hopper (sm_90a): two kernels.
//
// serialize_prefix_kernel replaces the JAX package's Pallas kernel
// repro/kernels/wavefront.py:serialize_prefix (_serialize_kernel): one
// wavefront's FCFS queues, each row W ordered items. With S = inclusive
// cumsum(d):
//
//     fin[k]   = S[k] + max(free0, max_{j<=k} (r[j] - (S[j] - d[j])))
//     new_free = fin[W-1]
//
// An item that is not on the queue has d = 0 and r = -1e30, so it leaves the
// queue state as it was. One warp per row; lane i holds item t*32+i of tile
// t, a carry of the running sum and max crosses tiles, so any W works. It
// serves the "step" route: a Python loop over wavefronts with one launch
// per queue update (repro_torch/core/vectorized.py).
//
// wavefront_scan_kernel replaces that Pallas kernel together with the jitted
// lax.scan over wavefronts around it (repro/core/vectorized.py:
// BatchedFitness._score): it runs the whole scan of a chunk of genomes in
// one launch, the "fused" route. Its plain version is
// repro_torch/kernels/ref.py:wavefront_scan_ref with serialize_prefix_ref.
//
// Both add in the plain version's shift-doubling order (warp_prefix_sum:
// __shfl_up_sync at offsets 1..16, the order of ref.py:prefix_sum), so at
// W <= 32 they agree with it bit for bit; every other operation of the scan
// is a max, or one float32 add, subtract, multiply or divide rounded as the
// plain version rounds it (__fadd_rn and kin, so that no product and sum
// contract into an FMA), and the spill sum over cores runs in index order.
//
// What bounds wavefront_scan. Its bytes: a genome's hoisted inputs (cycles,
// core, crossing flags, channel occupancy and spill bytes of each wavefront
// slot, about 36 KB at resnet18 x MC:Hetero, tile 32) read once, and finish
// and spilled per CN written once: about 10 MB for a chunk of 256 genomes,
// 3 us at 3.35 TB/s. Its operations are fewer. Neither sees what bounds it:
// each genome is a chain of 72 dependent wavefronts, each of which reads
// the previous ones' finish times, serializes every core and channel queue
// and updates the memory model.
//
// What the design does about that. A block per genome, so genomes run side
// by side on the 132 SMs with no traffic between blocks; the genome's state
// (finish, spilled per CN, segment frontiers, queue free times, occupancy)
// stays in shared memory for the whole scan, and is written out once at the
// end. Warps are queues, lanes are a wavefront's slots, and a wavefront
// takes two phases, each ended by __syncthreads. Phase 1 does all that does
// not wait on the wavefront's queues, side by side: a warp per channel
// gathers the predecessors' finish times and serializes its channel; one
// warp updates the spill model; one takes the exclusive prefix max of the
// segment frontiers and forms each slot's barrier and DRAM floor. Phase 2
// serializes the core queues, a warp per core, and the lane of the core that
// serves a slot writes its finish time and raises its segment's frontier.
// The inputs of the next three wavefronts stream into a ring of shared-
// memory stages with cp.async while the current one computes, so no phase
// waits on device memory: the wrapper packs them as two records a
// wavefront, the genome's and the static one, each contiguous and padded
// to 16 bytes, so a stage is at most one or two 16-byte copies a thread.
// The segment cut over layers runs first, in one thread, while the first
// stages load.
//
// Measured on an H100 (PERF.md): issuing the copies word by word
// from every thread, a warp's instructions on the critical path, cost more
// than the copies' latency; the records cut a 256-genome chunk of resnet18
// from 153 to 108 us. Phase 1's warps now take 1200-1400 cycles a
// wavefront and phase 2's 1000, about twice what their dependent shared
// memory and shuffle latencies add up to. Tried and slower: the gathers
// split over warps with a named barrier.
//
// C launchers, called from Python through the extension module that
// csrc/launch.cuh makes of the library: each returns cudaGetLastError() and
// the wrapper raises when it is not cudaSuccess.

// launch.cuh includes Python.h, which comes before the standard headers
#include "launch.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxWarps = 16;
constexpr int kStages = 4;               // kernels/wavefront.py: STAGES
constexpr int kSmemMax = 232448;         // bytes a Hopper block may use
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive prefix sum over the warp's lanes, shift-doubling order.
__device__ __forceinline__ float warp_prefix_sum(float s, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const float up = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s = __fadd_rn(s, up);
  }
  return s;
}

// Inclusive prefix max over the warp's lanes.
__device__ __forceinline__ float warp_prefix_max(float m, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const float up = __shfl_up_sync(kFull, m, off);
    if (lane >= off) m = fmaxf(m, up);
  }
  return m;
}

// One FCFS queue of at most 32 slots, lane = slot: this lane's finish. The
// queue's new free time is the last slot's finish. Lanes past the queue's
// slots pass r = -1e30, d = 0.
__device__ __forceinline__ float serialize_warp(float free0, float r, float d,
                                                int lane) {
  const float s = warp_prefix_sum(d, lane);
  const float m = warp_prefix_max(__fsub_rn(r, __fsub_rn(s, d)), lane);
  return __fadd_rn(s, fmaxf(m, free0));
}

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

    float s = warp_prefix_sum(d, lane);
    if (base > 0) s = __fadd_rn(carry_s, s);
    const float m = warp_prefix_max(__fsub_rn(r, __fsub_rn(s, d)), lane);
    const float run = fmaxf(m, carry_m);
    const float f = __fadd_rn(s, run);
    if (in) f_row[k] = f;

    const int tail = min(w - base, kWarp) - 1;  // last valid lane
    last = __shfl_sync(kFull, f, tail);
    carry_s = __shfl_sync(kFull, s, kWarp - 1);
    carry_m = __shfl_sync(kFull, run, kWarp - 1);
  }
  if (lane == 0) new_free[row] = last;
}

// ---- wavefront_scan --------------------------------------------------------

struct ScanArgs {
  const int* genomes;     // (P, G) core of each layer
  const float* rec;       // (P, L, R) a genome's record of each wavefront
  const float* srec;      // (L, S) a wavefront's static record
  const float* act_cap;   // (C,)
  const float* layer_wb;  // (G,)
  const float* w_cap;     // (C,)
  // population-last outputs
  float* finish;          // (n + 1, P)
  float* core_free;       // (C, P)
  float* chan_free;       // (max(H, 1), P)
  float* dram_free;       // (P,)
  float* spilled;         // (n + 1, P)
  float* dram_x;          // (P,)
  int p, n, levels, width, dmax, n_cores, n_chan, n_seg;
  bool comm, spills;
  int segment;            // 0 greedy cut, 1 a segment per layer, 2 none
};

__host__ __device__ constexpr int round4(int words) {
  return (words + 3) & ~3;
}

// The records, in 4-byte words (kernels/wavefront.py:record_layout mirrors
// them). A genome's record of one wavefront: each slot's cycles and core;
// with the spill model its allocated bytes and memory core, and each core's
// allocated and freed bytes; with channel transfers each channel's
// occupancy of each slot and the (W, D) crossing flags as bytes. The static
// record of a wavefront: each slot's CN (n for a pad slot), layer and DRAM
// end offset, the DRAM port's busy time, and each slot's predecessors.
// Each record is padded to 16 bytes, the unit of its copies.
struct RecordLayout {
  int cyc, cw, aw, mw, ac, fc, occ, cross, words;       // genome record
  int wf, wl, dram, tot, pu, static_words;              // static record
};

__host__ __device__ inline RecordLayout record_layout(int W, int C, int H,
                                                      int D, bool comm,
                                                      bool spills) {
  RecordLayout r;
  int t = 0;
  r.cyc = t;   t += W;
  r.cw = t;    t += W;
  r.aw = t;    t += spills ? W : 0;
  r.mw = t;    t += spills ? W : 0;
  r.ac = t;    t += spills ? C : 0;
  r.fc = t;    t += spills ? C : 0;
  r.occ = t;   t += comm ? H * W : 0;
  r.cross = t; t += comm ? (W * D + 3) / 4 : 0;
  r.words = round4(t);
  t = 0;
  r.wf = t;    t += W;
  r.wl = t;    t += W;
  r.dram = t;  t += W;
  r.tot = t;   t += 1;
  r.pu = t;    t += W * D;
  r.static_words = round4(t);
  return r;
}

// Warps of a block (kernels/wavefront.py:warps): a warp per core queue,
// and two beyond the channel queues' warps, one for the spill model and
// one for the barrier.
__host__ __device__ constexpr int scan_warps(int C, int H) {
  int w = C > H + 2 ? C : H + 2;
  w = w < 3 ? 3 : w;
  return w > kMaxWarps ? kMaxWarps : w;
}

// Offsets, in 4-byte words, of a block's shared memory: the genome's state,
// then a ring of kStages stages, each a genome record and a static record.
// kernels/wavefront.py:smem_bytes mirrors the total.
struct ScanLayout {
  int finish, spilled, front, ex, seg, gen, lwb;        // per CN, per layer
  int core_free, used, accw, frac, over, cap, wcap;     // per core
  int chan_free, base, finch, pre, scal;
  int stage, stage_words;
  RecordLayout r;
  int words;
};

__host__ __device__ inline ScanLayout scan_layout(int n, int W, int C, int H,
                                                  int G, int D, bool comm,
                                                  bool spills) {
  ScanLayout s;
  int o = 0;
  s.finish = o;    o += n + 1;
  s.spilled = o;   o += n + 1;
  s.front = o;     o += G;
  s.ex = o;        o += G;
  s.seg = o;       o += G;
  s.gen = o;       o += G;
  s.lwb = o;       o += G;
  s.core_free = o; o += C;
  s.used = o;      o += C;
  s.accw = o;      o += C;
  s.frac = o;      o += C;
  s.over = o;      o += C;
  s.cap = o;       o += C;
  s.wcap = o;      o += C;
  s.chan_free = o; o += H > 1 ? H : 1;
  s.base = o;      o += kWarp;
  s.finch = o;     o += kWarp * H;
  s.pre = o;       o += kWarp;
  s.scal = o;      o += 2;             // dram_free, dram_x
  s.stage = round4(o);
  s.r = record_layout(W, C, H, D, comm, spills);
  s.stage_words = s.r.words + s.r.static_words;
  s.words = s.stage + kStages * s.stage_words;
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `N` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of wavefront `lv`'s two records into `stage`: 16 bytes a
// thread, at most one or two copies each.
__device__ __forceinline__ void load_stage(const ScanArgs& a,
                                           const ScanLayout& L,
                                           float* stage, int p, int lv,
                                           int tid, int nthr) {
  const int R = L.r.words, S = L.r.static_words;
  const float* g = a.rec + ((size_t)p * a.levels + lv) * R;
  const float* s = a.srec + (size_t)lv * S;
  for (int i = 4 * tid; i < R; i += 4 * nthr) cp_async16(stage + i, g + i);
  for (int i = 4 * tid; i < S; i += 4 * nthr)
    cp_async16(stage + R + i, s + i);
}

__global__ void __launch_bounds__(kMaxWarps * kWarp)
    wavefront_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int W = a.width, D = a.dmax, C = a.n_cores, H = a.n_chan,
            G = a.n_seg, N = a.n;
  const ScanLayout L = scan_layout(N, W, C, H, G, D, a.comm, a.spills);
  const RecordLayout& R = L.r;
  const int p = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & (kWarp - 1), warp = tid >> 5, nw = nthr >> 5;
  float* s_finish = smem + L.finish;
  float* s_spilled = smem + L.spilled;
  float* s_front = smem + L.front;      // segment frontiers (max finish)
  float* s_ex = smem + L.ex;            // their exclusive prefix max
  int* s_seg = reinterpret_cast<int*>(smem + L.seg);   // segment of layer
  int* s_gen = reinterpret_cast<int*>(smem + L.gen);   // core of layer
  float* s_lwb = smem + L.lwb;
  float* s_core_free = smem + L.core_free;
  float* s_used = smem + L.used;
  float* s_accw = smem + L.accw;
  float* s_frac = smem + L.frac;
  float* s_over = smem + L.over;
  float* s_cap = smem + L.cap;
  float* s_wcap = smem + L.wcap;
  float* s_chan_free = smem + L.chan_free;
  float* s_base = smem + L.base;        // data-ready floor of each slot
  float* s_finch = smem + L.finch;      // (H, 32) channel finishes
  float* s_pre = smem + L.pre;          // DRAM and barrier floor of a slot
  float* s_scal = smem + L.scal;        // dram_free, dram_x

  // the first wavefronts' inputs load while the state is set up; one
  // commit group a stage, also when it is empty
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < a.levels)
      load_stage(a, L, smem + L.stage + s * L.stage_words, p, s, tid, nthr);
    cp_async_commit();
  }
  for (int i = tid; i <= N; i += nthr) {
    s_finish[i] = 0.0f;
    s_spilled[i] = 0.0f;
  }
  for (int i = tid; i < G; i += nthr) {
    s_front[i] = 0.0f;
    s_gen[i] = a.genomes[(size_t)p * G + i];
    s_lwb[i] = a.layer_wb[i];
  }
  for (int i = tid; i < C; i += nthr) {
    s_core_free[i] = 0.0f;
    s_used[i] = 0.0f;
    s_accw[i] = 0.0f;
    s_cap[i] = a.act_cap[i];
    s_wcap[i] = a.w_cap[i];
  }
  for (int i = tid; i < (H > 1 ? H : 1); i += nthr) s_chan_free[i] = 0.0f;
  if (tid < 2) s_scal[tid] = 0.0f;
  __syncthreads();

  // fused-stack segments of the genome's layers (ref.py:segments_ref)
  if (a.segment == 0) {
    if (tid == 0) {
      int seg = 0;
      for (int l = 0; l < G; ++l) {
        const int core = s_gen[l];
        const float wb = s_lwb[l], cap = s_wcap[core];
        const float hold = fminf(wb, cap);
        const float held = s_accw[core];
        const bool active = wb > 0.0f && cap > 0.0f;
        if (active && __fadd_rn(held, hold) > cap && held > 0.0f) {
          ++seg;
          for (int c = 0; c < C; ++c) s_accw[c] = 0.0f;
        }
        s_accw[core] = __fadd_rn(s_accw[core], active ? hold : 0.0f);
        s_seg[l] = seg;
      }
    }
  } else {
    for (int l = tid; l < G; l += nthr) s_seg[l] = a.segment == 1 ? l : 0;
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  const bool slot = lane < W;
  for (int lv = 0; lv < a.levels; ++lv) {
    const float* st = smem + L.stage + (lv % kStages) * L.stage_words;
    const float* ss = st + R.words;     // the static record
    const int ahead = lv + kStages - 1;
    if (ahead < a.levels)
      load_stage(a, L, smem + L.stage + (ahead % kStages) * L.stage_words, p,
                 ahead, tid, nthr);
    cp_async_commit();
    const int* st_wf = reinterpret_cast<const int*>(ss + R.wf);
    const int* st_wl = reinterpret_cast<const int*>(ss + R.wl);

    // phase 1: what does not wait on this wavefront's queues
    if (warp == nw - 1) {
      // the fused-stack barrier (exclusive prefix max of the frontiers)
      // and the DRAM port's end offset: each slot's floor
      float carry = kNeg;
      for (int b = 0; b < G; b += kWarp) {
        const int s = b + lane;
        const float v = warp_prefix_max(s < G ? s_front[s] : kNeg, lane);
        float prev = __shfl_up_sync(kFull, v, 1);
        if (lane == 0) prev = kNeg;
        if (s < G) s_ex[s] = fmaxf(prev, carry);
        carry = fmaxf(carry, __shfl_sync(kFull, v, kWarp - 1));
      }
      __syncwarp();
      if (slot)
        s_pre[lane] = fmaxf(__fadd_rn(s_scal[0], ss[R.dram + lane]),
                            s_ex[s_seg[st_wl[lane]]]);
    } else if (warp == nw - 2) {
      // activation memory: overflow beyond each core's capacity spills
      if (a.spills) {
        for (int c = lane; c < C; c += kWarp) {
          const float alloc = st[R.ac + c], cap = s_cap[c];
          const float t = __fadd_rn(s_used[c], alloc);
          const float over = fminf(fmaxf(__fsub_rn(t, cap), 0.0f), alloc);
          s_over[c] = over;
          // a zero over any divisor is that zero: skip the divide
          s_frac[c] = over > 0.0f ? __fdiv_rn(over, fmaxf(alloc, 1.0f)) : over;
          s_used[c] = fmaxf(
              __fsub_rn(fminf(__fsub_rn(t, over), cap), st[R.fc + c]),
              0.0f);
        }
        __syncwarp();
        const int* st_mw = reinterpret_cast<const int*>(st + R.mw);
        if (slot && st_wf[lane] < N)
          s_spilled[st_wf[lane]] =
              __fmul_rn(st[R.aw + lane], s_frac[st_mw[lane]]);
        if (lane == 0) {
          float sum = s_over[0];    // in index order, as the plain sum
#pragma unroll 4
          for (int c = 1; c < C; ++c) sum = __fadd_rn(sum, s_over[c]);
          s_scal[1] = __fadd_rn(s_scal[1], sum);
        }
      }
    } else if (a.comm ? warp < H : warp == 0) {
      // max finish of the same-core predecessors (the data-ready floor)
      // and of the crossing ones (the release of the slot's transfers),
      // then the channel queues
      const int* st_pu = reinterpret_cast<const int*>(ss + R.pu) + lane * D;
      const uint8_t* st_cross =
          reinterpret_cast<const uint8_t*>(st + R.cross) + lane * D;
      float mb = kNeg, mr = kNeg;
      if (slot) {
        // eight predecessors at a time, their loads issued together
        for (int d0 = 0; d0 < D; d0 += 8) {
          float pf[8];
          bool cross[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool in = d0 + j < D;
            pf[j] = in ? s_finish[st_pu[d0 + j]] : kNeg;
            cross[j] = in && a.comm && st_cross[d0 + j];
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (cross[j])
              mr = fmaxf(mr, pf[j]);
            else
              mb = fmaxf(mb, pf[j]);
          }
        }
      }
      if (warp == 0) s_base[lane] = D > 0 ? fmaxf(mb, 0.0f) : 0.0f;
      if (a.comm) {
        const float* st_occ = st + R.occ;
        for (int ch = warp; ch < H; ch += nw - 2) {
          const float occ = slot ? st_occ[ch * W + lane] : 0.0f;
          const float fin = serialize_warp(
              s_chan_free[ch], occ > 0.0f ? mr : kNeg, occ, lane);
          s_finch[ch * kWarp + lane] = occ > 0.0f ? fin : kNeg;
          const float last = __shfl_sync(kFull, fin, W - 1);
          if (lane == 0) s_chan_free[ch] = last;
        }
      }
    }
    __syncthreads();

    // phase 2: the core queues; each slot's finish time and its segment's
    // frontier are written by the lane of the core that serves it
    if (warp < C) {
      float ready = kNeg, cyc = 0.0f;
      int core = -1, wf = N, seg = 0;
      if (slot) {
        float dr = s_base[lane];
        if (a.comm) {
          float arr = s_finch[lane];
          for (int ch = 1; ch < H; ++ch)
            arr = fmaxf(arr, s_finch[ch * kWarp + lane]);
          dr = fmaxf(dr, arr);
        }
        ready = fmaxf(dr, s_pre[lane]);
        core = reinterpret_cast<const int*>(st + R.cw)[lane];
        cyc = st[R.cyc + lane];
        wf = st_wf[lane];
        seg = s_seg[st_wl[lane]];
      }
      const bool member = wf < N;
      for (int c = warp; c < C; c += nw) {
        const bool on = member && core == c;
        const float fin = serialize_warp(s_core_free[c], on ? ready : kNeg,
                                         on ? cyc : 0.0f, lane);
        if (on) {
          s_finish[wf] = fin;
          // finish times are >= +0, where float order is int order
          atomicMax(reinterpret_cast<int*>(s_front + seg),
                    __float_as_int(fin));
        }
        const float last = __shfl_sync(kFull, fin, W - 1);
        if (lane == 0) s_core_free[c] = last;
      }
    }
    if (tid == 0) s_scal[0] = __fadd_rn(s_scal[0], ss[R.tot]);
    cp_async_wait<kStages - 2>();
    __syncthreads();
  }

  const size_t P = (size_t)a.p;
  for (int v = tid; v <= N; v += nthr) {
    a.finish[v * P + p] = s_finish[v];
    a.spilled[v * P + p] = s_spilled[v];
  }
  for (int c = tid; c < C; c += nthr) a.core_free[c * P + p] = s_core_free[c];
  for (int h = tid; h < (H > 1 ? H : 1); h += nthr)
    a.chan_free[h * P + p] = s_chan_free[h];
  if (tid == 0) {
    a.dram_free[p] = s_scal[0];
    a.dram_x[p] = s_scal[1];
  }
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

// Shared memory bytes of one wavefront_scan block; `flags` as below.
int repro_wavefront_scan_smem_bytes(int n, int width, int n_cores,
                                    int n_chan, int n_seg, int dmax,
                                    int flags) {
  return 4 * scan_layout(n, width, n_cores, n_chan, n_seg, dmax, flags & 1,
                         flags & 2)
                 .words;
}

// Words of the genome record (`which` 0) or the static record (1).
int repro_wavefront_scan_record_words(int width, int n_cores, int n_chan,
                                      int dmax, int flags, int which) {
  const RecordLayout r =
      record_layout(width, n_cores, n_chan, dmax, flags & 1, flags & 2);
  return which ? r.static_words : r.words;
}

// The scan of `p` genomes, a block each. `flags`: bit 0 channel transfers,
// bit 1 the spill model, bits 2-3 the segment mode (0 greedy, 1 strict, 2
// none). `rec_words` and `static_words` are the records' lengths as the
// caller laid them out, checked against this file's layout. Launches on
// `device`'s `stream` without synchronising; returns cudaGetLastError().
int repro_wavefront_scan_f32(
    const int* genomes, const float* rec, const float* srec,
    const float* act_cap, const float* layer_wb, const float* w_cap,
    float* finish, float* core_free, float* chan_free, float* dram_free,
    float* spilled, float* dram_x, int p, int n, int levels, int width,
    int dmax, int n_cores, int n_chan, int n_seg, int rec_words,
    int static_words, int flags, int device, void* stream) {
  const bool comm = flags & 1, spills = flags & 2;
  const int segment = (flags >> 2) & 3;
  if (p <= 0 || n < 0 || levels < 0 || width < 1 || width > kWarp ||
      dmax < 0 || n_cores < 1 || n_chan < 0 || n_seg < 1 || segment > 2 ||
      (comm && (n_chan < 1 || dmax < 1)))
    return (int)cudaErrorInvalidValue;
  const RecordLayout r =
      record_layout(width, n_cores, n_chan, dmax, comm, spills);
  if (r.words != rec_words || r.static_words != static_words ||
      ((size_t)rec | (size_t)srec) % 16)
    return (int)cudaErrorInvalidValue;
  const int bytes = repro_wavefront_scan_smem_bytes(
      n, width, n_cores, n_chan, n_seg, dmax, flags);
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  repro::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  static repro::SmemLimit limit;
  cudaError_t err = limit.ensure(wavefront_scan_kernel, bytes, device);
  if (err != cudaSuccess) return (int)err;
  const int nw = scan_warps(n_cores, n_chan);
  const ScanArgs a{genomes,   rec,     srec,    act_cap, layer_wb, w_cap,
                   finish,    core_free, chan_free, dram_free, spilled,
                   dram_x,    p,       n,       levels,  width,    dmax,
                   n_cores,   n_chan,  n_seg,   comm,    spills,   segment};
  wavefront_scan_kernel<<<p, nw * kWarp, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

REPRO_PY_ALSO(launch_scan, repro_wavefront_scan_f32)
REPRO_PY_ALSO(scan_smem_bytes, repro_wavefront_scan_smem_bytes)
REPRO_PY_ALSO(scan_record_words, repro_wavefront_scan_record_words)
REPRO_PY_MODULE(wavefront, repro_serialize_prefix_f32)
