// K1: fused segment sum and maximum for the PhaseStack reductions.
//
// Replaces the Pallas kernel `_fused_segreduce_kernel` in
// src/repro/kernels/comm_stack.py (built by `_pallas_segreduce`, entry
// `fused_segment_reduce`).  On the TPU the grid runs in order on one core,
// so that kernel streams 512-message chunks through a lane-padded output row
// that stays resident in VMEM across the grid.  On Hopper the blocks run in
// parallel and in no order, so the same effect comes from privatising the
// sums within a block: each block folds its messages into bins in shared
// memory and flushes every touched bin to global memory with one atomic.
//
// Contract (the same as the TPU kernel's): sums[s] = sum of values[k] with
// ids[k] == s; maxs[s] = their maximum; an empty segment reports sum 0 and
// max 0.  Ids may come in any order.  The order of the atomic additions
// changes from run to run, so the sums are float32-allclose to a sequential
// sum, never bit-equal; the maxima are exact.
//
// Bound: bytes.  Each message is read once (4-byte value, 4-byte id) and the
// outputs are 8 bytes per segment: at 3.35 TB/s a 2M-message reduction is
// bounded near 5 us.  The first kernel issued two global atomics a message,
// which serialise in L2 when many messages share a segment (1.92 M messages
// on 46 segments took 2.5 ms on an H100 at 700 W).  This one cuts the
// atomics three ways:
//
// 1. Loads: a lane takes kItems consecutive messages in one 16-byte load of
//    values and one of ids (scalar loads at a ragged end or unaligned
//    pointers); a warp steps through a contiguous range 128 messages at a
//    time, and a block's 8 warps cover one contiguous chunk.
// 2. Runs: a lane folds equal consecutive ids into one partial (its head
//    run, its tail run, and complete runs between them, which it issues at
//    once).  A segmented shuffle scan joins the lanes' tail runs across the
//    warp: a lane starts a segment where its tail run does not continue the
//    previous lane's.  Only the lane where a run ends issues it, and the run
//    that reaches lane 31 is carried into the warp's next step.  Random ids
//    give runs of length 1; `phase_id`-like ids (long runs of one value)
//    give about one update per warp.
// 3. Bins: an update goes to the block's shared-memory bins (atomicAdd, and
//    atomicMax on an order-preserving unsigned encoding of the float), and
//    the block flushes only its touched bins.  On the smem path every
//    segment has a bin (n_seg <= kBinCap, chosen by the wrapper's mirror
//    `comm_stack.k1_path`).  On the global path (n_seg > kBinCap) a block
//    first finds the smallest and largest id of its chunk and bins that
//    window when it spans at most kBinCap ids; a block whose ids spread
//    wider sends its run updates straight to global atomics.
//
// The grid has at most kMaxBlocks blocks of at least kMinPerBlock messages
// (rounded to whole 1024-message block steps), so a block's flush (at most
// kBinCap atomics) costs no more than reading its messages.
//
// Maxima are kept as enc(v): the float's bits with the sign bit set for
// v >= 0, and all bits flipped for v < 0, so that the unsigned order is the
// float order and 0 lies below every encoded float (it would be a NaN's,
// and NaN inputs are outside the contract): an empty bin or segment is 0.
// One cudaMemsetAsync zeroes sums, encoded maxima and the block ticket
// together; the last block to finish (smem path) or a second kernel
// (global path) decodes the maxima in place, 0 to 0.0f.  A call is one
// memset and one launch on the smem path, two launches on the global path
// (the first kernel had three).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;              // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                  // messages a lane loads a step
constexpr int kWarpStep = 32 * kItems;     // 128 messages a warp step
constexpr int kBlockStep = kWarps * kWarpStep;
constexpr int kBinCap = 4096;              // shared bins a block (32 KB)
constexpr long long kMinPerBlock = 4096;
constexpr long long kMaxBlocks = 132LL * 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned enc(float v) {
  unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float dec(unsigned u) {
  if (u == 0u) return 0.0f;
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// One run's update: into the block's bin when `id` lies in its window
// [lo, lo + span), else straight into the global rows.  Ids < 0 mark the
// padding past a warp's range and are dropped.
__device__ __forceinline__ void put(int id, float s, unsigned m,
                                    float* bsum, unsigned* bmax, int lo,
                                    int span, float* sums, unsigned* maxs) {
  if (id < 0) return;
  int k = id - lo;
  if ((unsigned)k < (unsigned)span) {
    atomicAdd(bsum + k, s);
    atomicMax(bmax + k, m);
  } else {
    atomicAdd(sums + id, s);
    atomicMax(maxs + id, m);
  }
}

template <bool VEC>
__device__ __forceinline__ void load_items(const float* __restrict__ values,
                                           const int* __restrict__ ids,
                                           long long k0, long long end,
                                           float (&v)[kItems],
                                           int (&id)[kItems]) {
  if (VEC && k0 + kItems <= end) {
    float4 fv = __ldg(reinterpret_cast<const float4*>(values + k0));
    int4 iv = __ldg(reinterpret_cast<const int4*>(ids + k0));
    v[0] = fv.x; v[1] = fv.y; v[2] = fv.z; v[3] = fv.w;
    id[0] = iv.x; id[1] = iv.y; id[2] = iv.z; id[3] = iv.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      bool in = k0 + j < end;
      v[j] = in ? __ldg(values + k0 + j) : 0.0f;
      id[j] = in ? __ldg(ids + k0 + j) : -1;
    }
  }
}

// The block's chunk is [b0, b1); its bins cover ids [lo, lo + span).
// SMEM: every segment has a bin (lo 0, span n_seg) and the last block to
// finish decodes the maxima; else the window is the chunk's id range when
// that fits kBinCap (span 0 otherwise: every update goes to global).
template <bool VEC, bool SMEM>
__global__ void __launch_bounds__(kThreads)
    seg_reduce(const float* __restrict__ values, const int* __restrict__ ids,
               long long n, int n_seg, long long per_block,
               float* __restrict__ sums, unsigned* __restrict__ maxs,
               unsigned* __restrict__ ticket) {
  __shared__ float bsum[kBinCap];
  __shared__ unsigned bmax[kBinCap];
  __shared__ int red[2][kWarps];
  __shared__ bool last_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b0 = (long long)blockIdx.x * per_block;
  const long long b1 = b0 + per_block < n ? b0 + per_block : n;

  int lo = 0, span = n_seg;
  if (!SMEM) {
    int mn = INT_MAX, mx = -1;
    for (long long k0 = b0 + (long long)threadIdx.x * kItems; k0 < b1;
         k0 += (long long)kThreads * kItems) {
      float v[kItems];
      int id[kItems];
      load_items<VEC>(values, ids, k0, b1, v, id);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (id[j] >= 0) {
          mn = min(mn, id[j]);
          mx = max(mx, id[j]);
        }
      }
    }
    mn = __reduce_min_sync(kFull, mn);
    mx = __reduce_max_sync(kFull, mx);
    if (lane == 0) {
      red[0][warp] = mn;
      red[1][warp] = mx;
    }
    __syncthreads();
    mn = red[0][0];
    mx = red[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mn = min(mn, red[0][w]);
      mx = max(mx, red[1][w]);
    }
    lo = mn;
    span = (mx >= mn && mx - mn < kBinCap) ? mx - mn + 1 : 0;
  }
  for (int k = threadIdx.x; k < span; k += kThreads) {
    bsum[k] = 0.0f;
    bmax[k] = 0u;
  }
  __syncthreads();

  const long long per_warp = per_block / kWarps;
  const long long w0 = b0 + warp * per_warp;
  const long long w1 = w0 + per_warp < b1 ? w0 + per_warp : b1;
  int cid = -1;              // the run carried from the warp's last step
  float csum = 0.0f;
  unsigned cmax = 0u;
  for (long long base = w0; base < w1; base += kWarpStep) {
    float v[kItems];
    int id[kItems];
    load_items<VEC>(values, ids, base + lane * kItems, w1, v, id);
    // runs inside the lane: head (first), complete middle runs (issued
    // here) and tail (last); uniform when one run covers all kItems
    const int first = id[0];
    float hs = 0.0f, ts = v[0];
    unsigned hm = 0u, tm = enc(v[0]);
    int tid = id[0];
    bool uniform = true;
#pragma unroll
    for (int j = 1; j < kItems; ++j) {
      if (id[j] == tid) {
        ts += v[j];
        tm = max(tm, enc(v[j]));
      } else {
        if (uniform) {
          hs = ts;
          hm = tm;
          uniform = false;
        } else {
          put(tid, ts, tm, bsum, bmax, lo, span, sums, maxs);
        }
        tid = id[j];
        ts = v[j];
        tm = enc(v[j]);
      }
    }
    int prev_last = __shfl_up_sync(kFull, tid, 1);
    const int next_first = __shfl_down_sync(kFull, first, 1);
    if (lane == 0) {       // the carried run joins lane 0's first run
      prev_last = cid;
      if (first == cid) {
        if (uniform) {
          ts = csum + ts;
          tm = max(cmax, tm);
        } else {
          hs = csum + hs;
          hm = max(cmax, hm);
        }
      } else {
        put(cid, csum, cmax, bsum, bmax, lo, span, sums, maxs);
      }
    }
    // segmented inclusive scan of the tail runs over the lanes
    bool start = !uniform || lane == 0 || first != prev_last;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      float s_up = __shfl_up_sync(kFull, ts, d);
      unsigned m_up = __shfl_up_sync(kFull, tm, d);
      bool f_up = __shfl_up_sync(kFull, start, d);
      if (lane >= d) {
        if (!start) {
          ts = s_up + ts;
          tm = max(m_up, tm);
        }
        start = start || f_up;
      }
    }
    const float s_prev = __shfl_up_sync(kFull, ts, 1);
    const unsigned m_prev = __shfl_up_sync(kFull, tm, 1);
    if (!uniform) {        // a head run ends inside this lane
      if (lane > 0 && first == prev_last) {
        hs = s_prev + hs;
        hm = max(m_prev, hm);
      }
      put(first, hs, hm, bsum, bmax, lo, span, sums, maxs);
    }
    if (lane < 31 && next_first != tid) {
      put(tid, ts, tm, bsum, bmax, lo, span, sums, maxs);
    }
    cid = __shfl_sync(kFull, tid, 31);
    csum = __shfl_sync(kFull, ts, 31);
    cmax = __shfl_sync(kFull, tm, 31);
  }
  if (lane == 0) put(cid, csum, cmax, bsum, bmax, lo, span, sums, maxs);
  __syncthreads();

  for (int k = threadIdx.x; k < span; k += kThreads) {
    if (bmax[k]) {
      atomicAdd(sums + lo + k, bsum[k]);
      atomicMax(maxs + lo + k, bmax[k]);
    }
  }
  if (SMEM) {              // the last block to finish decodes the maxima
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last_block) {
      __threadfence();
      float* out = reinterpret_cast<float*>(maxs);
      for (int k = threadIdx.x; k < n_seg; k += kThreads) {
        out[k] = dec(__ldcg(maxs + k));
      }
    }
  }
}

__global__ void seg_decode(unsigned* __restrict__ maxs, int n_seg) {
  float* out = reinterpret_cast<float*>(maxs);
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < n_seg; k += (long long)gridDim.x * blockDim.x) {
    out[k] = dec(maxs[k]);
  }
}

// Messages a block takes: at least kMinPerBlock, at most kMaxBlocks blocks,
// rounded up to whole block steps (so every warp's range starts 16-byte
// aligned); the grid is then ceil(n / per_block).
long long per_block_for(long long n) {
  long long blocks = (n + kMinPerBlock - 1) / kMinPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  long long per = (n + blocks - 1) / blocks;
  return (per + kBlockStep - 1) / kBlockStep * kBlockStep;
}

template <bool SMEM>
void launch_reduce(bool vec, const float* values, const int* ids, long long n,
                   int n_seg, float* sums, unsigned* maxs, unsigned* ticket,
                   cudaStream_t st) {
  long long per = per_block_for(n);
  unsigned grid = (unsigned)((n + per - 1) / per);
  if (vec) {
    seg_reduce<true, SMEM><<<grid, kThreads, 0, st>>>(
        values, ids, n, n_seg, per, sums, maxs, ticket);
  } else {
    seg_reduce<false, SMEM><<<grid, kThreads, 0, st>>>(
        values, ids, n, n_seg, per, sums, maxs, ticket);
  }
}

}  // namespace

// values f32[n], ids i32[n] in [0, n_seg) -> out f32[2 * n_seg + 1]: sums
// in out[0:n_seg], maxima in out[n_seg:2 n_seg], and a scratch word (the
// block ticket) last.  smem != 0 takes the smem path and needs n_seg <=
// kBinCap.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a path n_seg does not fit.
extern "C" int segment_reduce(const float* values, const int* ids,
                              long long n, int n_seg, float* out, int smem,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg < 0 || (smem && n_seg > kBinCap)) {
    return (int)cudaErrorInvalidValue;
  }
  float* sums = out;
  unsigned* maxs = reinterpret_cast<unsigned*>(out + n_seg);
  unsigned* ticket = reinterpret_cast<unsigned*>(out + 2LL * n_seg);
  cudaError_t err = cudaMemsetAsync(out, 0, (2 * (size_t)n_seg + 1) * 4, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && n_seg > 0) {
    bool vec = ((reinterpret_cast<size_t>(values) |
                 reinterpret_cast<size_t>(ids)) % 16) == 0;
    if (smem) {
      launch_reduce<true>(vec, values, ids, n, n_seg, sums, maxs, ticket, st);
    } else {
      launch_reduce<false>(vec, values, ids, n, n_seg, sums, maxs, ticket,
                           st);
      long long blocks = (n_seg + kThreads - 1) / kThreads;
      seg_decode<<<(unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks),
                   kThreads, 0, st>>>(maxs, n_seg);
    }
  }
  return (int)cudaGetLastError();
}
