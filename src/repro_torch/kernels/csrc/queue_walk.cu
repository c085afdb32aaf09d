// K2: exact receive-queue walk, one thread per arrival.
//
// Replaces the Pallas kernel `_queue_walk_pallas_kernel` in
// src/repro/kernels/comm_stack.py (built by `_pallas_queue_walk`, entry
// `queue_walk`, layout `_queue_layout`).  That kernel advances every receiver
// region in lock-step rounds (round j takes each region's j-th arrival) of
// fixed-depth Fenwick chains, because a TPU program is one sequential vector
// stream.  On Hopper a serial chain a region is latency-bound: each of its
// dependent steps is an L2 round trip, so the longest chain times ~250
// cycles set the time.  This kernel has no tree and no chain.
//
// The count.  Arrival j of a region matches posted slot b[j] (0-based,
// region-local); its step is the 1-based position of b[j] among the slots
// still unmatched.  The slots matched before it are exactly b[j'] for the
// earlier arrivals j' < j of the region, all different from b[j], so
//     steps[j] = b[j] + 1 - #{ j' < j in its region : b[j'] < b[j] },
// the same integers as the Fenwick walk's for any input.
//
// The kernel.  A flat grid of kThreads threads a block, one arrival a thread
// in arrival order.  Thread g finds its region's start, the largest
// starts[r] <= g, by a binary search over starts (an empty region shares its
// start with the next one, so ties give the same value).  The block's window,
// b[start of its first arrival's region .. its last arrival), is staged in
// shared memory in tiles of kTile words with coalesced loads; each thread
// counts the smaller slots in the part of each tile that lies in [its
// region's start, g).  Lanes of one region read the same word at the same
// time, a broadcast.  b and starts are read as the layout makes them (int64,
// every value below 2^31) and narrowed: int32 inside, no cast kernels and no
// scratch.  Steps go out as int64, coalesced.
//
// Cost.  Compares: c (c - 1) / 2 for a region of c arrivals.  The full-width
// sweep's call (1.92 M arrivals in 122,867 regions, at most 174 a region)
// needs ~4e7, and a block's window fits one tile.  There about half the time
// is the binary search's ~17 dependent loads and the window's load after it,
// paid once in each of ~7 waves of blocks; a quarter is the compare loop (a
// warp runs as long as its lane with the most earlier arrivals); the rest is
// the int64 reads and writes (tools/k2_ablation.py takes each part out).  The
// cost is quadratic in a region's length, with no size limit and no second
// path: one region of 10^6 arrivals is 5e11 compares, each block streaming
// the region's earlier arrivals tile by tile (tools/k2_check.py times it);
// the serial Fenwick chain this kernel replaced took seconds for such a
// region.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
count_earlier_smaller(const long long* __restrict__ b,
                      const long long* __restrict__ starts, int n,
                      int n_regions, long long* __restrict__ steps) {
  __shared__ int tile[kTile];
  __shared__ int window_start;
  const long long first = (long long)blockIdx.x * kThreads;
  const bool live = first + threadIdx.x < n;
  const int g = (int)(live ? first + threadIdx.x : first);
  // the block's last arrival, the exclusive end of its window
  const int last = (int)min(first + kThreads, (long long)n) - 1;

  // this arrival's region start, the largest starts[r] <= g (starts[0] == 0)
  int lo = 0, hi = n_regions;            // starts[lo] <= g < starts[hi]
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if ((int)starts[mid] <= g) lo = mid; else hi = mid;
  }
  const int s = (int)starts[lo];
  if (threadIdx.x == 0) window_start = s;   // the block's smallest start
  const int bj = live ? (int)b[g] : 0;
  __syncthreads();

  // the window b[window_start .. last), tile by tile: count the smaller
  // slots in [s, g)
  int less = 0;
  for (int t0 = window_start; t0 < last;) {
    const int len = min(kTile, last - t0);
    for (int i = threadIdx.x; i < len; i += kThreads) tile[i] = (int)b[t0 + i];
    __syncthreads();
    const int from = max(s, t0) - t0;
    const int to = live ? min(g, t0 + len) - t0 : from;
    for (int i = from; i < to; ++i) less += tile[i] < bj;
    t0 += len;
    __syncthreads();                        // the tile is read: refill it
  }
  if (live) steps[g] = (long long)(bj + 1 - less);
}

}  // namespace

// b i64[n] (posted slot of each arrival, region-local), starts i64[n_regions]
// (first arrival of each region, non-decreasing from 0), every value below
// 2^31 -> steps i64[n].  Launches on `stream`; returns cudaGetLastError().
extern "C" int queue_walk(const long long* b, const long long* starts, int n,
                          int n_regions, long long* steps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && n_regions > 0) {
    const int blocks = (int)(((long long)n + kThreads - 1) / kThreads);
    count_earlier_smaller<<<blocks, kThreads, 0, st>>>(b, starts, n,
                                                       n_regions, steps);
  }
  return (int)cudaGetLastError();
}
