// K2: exact receive-queue walk (Fenwick trees), one thread per receiver.
//
// Replaces the Pallas kernel `_queue_walk_pallas_kernel` in
// src/repro/kernels/comm_stack.py (built by `_pallas_queue_walk`, entry
// `queue_walk`, layout `_queue_layout`).  That kernel advances every receiver
// region in lock-step rounds (round j takes each region's j-th arrival) with
// fixed-depth, maskless Fenwick chains, because a TPU program is one
// sequential vector stream.  Regions are independent, so on Hopper each
// region gets its own thread, which walks all of its arrivals in order; no
// rounds, no masks, no grid-wide synchronisation.
//
// Layout (the reference's): region r owns the private tree slice
// tree[toff[r] .. toff[r] + span[r]] with span[r] the power of two >=
// counts[r] (local slot 0 is the always-zero root); the tree array ends with
// one shared sink cell, which a serial walk never needs because it stops a
// removal chain at its span.  The thread builds its tree in place
// (tree[i] = min(i, c) - min(i - lowbit(i), c): prefix counts of c unmatched
// posted slots), then for arrival j at posted slot p = b[start + j] + 1 it
// writes the prefix count up to p — the 1-based position of the match in the
// still-unmatched queue — and removes p.  int32 throughout; the result is
// bit-equal to the lock-step reference for any schedule.
//
// Bound: operations on one serial chain.  Each arrival costs about
// 2 * log2(span) dependent loads and stores in the thread's own tree slice,
// so the longest region sets the time and the other threads idle once theirs
// finish (load imbalance, recorded rather than fixed in this first kernel).
// The slices are small and stay in L1/L2, which keeps each step's latency
// short.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void walk(const int* __restrict__ b, const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ toff,
                     const int* __restrict__ span, int* __restrict__ tree,
                     long long* __restrict__ steps, int n_regions) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_regions) return;
  const int c = counts[r];
  if (c == 0) return;
  const int s = starts[r];
  const int sp = span[r];
  int* t = tree + toff[r];
  t[0] = 0;
  for (int i = 1; i <= sp; ++i) {
    int lo = i - (i & -i);
    t[i] = min(i, c) - min(lo, c);
  }
  for (int j = 0; j < c; ++j) {
    const int p = b[s + j] + 1;
    int acc = 0;
    for (int i = p; i > 0; i -= i & -i) acc += t[i];
    steps[s + j] = acc;
    // unsigned: the last step may pass 2^30 on the largest allowed span
    for (unsigned i = p; i <= (unsigned)sp; i += i & (0u - i)) t[i] -= 1;
  }
}

}  // namespace

// b i32[N] (posted slot of each arrival, region-local), starts/counts/toff/
// span i32[n_regions], tree i32 scratch (toff[-1] + span[-1] + 2 cells) ->
// steps i64[N].  Launches on `stream`; returns cudaGetLastError().
extern "C" int queue_walk(const int* b, const int* starts, const int* counts,
                          const int* toff, const int* span, int* tree,
                          long long* steps, int n_regions, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_regions > 0) {
    int blocks = (n_regions + kThreads - 1) / kThreads;
    walk<<<blocks, kThreads, 0, st>>>(b, starts, counts, toff, span, tree,
                                      steps, n_regions);
  }
  return (int)cudaGetLastError();
}
