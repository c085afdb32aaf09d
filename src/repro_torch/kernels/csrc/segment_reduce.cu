// K1: fused segment sum and maximum for the PhaseStack reductions.
//
// Replaces the Pallas kernel `_fused_segreduce_kernel` in
// src/repro/kernels/comm_stack.py (built by `_pallas_segreduce`, entry
// `fused_segment_reduce`).  On the TPU the grid runs in order on one core,
// so that kernel streams 512-message chunks through a lane-padded output row
// that stays resident in VMEM across the grid, with padding lanes parked on a
// sink column.  On Hopper the blocks run in parallel and in no order, so
// nothing can be carried from one block to the next: every thread scatters
// its messages straight into the two output rows in global memory with
// atomics, and no sink column or lane padding is needed.
//
// Contract (the same as the TPU kernel's): sums[s] = sum of values[k] with
// ids[k] == s; maxs[s] = their maximum; an empty segment reports sum 0 and
// max 0.  The order of the atomic additions changes from run to run, so the
// sums are float32-allclose to a sequential sum, never bit-equal.
//
// Bound: bytes.  Each message is read once (4-byte value, 4-byte id) and the
// outputs are 8 bytes per segment, so at 3.35 TB/s a 2M-message reduction is
// bounded near 5 us.  The atomics resolve in L2; many messages of one hot
// segment (a phase with few processes) serialise there.  This first kernel
// keeps one thread per message in a grid-stride loop; privatising the bins
// in shared memory is the next step.
//
// The maximum uses integer atomics on the float's bit pattern: for a float
// with the sign bit clear the signed-int order is the float order, and for
// one with the sign bit set the unsigned order is the reverse of the float
// order, so atomicMax (int) / atomicMin (unsigned) select the larger float
// in both halves.  The rows start at -inf, and -inf left after the scatter
// (an empty segment) becomes 0.  NaN inputs are outside the contract.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // 16 resident blocks per SM

__global__ void seg_init(float* __restrict__ sums, float* __restrict__ maxs,
                         int n_seg) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_seg;
       s += gridDim.x * blockDim.x) {
    sums[s] = 0.0f;
    maxs[s] = -CUDART_INF_F;
  }
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void seg_scatter(const float* __restrict__ values,
                            const int* __restrict__ ids, long long n,
                            float* __restrict__ sums,
                            float* __restrict__ maxs) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    float v = values[k];
    int s = ids[k];
    atomicAdd(sums + s, v);
    atomic_max_float(maxs + s, v);
  }
}

__global__ void seg_finalize(float* __restrict__ maxs, int n_seg) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_seg;
       s += gridDim.x * blockDim.x) {
    if (maxs[s] == -CUDART_INF_F) maxs[s] = 0.0f;
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// values f32[n], ids i32[n] in [0, n_seg) -> sums f32[n_seg], maxs f32[n_seg].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int segment_reduce(const float* values, const int* ids,
                              long long n, int n_seg, float* sums,
                              float* maxs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 0) {
    seg_init<<<blocks_for(n_seg), kThreads, 0, st>>>(sums, maxs, n_seg);
  }
  if (n > 0) {
    seg_scatter<<<blocks_for(n), kThreads, 0, st>>>(values, ids, n, sums,
                                                    maxs);
  }
  if (n_seg > 0) {
    seg_finalize<<<blocks_for(n_seg), kThreads, 0, st>>>(maxs, n_seg);
  }
  return (int)cudaGetLastError();
}
