// K3: block-ELL sparse matrix-vector product, y = A @ x, for every SpMV of
// the AMG V-cycle (smoother, residual, restriction by P^T, prolongation
// by P).
//
// Replaces the Pallas kernel `_spmv_kernel` in src/repro/kernels/spmv_ell.py
// (entry `spmv_block_ell`).  On the TPU the grid is (block row, slot): the
// slot axis runs in order on one core, a VMEM accumulator is carried across
// it, and the block-column ids are scalar-prefetched so that the x
// BlockSpec can follow them.  On Hopper the blocks run in parallel and in no
// order, so nothing carries over between them: the threads of an output
// row loop over its block row's slots themselves with their sums in
// registers, load the block-column ids themselves, and add their sums with
// warp shuffles.
//
// Layout (the reference's): blocks [nbr, max_bpr, bs, bs], cols [nbr,
// max_bpr] int32 (padding slots point at block column 0 and hold zeros),
// x [ncb * bs], y [nbr * bs].  float32 or bfloat16 blocks and x, sums in
// float32, y in x's type (rounded to nearest even).  max_bpr == 0 writes
// zeros.
//
// Bound: bytes.  The padded blocks are read once (nbr * max_bpr * bs * bs
// values), the ids once, x once and y written once, at 3.35 TB/s; the
// work is 2 flops a block value, far below the card's rate.  Design for
// that bound: row i of a bs x bs block is bs contiguous values, read in
// 16-byte vector loads through the read-only path when bs is 4, 8, 16 or
// 32 and the pointers are 16-byte aligned (any other bs takes a scalar
// loop); the x block of a slot is shared by the rows of its block row and
// by the other block rows that use the same block column, so it is mostly
// served from L1/L2.
//
// Split rows.  One thread a row walking every slot leaves a matrix with
// few block rows and many slots (P^T on a fine level: 1,974 block rows x
// 120 slots) with a few thousand long serial chains on a card that wants
// ~10^5 threads in flight.  So each row is summed by `lanes` threads (a
// power of two up to 32, picked by the wrapper's `spmv_ell.lanes_for`):
// lane l takes slots l, l + lanes, ..., and a shuffle butterfly adds the
// lanes' sums.  Threads are numbered row-major with the lane fastest, so a
// warp's lanes read `lanes` consecutive slots of 32 / lanes rows: for bs 8
// and 4 lanes, four whole 8 x 8 blocks (1 KB) a step.  lanes = 1 is the
// first kernel's one thread a row.
//
// Padding.  A block row with fewer blocks than max_bpr is padded with zero
// blocks at block column 0 (about a third of level 1's P^T slots).  When
// the wrapper vouches that the pair is still as `csr_to_block_ell` made it
// (skip_pad, from `spmv_ell.padding_at_end`), real blocks fill the first
// slots in ascending block-column order, so a slot s >= 1 at block column
// 0 is padding and so is every slot after it: a lane stops there.  Padding
// adds exact zeros, so stopping changes no bit of the result; only the
// bytes read drop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLanes = 32;          // mirrored by spmv_ell.K3_MAX_LANES

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// N consecutive values at p (aligned to N * sizeof(value) bytes) as floats.
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&out)[N]) {
  static_assert(N % 4 == 0, "float rows load as float4");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p + k));
    out[k] = v.x;
    out[k + 1] = v.y;
    out[k + 2] = v.z;
    out[k + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&out)[N]) {
  static_assert(N == 4 || N % 8 == 0, "bf16 rows load as 8 or 16 bytes");
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 8) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(p + k));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 f = __bfloat1622float2(h[q]);
        out[k + 2 * q] = f.x;
        out[k + 2 * q + 1] = f.y;
      }
    }
  } else {
    uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float2 f0 = __bfloat1622float2(h[0]);
    float2 f1 = __bfloat1622float2(h[1]);
    out[0] = f0.x;
    out[1] = f0.y;
    out[2] = f1.x;
    out[3] = f1.y;
  }
}

// `lanes` = 1 << lanes_log2 threads per output row, interleaved over the
// slots; BS > 0: bs known at compile time, vector loads; BS == 0: any bs
// (bs_rt), one value at a time.  Every thread of a warp reaches the
// shuffles (rows past n_rows add zeros), since lanes divides 32.
template <typename TA, typename TX, int BS>
__global__ void __launch_bounds__(kThreads)
    ell_rows(const TA* __restrict__ blocks, const int* __restrict__ cols,
             const TX* __restrict__ x, TX* __restrict__ y, long long n_rows,
             int max_bpr, int bs_rt, int lanes_log2, bool skip_pad) {
  const int bs = BS > 0 ? BS : bs_rt;
  const int lanes = 1 << lanes_log2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t >> lanes_log2;
  const int lane = (int)(t & (lanes - 1));
  float acc = 0.0f;
  if (row < n_rows) {
    const long long r = row / bs;
    const int i = (int)(row % bs);
    const TA* a = blocks + (r * max_bpr * bs + i) * bs;
    const int* c = cols + r * max_bpr;
    if constexpr (BS > 0) {
#pragma unroll 2
      for (int s = lane; s < max_bpr; s += lanes) {
        const int col = __ldg(c + s);
        if (skip_pad && s > 0 && col == 0) break;
        float av[BS], xv[BS];
        load_row<BS>(a + (long long)s * BS * BS, av);
        load_row<BS>(x + (long long)col * BS, xv);
#pragma unroll
        for (int j = 0; j < BS; ++j) acc = fmaf(av[j], xv[j], acc);
      }
    } else {
      for (int s = lane; s < max_bpr; s += lanes) {
        const int col = c[s];
        if (skip_pad && s > 0 && col == 0) break;
        const TA* as = a + (long long)s * bs * bs;
        const TX* xs = x + (long long)col * bs;
        for (int j = 0; j < bs; ++j) {
          acc = fmaf(to_f(as[j]), to_f(xs[j]), acc);
        }
      }
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < n_rows && lane == 0) y[row] = from_f<TX>(acc);
}

template <typename TA, typename TX>
void run(const void* blocks_v, const int* cols, const void* x_v, void* y_v,
         long long n_rows, int max_bpr, int bs, int lanes_log2,
         bool skip_pad, cudaStream_t st) {
  const TA* blocks = static_cast<const TA*>(blocks_v);
  const TX* x = static_cast<const TX*>(x_v);
  TX* y = static_cast<TX*>(y_v);
  unsigned grid =
      (unsigned)(((n_rows << lanes_log2) + kThreads - 1) / kThreads);
  bool aligned = ((reinterpret_cast<uintptr_t>(blocks_v) |
                   reinterpret_cast<uintptr_t>(x_v)) % 16) == 0;
  if (aligned && bs == 4) {
    ell_rows<TA, TX, 4><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                   n_rows, max_bpr, bs,
                                                   lanes_log2, skip_pad);
  } else if (aligned && bs == 8) {
    ell_rows<TA, TX, 8><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                   n_rows, max_bpr, bs,
                                                   lanes_log2, skip_pad);
  } else if (aligned && bs == 16) {
    ell_rows<TA, TX, 16><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                    n_rows, max_bpr, bs,
                                                    lanes_log2, skip_pad);
  } else if (aligned && bs == 32) {
    ell_rows<TA, TX, 32><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                    n_rows, max_bpr, bs,
                                                    lanes_log2, skip_pad);
  } else {
    ell_rows<TA, TX, 0><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                   n_rows, max_bpr, bs,
                                                   lanes_log2, skip_pad);
  }
}

}  // namespace

// blocks [nbr, max_bpr, bs, bs] (bf16 if a_bf16 else f32), cols i32 [nbr,
// max_bpr] in [0, ncb), x [ncb * bs] (bf16 if x_bf16 else f32) -> y
// [n_rows = nbr * bs] in x's type, each row summed by `lanes` threads (a
// power of two in [1, kMaxLanes]).  skip_pad != 0: the pair is in
// csr_to_block_ell's layout as made, and a row's lanes stop at its first
// padding slot.  n_rows > 0.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for another
// `lanes`.
extern "C" int spmv_block_ell(const void* blocks, const int* cols,
                              const void* x, void* y, long long n_rows,
                              int max_bpr, int bs, int a_bf16, int x_bf16,
                              int lanes, int skip_pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  if (a_bf16 && x_bf16) {
    run<__nv_bfloat16, __nv_bfloat16>(blocks, cols, x, y, n_rows, max_bpr,
                                      bs, lg, skip_pad != 0, st);
  } else if (a_bf16) {
    run<__nv_bfloat16, float>(blocks, cols, x, y, n_rows, max_bpr, bs, lg,
                              skip_pad != 0, st);
  } else if (x_bf16) {
    run<float, __nv_bfloat16>(blocks, cols, x, y, n_rows, max_bpr, bs, lg,
                              skip_pad != 0, st);
  } else {
    run<float, float>(blocks, cols, x, y, n_rows, max_bpr, bs, lg,
                      skip_pad != 0, st);
  }
  return (int)cudaGetLastError();
}
