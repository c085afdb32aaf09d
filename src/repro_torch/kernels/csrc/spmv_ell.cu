// K3: block-ELL sparse matrix-vector product, y = A @ x, for every SpMV of
// the AMG V-cycle (smoother, residual, restriction by P^T, prolongation
// by P).
//
// Replaces the Pallas kernel `_spmv_kernel` in src/repro/kernels/spmv_ell.py
// (entry `spmv_block_ell`).  On the TPU the grid is (block row, slot): the
// slot axis runs in order on one core, a VMEM accumulator is carried across
// it, and the block-column ids are scalar-prefetched so that the x
// BlockSpec can follow them.  On Hopper the blocks run in parallel and in no
// order, so nothing carries over between them: each thread owns one output
// row, loops over its block row's slots itself with the sum in a register,
// and loads its block-column ids itself.
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
// that bound: the bs threads of a block row together read each bs x bs
// block as one contiguous run (row i of the block is thread i's bs values),
// in 16-byte vector loads through the read-only path when bs is 4, 8, 16
// or 32 and the pointers are 16-byte aligned; the x block of a slot is
// shared by those bs threads and by the other block rows that use the same
// block column, so it is mostly served from L1/L2.  Any other bs takes a
// scalar loop.  What this first kernel does not do: a block row with many
// slots (P^T on a fine level: 120) stays one serial chain per row, and a
// matrix with few block rows fills few SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

// One thread per output row, bs known at compile time, vector loads.
template <typename TA, typename TX, int BS>
__global__ void __launch_bounds__(kThreads)
    ell_rows(const TA* __restrict__ blocks, const int* __restrict__ cols,
             const TX* __restrict__ x, TX* __restrict__ y, long long n_rows,
             int max_bpr) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  long long r = row / BS;
  int i = (int)(row % BS);
  const TA* a = blocks + (r * max_bpr * BS + i) * BS;
  const int* c = cols + r * max_bpr;
  float acc = 0.0f;
#pragma unroll 2
  for (int s = 0; s < max_bpr; ++s) {
    float av[BS], xv[BS];
    load_row<BS>(a + (long long)s * BS * BS, av);
    load_row<BS>(x + (long long)__ldg(c + s) * BS, xv);
#pragma unroll
    for (int j = 0; j < BS; ++j) acc = fmaf(av[j], xv[j], acc);
  }
  y[row] = from_f<TX>(acc);
}

// The same for any bs, one value at a time.
template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
    ell_rows_any(const TA* __restrict__ blocks, const int* __restrict__ cols,
                 const TX* __restrict__ x, TX* __restrict__ y,
                 long long n_rows, int max_bpr, int bs) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  long long r = row / bs;
  int i = (int)(row % bs);
  const TA* a = blocks + (r * max_bpr * bs + i) * bs;
  const int* c = cols + r * max_bpr;
  float acc = 0.0f;
  for (int s = 0; s < max_bpr; ++s) {
    const TA* as = a + (long long)s * bs * bs;
    const TX* xs = x + (long long)c[s] * bs;
    for (int j = 0; j < bs; ++j) acc = fmaf(to_f(as[j]), to_f(xs[j]), acc);
  }
  y[row] = from_f<TX>(acc);
}

template <typename TA, typename TX>
void run(const void* blocks_v, const int* cols, const void* x_v, void* y_v,
         long long n_rows, int max_bpr, int bs, cudaStream_t st) {
  const TA* blocks = static_cast<const TA*>(blocks_v);
  const TX* x = static_cast<const TX*>(x_v);
  TX* y = static_cast<TX*>(y_v);
  unsigned grid = (unsigned)((n_rows + kThreads - 1) / kThreads);
  bool aligned = ((reinterpret_cast<uintptr_t>(blocks_v) |
                   reinterpret_cast<uintptr_t>(x_v)) % 16) == 0;
  if (aligned && bs == 4) {
    ell_rows<TA, TX, 4><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                   n_rows, max_bpr);
  } else if (aligned && bs == 8) {
    ell_rows<TA, TX, 8><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                   n_rows, max_bpr);
  } else if (aligned && bs == 16) {
    ell_rows<TA, TX, 16><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                    n_rows, max_bpr);
  } else if (aligned && bs == 32) {
    ell_rows<TA, TX, 32><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                    n_rows, max_bpr);
  } else {
    ell_rows_any<TA, TX><<<grid, kThreads, 0, st>>>(blocks, cols, x, y,
                                                    n_rows, max_bpr, bs);
  }
}

}  // namespace

// blocks [nbr, max_bpr, bs, bs] (bf16 if a_bf16 else f32), cols i32 [nbr,
// max_bpr] in [0, ncb), x [ncb * bs] (bf16 if x_bf16 else f32) -> y
// [n_rows = nbr * bs] in x's type.  n_rows > 0.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int spmv_block_ell(const void* blocks, const int* cols,
                              const void* x, void* y, long long n_rows,
                              int max_bpr, int bs, int a_bf16, int x_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_bf16 && x_bf16) {
    run<__nv_bfloat16, __nv_bfloat16>(blocks, cols, x, y, n_rows, max_bpr,
                                      bs, st);
  } else if (a_bf16) {
    run<__nv_bfloat16, float>(blocks, cols, x, y, n_rows, max_bpr, bs, st);
  } else if (x_bf16) {
    run<float, __nv_bfloat16>(blocks, cols, x, y, n_rows, max_bpr, bs, st);
  } else {
    run<float, float>(blocks, cols, x, y, n_rows, max_bpr, bs, st);
  }
  return (int)cudaGetLastError();
}
