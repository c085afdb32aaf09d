// One warpgroup's bf16 products in each operand form K4's tensor-core path
// uses, on 64-row tiles staged by the helpers of
// src/repro_torch/kernels/csrc/wgmma.cuh.  Built and run by
// tools/wgmma_probe.py, which holds each result to torch.matmul in float32.
//
//   ss:    C[64 x 64]  = A[64 x K] B[64 x K]^T, A and B K-major (Q K^T)
//   rs:    C[64 x N]   = A[64 x 64] V[64 x N], A from registers (loaded in
//                        the accumulator layout), V MN-major (P V)
//   chain: C[64 x N]   = bf16(A B^T) V, the ss result turned into rs's A
//                        in registers (S -> P of flash attention)
// K and N are 64 or 128; lbo and sbo are V's descriptor offsets.

#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;

// Row and column of accumulator register i of this thread (m64nNk16).
__device__ __forceinline__ void acc_pos(int i, int& row, int& col) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  row = 16 * w + l / 4 + 8 * ((i / 2) % 2);
  col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
}

template <int R>
__device__ void store_acc(const float (&d)[R], float* c, int n) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int row, col;
    acc_pos(i, row, col);
    c[row * n + col] = d[i];
  }
}

template <int K>
__device__ void product_ss(float (&s)[32], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wg::fence_regs(s);
  wg::arrive();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t off = (kk / 4) * wg::kBlockBytes + (kk % 4) * 32;
    wg::mma_ss_n64(s, wg::desc(sa + off, 16, 1024),
                   wg::desc(sb + off, 16, 1024), kk > 0);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(s);
}

template <int N>
__device__ void product_rs(float (&o)[N / 2], const uint32_t (&a)[4][4],
                           uint32_t sv, uint32_t lbo, uint32_t sbo) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] = 0.f;
  wg::fence_regs(o);
  wg::arrive();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wg::mma_rs(o, a[kk], wg::desc(sv + kk * 2048, lbo, sbo), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(o);
}

// mode 0: ss; 1: rs; 2: chain.  a [64 x K], b [64 x K], v [64 x N] bf16
// row-major; c [64 x 64] (ss) or [64 x N] float32.
template <int K, int N>
__global__ void __launch_bounds__(kThreads)
probe(int mode, const __nv_bfloat16* a, const __nv_bfloat16* b,
      const __nv_bfloat16* v, float* c, uint32_t lbo, uint32_t sbo) {
  extern __shared__ uint8_t raw[];
  const uint32_t base = (wg::smem_addr(raw) + 1023) & ~1023u;
  const uint32_t sa = base, sb = base + 2 * wg::kBlockBytes,
                 sv = base + 4 * wg::kBlockBytes;
  wg::load_rows<K, kThreads>(sa, a, 0, 64, K, threadIdx.x);
  wg::load_rows<K, kThreads>(sb, b, 0, 64, K, threadIdx.x);
  wg::load_rows<N, kThreads>(sv, v, 0, 64, N, threadIdx.x);
  wg::cp_commit();
  wg::cp_wait<0>();
  wg::fence_async_smem();
  __syncthreads();

  float s[32];
  uint32_t frag[4][4];
  if (mode != 1) {
    product_ss<K>(s, sa, sb);
    if (mode == 0) {
      store_acc(s, c, 64);
      return;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        frag[kk][r] = wg::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  } else {
    // A's fragments straight from global: register 2r, 2r + 1 of slice kk
    // is accumulator pair 8 kk + 2 r of a 64-wide accumulator
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int row, col;
        acc_pos(8 * kk + 2 * r, row, col);
        frag[kk][r] = wg::pack_bf16(__bfloat162float(a[row * 64 + col]),
                                    __bfloat162float(a[row * 64 + col + 1]));
      }
  }
  float o[N / 2];
  product_rs<N>(o, frag, sv, lbo, sbo);
  store_acc(o, c, N);
}

template <int K, int N>
int run(int mode, const void* a, const void* b, const void* v, void* c,
        uint32_t lbo, uint32_t sbo, cudaStream_t stream) {
  const int smem = 6 * wg::kBlockBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      probe<K, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  probe<K, N><<<1, kThreads, smem, stream>>>(
      mode, static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(c), lbo, sbo);
  return cudaGetLastError();
}

}  // namespace

// K and N each 64 or 128; returns the launch's CUDA error.
extern "C" int wgmma_probe(int mode, int K, int N, const void* a,
                           const void* b, const void* v, void* c, int lbo,
                           int sbo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 64 && N == 64) return run<64, 64>(mode, a, b, v, c, lbo, sbo, s);
  if (K == 64 && N == 128) return run<64, 128>(mode, a, b, v, c, lbo, sbo, s);
  if (K == 128 && N == 64) return run<128, 64>(mode, a, b, v, c, lbo, sbo, s);
  if (K == 128 && N == 128)
    return run<128, 128>(mode, a, b, v, c, lbo, sbo, s);
  return cudaErrorInvalidValue;
}
