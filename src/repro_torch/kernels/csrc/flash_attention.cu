// K4: flash attention forward (online softmax), causal or full, with
// grouped-query heads, for every attention layer of the prefill.
//
// Replaces the Pallas kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (entry `flash_attention`, wrapped by
// `ops.mha_flash`).  On the TPU the grid is (batch, head, q block, kv
// block) with the kv axis run in order on one core, and the running max,
// sum and accumulator carried across it in VMEM scratch.  On Hopper the
// blocks run in parallel and in no order, so one thread block owns a tile
// of query rows of one (batch, head) and walks the kv tiles itself in a
// loop, with each row's running max, sum and accumulator in registers.
//
// Layout (the reference's): q [B, S, H, D], k and v [B, S, KH, D], all
// contiguous, float32 or bfloat16 (one type for all three); query head h
// reads kv head h / (H / KH).  Scores q.k * scale in float32, masked to
// -1e30 above the diagonal (causal) and past S; output acc / max(l, 1e-30)
// in q's type (bfloat16 rounded to nearest even).  D is 16, 32, 64 or 128;
// S is any length (the ragged last tiles are masked).
//
// Bound: operations.  A causal call does B*H*S(S+1)/2 * 4D flops against
// B*S*(H + 2 KH)*D*2 bytes in and B*S*H*D*2 out: at hymba-1.5b's prefill
// (B 4, S 2048, H 25, KH 5, D 64) 5.4e10 flops, 54 us at the bf16 tensor
// rate, against 19 us of bytes.  This first kernel does its products as
// float32 FMAs on the CUDA cores (67 TFLOP/s peak), so it cannot reach the
// bound; `wgmma` is the later step.  What the design does for the FMAs:
// each kv tile is staged once in shared memory as float32 and read by all
// rows of the block (a warp reads at most 4 distinct float4s of a kv row,
// so the loads are broadcasts without bank conflicts); a row is split over
// D / 32 threads (each owns 32 of its dims in 8 float4 groups), whose
// partial dot products meet by warp shuffles, so q and the accumulator stay
// in registers without spills; scores are taken 16 keys at a time so the
// accumulator is rescaled once per 16 keys; kv tiles wholly above the
// diagonal are never loaded; and the q tiles with the most kv tiles start
// first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // query rows of a block
constexpr int kChunk = 16;       // keys scored together
constexpr float kNegInf = -1e30f;

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

// Dims of a row owned by one thread, threads per row, keys per kv tile
// (two float32 tiles of kKeys x D stay at or under 32 KiB).
template <int D>
struct Shape {
  static constexpr int kDims = D < 32 ? D : 32;
  static constexpr int kThreadsPerRow = D / kDims;
  static constexpr int kGroups = kDims / 4;  // float4 groups per thread
  static constexpr int kKeys = D <= 64 ? 64 : 32;
  static constexpr int kThreads = kRows * kThreadsPerRow;
};

template <int D, typename T>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KH,
          int causal, float scale) {
  using Sh = Shape<D>;
  constexpr int TPR = Sh::kThreadsPerRow;
  constexpr int KEYS = Sh::kKeys;
  __shared__ __align__(16) float ks[KEYS * D];
  __shared__ __align__(16) float vs[KEYS * D];

  const int n_qtiles = (S + kRows - 1) / kRows;
  // the last q tiles see the most kv tiles when causal: start them first
  const int qt = n_qtiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int slice = threadIdx.x % TPR;
  const int row = qt * kRows + threadIdx.x / TPR;
  const bool live = row < S;

  // this thread's dims of the row: float4 group g covers dims
  // 4 * (slice + TPR * g) .. +3, so the TPR threads of a row read adjacent
  // float4s of a kv row
  float qr[Sh::kDims];
  float acc[Sh::kDims];
  const int64_t q_off = ((int64_t)b * S + (live ? row : 0)) * H * D +
                        (int64_t)h * D;
#pragma unroll
  for (int g = 0; g < Sh::kGroups; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (slice + TPR * g) + c;
      qr[4 * g + c] = live ? to_f(q[q_off + d]) : 0.f;
      acc[4 * g + c] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int kv_end = causal ? min(S, (qt + 1) * kRows) : S;
  const int64_t kv_stride = (int64_t)KH * D;  // between positions
  const T* kb = k + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const T* vb = v + (int64_t)b * S * kv_stride + (int64_t)kvh * D;

  for (int k0 = 0; k0 < kv_end; k0 += KEYS) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < KEYS * D; e += Sh::kThreads) {
      const int key = k0 + e / D;
      const int d = e % D;
      const bool in = key < S;
      ks[e] = in ? to_f(kb[(int64_t)key * kv_stride + d]) : 0.f;
      vs[e] = in ? to_f(vb[(int64_t)key * kv_stride + d]) : 0.f;
    }
    __syncthreads();
    const int tile_end = min(KEYS, kv_end - k0);
    for (int j0 = 0; j0 < tile_end; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr =
            reinterpret_cast<const float4*>(ks + (j0 + jj) * D) + slice;
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < Sh::kGroups; ++g) {
          const float4 kv4 = kr[TPR * g];
          dot = fmaf(qr[4 * g], kv4.x, dot);
          dot = fmaf(qr[4 * g + 1], kv4.y, dot);
          dot = fmaf(qr[4 * g + 2], kv4.z, dot);
          dot = fmaf(qr[4 * g + 3], kv4.w, dot);
        }
#pragma unroll
        for (int w = TPR / 2; w > 0; w /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, w);
        const int key = k0 + j0 + jj;
        const bool ok = key < S && (!causal || key <= row);
        s[jj] = ok ? dot * scale : kNegInf;
      }
      float mc = s[0];
#pragma unroll
      for (int jj = 1; jj < kChunk; ++jj) mc = fmaxf(mc, s[jj]);
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < Sh::kDims; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (j0 + jj) * D) + slice;
#pragma unroll
        for (int g = 0; g < Sh::kGroups; ++g) {
          const float4 v4 = vr[TPR * g];
          acc[4 * g] = fmaf(p, v4.x, acc[4 * g]);
          acc[4 * g + 1] = fmaf(p, v4.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(p, v4.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(p, v4.w, acc[4 * g + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int g = 0; g < Sh::kGroups; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (slice + TPR * g) + c;
      o[q_off + d] = from_f<T>(acc[4 * g + c] * inv);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd<D, T><<<grid, Shape<D>::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KH, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KH, int D, int causal,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    case 32:
      return launch<32, T>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    case 64:
      return launch<64, T>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// o = attention(q, k, v) on `stream`.  Returns the launch's CUDA error (0
// when it was accepted); cudaErrorInvalidValue for a head dim it does not
// take.  B, S, H > 0 and H % KH == 0 are the caller's to check.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KH, int D, int causal,
                                   int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, causal, scale,
                                   s);
  return dispatch<float>(q, k, v, o, B, S, H, KH, D, causal, scale, s);
}
