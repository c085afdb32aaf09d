// K4: flash attention forward (online softmax), causal or full, with
// grouped-query heads, for every attention layer of the prefill.
//
// Replaces the Pallas kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (entry `flash_attention`, wrapped by
// `ops.mha_flash`).  On the TPU the grid is (batch, head, q block, kv
// block) with the kv axis run in order on one core, and the running max,
// sum and accumulator carried across it in VMEM scratch.  On Hopper the
// blocks run in parallel and in no order, so one thread block owns a tile
// of 64 query rows of one (batch, head) and walks the kv tiles itself in a
// loop, with each row's running max, sum and accumulator in registers.
//
// Layout (the reference's): q [B, S, H, D], k and v [B, S, KH, D], all
// contiguous, float32 or bfloat16 (one type for all three); query head h
// reads kv head h / (H / KH).  Scores q.k * scale in float32, masked to
// -1e30 above the diagonal (causal) and past S; output acc / max(l, 1e-30)
// in q's type (bfloat16 rounded to nearest even).  D is 16, 32, 64 or 128;
// S is any length (the ragged last tiles are masked).  Two kernels, chosen
// by the dtype: bfloat16 runs on the tensor cores (`flash_fwd_wgmma`),
// float32 on the CUDA cores (`flash_fwd`); a bfloat16 input never reaches
// the float32 kernel.
//
// Bound: operations.  A causal call does B*H*S(S+1)/2 * 4D flops against
// B*S*(H + 2 KH)*D*2 bytes in and B*S*H*D*2 out: at hymba-1.5b's prefill
// (B 4, S 2048, H 25, KH 5, D 64) 5.4e10 flops, 54 us at the bf16 tensor
// rate (989 TFLOP/s), against 19 us of bytes.
//
// bfloat16, `flash_fwd_wgmma` (replaces the FMA kernel's bf16 path, which
// converted every tile to float32 and did its products as float32 FMAs at
// 21 TFLOP/s).  One warpgroup (128 threads) a block, 64 query rows of one
// (batch, head); grid (ceil(S / 64), H, B), its blocks remapped so that the
// q tiles with the most kv tiles start first over the whole grid.
// - S = Q K^T: `wgmma` m64n64k16, Q (staged once) and the K tile of 64 keys
//   both K-major in shared memory with the 128-byte swizzle; D 16 and 32
//   are padded to 64 columns (zeroed once) so every operand has 128-byte
//   rows, D 128 is two 128-byte atoms along K.
// - Softmax on the S accumulator in registers: a thread holds 16 scores of
//   each of two rows, so a row's max and sum meet over the 4 threads of a
//   quad (2 shuffles).  Masked scores are -1e30 before the max; the max is
//   taken on the unscaled scores (a tree of maxima), and scale * log2 e is
//   folded into one FFMA ahead of a bare `ex2.approx`, so a score costs an
//   FFMA and a MUFU op; l is summed from the float32 p.
// - O += P V: `wgmma` m64nDk16 (D padded to 64) with P as A from
//   registers, rounded to bf16 in place (the f32 accumulator's layout is
//   the register A's, as in FlashAttention-3), and V as B kept [keys, D]:
//   MN-major with the transpose bit, the same 128-byte swizzled rows as K,
//   so K and V share one copy routine and no register pass transposes V
//   (tools/wgmma_probe.py checks each operand form alone).
// - Copies: 16-byte `cp.async` from the [B, S, heads, D] rows in place (no
//   copy or transpose outside the kernel), K and V double-buffered: tile
//   j + 1 goes in flight before tile j is waited for, and runs while tile
//   j's two products do; rows past S are zero-filled by the copy's source
//   size and masked in the scores.  Every tile is 1024-byte aligned; D 64
//   uses 40 KiB of dynamic shared memory, D 128 80 KiB.
// - Measured on an H100 (tools/k4_ablation.py, PERF.md): at hymba's shape
//   taking out the kv copies saves the most (18 %), then either product,
//   then the exponentials; issuing tile j + 1 only after tile j has landed
//   (one barrier a tile) costs the same, and the softmax's form (an FFMA
//   and a bare ex2 a score) moved the time more than any other change.
//   Masking with short-circuit branches once made ptxas split the scores
//   into 32 small branches, each under a convergence barrier, at a large
//   cost: hence the branch-free mask.  A block of two
//   warpgroups sharing each kv tile and a third stage were tried in builds
//   not kept here and were not faster, so the block stays one warpgroup:
//   at D 64 five blocks share an SM (shared memory and registers), and one
//   block's softmax runs while another's products do.
// - Not done: TMA, a producer warp, two warpgroups ping-ponging softmax
//   against products, and starting the next S product before this tile's
//   softmax, which the fastest Hopper kernels use.
// - Registers (-Xptxas -v, sm_90a, no spills): 132 at D 128, 95 at D 64,
//   106 at D 32, 105 at D 16.
//
// float32, `flash_fwd` (the small-model check and the float32 parity
// cases): products as float32 FMAs on the CUDA cores (67 TFLOP/s peak).
// Each kv tile is staged once in shared memory and read by all rows of the
// block (a warp reads at most 4 distinct float4s of a kv row, so the loads
// are broadcasts without bank conflicts); a row is split over D / 32
// threads (each owns 32 of its dims in 8 float4 groups), whose partial dot
// products meet by warp shuffles, so q and the accumulator stay in
// registers without spills; scores are taken 16 keys at a time so the
// accumulator is rescaled once per 16 keys; kv tiles wholly above the
// diagonal are never loaded; and the q tiles with the most kv tiles start
// first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;        // query rows of a block
constexpr int kChunk = 16;       // keys scored together
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
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

// -- the bfloat16 path: wgmma on the tensor cores ---------------------------

namespace tc {

// 2^x on the special-function unit, one instruction (exp2f adds a range
// check per call); -1e30 gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kThreads = 128;  // one warpgroup: 64 query rows
constexpr float kLog2e = 1.4426950408889634f;

// Head dim padded to whole 128-byte rows in shared memory, bytes of one
// 64-row tile of Q, K or V, and the block's dynamic shared memory: Q, two
// stages of K and V, and slack to align the tiles to 1024 bytes.
template <int D>
struct Tiles {
  static constexpr int kDP = D < 64 ? 64 : D;
  static constexpr int kTile = 64 * kDP * 2;
  static constexpr int kSmem = 5 * kTile + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int H, int KH,
                int causal, float scale_log2) {
  using T = Tiles<D>;
  constexpr int kDP = T::kDP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  // stage st: K at sq + (1 + 2 st) tiles, V at sq + (2 + 2 st) tiles

  // the grid's blocks in launch order take the q tiles with the most kv
  // tiles first, over all (batch, head) pairs
  const int nq = gridDim.x, hb = H * gridDim.z;
  const int lin = blockIdx.x + nq * (blockIdx.y + H * blockIdx.z);
  const int qt = nq - 1 - lin / hb;
  const int h = lin % hb % H, b = lin % hb / H;
  const int kvh = h / (H / KH);
  const int q0 = qt * 64;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KH * D;
  const __nv_bfloat16* qg = q + (int64_t)b * S * q_stride + (int64_t)h * D;
  const __nv_bfloat16* kg = k + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const __nv_bfloat16* vg = v + (int64_t)b * S * kv_stride + (int64_t)kvh * D;

  if (D < 64) {  // zero the tiles once: the copies fill D of 64 columns
    for (int e = threadIdx.x; e < 5 * T::kTile / 16; e += kThreads)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                       sq + 16 * e),
                   "r"(0)
                   : "memory");
    __syncthreads();
  }
  wg::load_rows<D, kThreads>(sq, qg, q0, S, q_stride, threadIdx.x);
  wg::cp_commit();
  const int kv_end = causal ? min(S, q0 + 64) : S;
  const int n_tiles = (kv_end + 63) / 64;
  wg::load_rows<D, kThreads>(sq + T::kTile, kg, 0, S, kv_stride,
                             threadIdx.x);
  wg::load_rows<D, kThreads>(sq + 2 * T::kTile, vg, 0, S, kv_stride,
                             threadIdx.x);
  wg::cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = q0 + 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
  const int c_lo = 2 * (lane % 4);             // columns c_lo + 8 j + {0, 1}
  float acc[kDP / 2];                          // O, f32
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // tile j + 1 in flight while j is used
      const uint32_t st = sq + (1 + 2 * ((j + 1) & 1)) * T::kTile;
      wg::load_rows<D, kThreads>(st, kg, (j + 1) * 64, S, kv_stride,
                                 threadIdx.x);
      wg::load_rows<D, kThreads>(st + T::kTile, vg, (j + 1) * 64, S,
                                 kv_stride, threadIdx.x);
      wg::cp_commit();
      wg::cp_wait<1>();
    } else {
      wg::cp_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const uint32_t sk = sq + (1 + 2 * (j & 1)) * T::kTile;
    const uint32_t sv = sk + T::kTile;

    // S = Q K^T: 64 x 64 keys, D / 16 steps along the head dim
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_regs(s);
    wg::arrive();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * wg::kBlockBytes + (kk % 4) * 32;
      wg::mma_ss_n64(s, wg::desc(sq + off, 16, 1024),
                     wg::desc(sk + off, 16, 1024), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    // scores -1e30 past S and above the diagonal, masked without branches
    // on the tiles that need it
    const int k0 = j * 64;
    if (k0 + 64 > S || (causal && k0 + 64 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + c_lo + i % 2;
        const int row = r_lo + 8 * ((i / 2) % 2);
        const bool out = (key >= S) | (causal & (key > row));
        s[i] = out ? kNegInf : s[i];
      }
    }
    // online softmax on the unscaled scores, the scale (and log2 e) folded
    // into the exponent's FFMA; a row's 16 scores of this thread meet the
    // other 48 over the 4 threads of its quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[8];  // a tree, not a chain of 16 dependent maxima
#pragma unroll
      for (int i = 0; i < 8; ++i)
        t[i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
      float mx = fmaxf(m[r], t[0]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2((m[r] - mx) * scale_log2);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      s[i] = ex2(fmaf(s[i], scale_log2, -m[r] * scale_log2));
      l[r] += s[i];  // the f32 p, before it is rounded
    }
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
    // P in bf16 as the register A of four k16 slices of keys
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = wg::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V, V [keys, D] MN-major
    wg::fence_regs(acc);
    wg::arrive();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(acc, p[kk], wg::desc(sv + kk * 2048, wg::kBlockBytes, 1024),
                    1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(acc);
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r_lo + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + ((int64_t)b * S + row) * q_stride + h * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + c_lo) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r] * inv,
                                acc[4 * jj + 2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int smem = Tiles<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64, H, B);
  flash_fwd_wgmma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H, KH, causal, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KH, int D, int causal,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    case 32:
      return launch<32>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, KH, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// o = attention(q, k, v) on `stream`: bfloat16 on the tensor-core kernel,
// float32 on the FMA kernel.  Returns the launch's CUDA error (0 when it
// was accepted); cudaErrorInvalidValue for a head dim it does not take.
// B, S, H > 0, H % KH == 0 and, for bfloat16, 16-byte aligned pointers are
// the caller's to check.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KH, int D, int causal,
                                   int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tc::dispatch(q, k, v, o, B, S, H, KH, D, causal, scale, s);
  return dispatch<float>(q, k, v, o, B, S, H, KH, D, causal, scale, s);
}
