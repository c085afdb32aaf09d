// K4's backward on the tensor cores: the gradients (dq, dk, dv) of causal
// or full grouped-query attention for bfloat16 inputs, in the design of
// FlashAttention-2/3.
//
// Replaces no TPU kernel.  The Pallas kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py is a forward only: the reference
// trains through plain jnp attention (`nn/attention.py:_sdpa_block`), and
// the port's first backward (`flash_attention_backward_plain`) was blocked
// float32 torch ops that materialise each block's [rows, S] scores in
// float32 several times over and run their products as float32 SIMT GEMMs
// off the tensor cores: 29.4 ms a call at hymba-1.5b's training shape, 43 %
// of a training step.  This kernel does the reference's mathematics at the
// reference's precision: autodiff of its graph (bf16 einsums with float32
// sums, the softmax weights cast to bf16 before P V) multiplies bf16
// operands, P and dS included, with float32 sums; here P is rounded to bf16
// before dV += P^T dO and dS before dK += dS^T Q and dQ += dS K, and every
// product runs on `wgmma` with float32 sums in registers.
//
// Layout (the forward's): q, out, dout, dq [B, S, H, D], k, v, dk, dv
// [B, S, KH, D], contiguous bf16; query head h reads kv head h / (H / KH);
// scale 1 / sqrt(D) folded into the exponent and into dq and dk.  D is 16,
// 32, 64 or 128 (16 and 32 padded to 64 columns in shared memory, as the
// forward pads them); S any length (ragged tiles masked).
//
// Bound: operations.  At hymba-1.5b's training shape ([2, 4096, 25, 64],
// KH 5, causal) the backward's four products (dV, dP, dQ, dK) are 214.8
// GFLOP, 0.217 ms at 989 TFLOP/s, against 126 MB of q, k, v, o, dO read and
// dq, dk, dv written, 0.038 ms at 3.35 TB/s.  This design recomputes S
// three times and dP twice: seven products of that size, 0.38 ms at the
// tensor rate, and three passes of exponentials over the scores.
//
// Two launches on the stream, one C call, no atomics and no scratch:
// 1. `bwd_q`, one warpgroup a (q tile of 64 rows, head, batch), the q tiles
//    with the most kv tiles first.  delta = rowsum(dO * O) from the bf16
//    output.  Pass 1 over the kv tiles at or before the diagonal: S = Q K^T
//    on `wgmma` with the forward's online max and sum (no P V) gives the
//    row log-sum-exp lse = m * scale + log(l).  Pass 2 over the same tiles:
//    S = Q K^T and dP = dO V^T (`wgmma` m64n64k16, both operands K-major in
//    shared memory), P = exp2(S scale log2 e - lse log2 e) masked to 0 above
//    the diagonal and past S, dS = P (dP - delta), and dQ += dS K with dS
//    rounded to bf16 as the register A (the accumulator's layout is the A
//    fragment's, as in the forward's P V) and the K tile MN-major.  dq is
//    written once, as bf16 with the scale folded in; lse and delta go to
//    float32 [B, H, Sp] (Sp = S rounded up to 64; 0 past S) for launch 2.
//    The forward is not changed to save lse: its launch is the prefill's.
// 2. `bwd_main`, one warpgroup a (kv tile of 64 keys, kv head, batch), the
//    kv tiles with the most q tiles first (under the causal mask the first
//    tiles see every q tile).  K and V stay in 128-byte-swizzled shared
//    memory; the block walks its group's `rep` query heads and every q tile
//    at or after its diagonal, with the Q, dO, lse and delta tiles of the
//    next step in flight (`cp.async`, two stages) while this step computes
//    S^T = K Q^T and dP^T = V dO^T (keys on the accumulator's rows), P^T
//    and dS^T in registers, then dV += P^T dO and dK += dS^T Q with P^T and
//    dS^T rounded to bf16 as the register A and dO, Q MN-major.  dK and dV
//    of the whole GQA group stay in float32 registers and are written once,
//    as bf16, dk with the scale folded in: the group sum needs no atomics
//    and no float32 dk, dv buffers.
//
// dq by a pass of its own, not by float32 reductions from launch 2 into a
// [B, S, H, D] scratch (the FlashAttention-2 way), chosen by measurement on
// an H100 at train-4k's shape: with the reductions (64 x D float32 a
// (q tile, kv tile) step, 1.7 GB to L2 a call) a call took 1.30 ms, 0.40 ms
// of it the reductions, whether issued as float2 or float4 (bytes, not
// instructions, bound them); with the pass of its own 1.09 ms (1.28 against
// 1.64 at D 128), though it recomputes S and dP.  It also keeps dq
// bit-reproducible: every sum runs in a fixed order.
//
// Registers (-Xptxas -v, sm_90a): `bwd_q` 127 at D 64, 156 at D 128;
// `bwd_main` 168 at D 64, 244 at D 128.  Shared memory: in launch 1, Q, dO
// and two stages of (K, V), 49 KiB at D 64 (four blocks an SM), 97 KiB at
// D 128; in launch 2, K, V, two stages of (Q, dO) and the row statistics,
// 50 KiB at D 64 (three blocks an SM), 98 KiB at D 128.  At train-4k's
// shape a call takes about 1.0 ms, `bwd_q` about half (PERF.md): 38 % of
// the tensor rate for its seven products, 22 % for the four counted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero_shared(uint32_t base, int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += kThreads)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                     base + 16 * e),
                 "r"(0)
                 : "memory");
}

// Head dim padded to whole 128-byte rows, bytes of one 64-row tile, and each
// launch's dynamic shared memory (six tiles, launch 2's row statistics, and
// slack to align the tiles to 1024 bytes).
template <int D>
struct Tiles {
  static constexpr int kDP = D < 64 ? 64 : D;
  static constexpr int kTile = 64 * kDP * 2;
  static constexpr int kStats = 6 * kTile;  // launch 2: lse, delta x 2
  static constexpr int kSmemQ = 6 * kTile + 1024;
  static constexpr int kSmemMain = kStats + 2 * 512 + 1024;
};

// S = A B^T over D (both K-major tiles at `a` and `b`), 64 x 64 in `s`.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * wg::kBlockBytes + (kk % 4) * 32;
    wg::mma_ss_n64(s, wg::desc(a + off, 16, 1024), wg::desc(b + off, 16, 1024),
                   kk > 0);
  }
}

// -- 1. row statistics and dq -------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_q(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
      const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
      float* __restrict__ lse, float* __restrict__ delta, int S, int H,
      int KH, int causal, float scale, float scale_log2) {
  using T = Tiles<D>;
  constexpr int kDP = T::kDP;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float delta_s[64];
  const uint32_t sq = (wg::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + T::kTile;
  // stage st: K at sq + (2 + 2 st) tiles, V one tile after it

  const int nq = gridDim.x, hb = H * gridDim.z, Sp = nq * 64;
  const int lin = blockIdx.x + nq * (blockIdx.y + H * blockIdx.z);
  const int qt = nq - 1 - lin / hb;
  const int h = lin % hb % H, b = lin % hb / H;
  const int kvh = h / (H / KH);
  const int q0 = qt * 64;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KH * D;
  const int64_t q_off = (int64_t)b * S * q_stride + (int64_t)h * D;
  const __nv_bfloat16* kg = k + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const __nv_bfloat16* vg = v + (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const int tid = threadIdx.x;

  if (D < 64) {  // the copies fill D of 64 columns
    zero_shared(sq, 6 * T::kTile);
    __syncthreads();
  }
  wg::load_rows<D, kThreads>(sq, q + q_off, q0, S, q_stride, tid);
  wg::load_rows<D, kThreads>(sdo, dout + q_off, q0, S, q_stride, tid);
  wg::cp_commit();
  const int kv_end = causal ? min(S, q0 + 64) : S;
  const int n_tiles = (kv_end + 63) / 64;
  wg::load_rows<D, kThreads>(sq + 2 * T::kTile, kg, 0, S, kv_stride, tid);
  wg::cp_commit();

  // while the copies fly: delta of the tile's rows, two threads a row
  {
    const int row = q0 + tid / 2, half = tid % 2;
    float acc = 0.f;
    if (row < S) {
      const int64_t off = q_off + (int64_t)row * q_stride + half * (D / 2);
      const uint4* og = reinterpret_cast<const uint4*>(o + off);
      const uint4* dg = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = og[c], dv = dg[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_s[tid / 2] = acc;
      delta[((int64_t)b * H + h) * Sp + q0 + tid / 2] = acc;
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + 16 * warp + lane / 4;  // rows r_lo and r_lo + 8
  const int c_lo = 2 * (lane % 4);             // columns c_lo + 8 j + {0, 1}
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[32];

  // pass 1: the rows' running max and sum
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      wg::load_rows<D, kThreads>(sq + (2 + 2 * ((j + 1) & 1)) * T::kTile, kg,
                                 (j + 1) * 64, S, kv_stride, tid);
      wg::cp_commit();
      wg::cp_wait<1>();
    } else {
      wg::cp_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const uint32_t sk = sq + (2 + 2 * (j & 1)) * T::kTile;

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_regs(s);
    wg::arrive();
    issue_scores<D>(s, sq, sk);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

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
      l[r] *= ex2((m[r] - mx) * scale_log2);
      m[r] = mx;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      l[r] += ex2(fmaf(s[i], scale_log2, -m[r] * scale_log2));
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // lse in log2 units for pass 2, in natural units for launch 2
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r_lo + 8 * r;
    lse2[r] = m[r] * scale_log2 + log2f(l[r]);
    dl[r] = delta_s[row - q0];
    if (lane % 4 == 0)
      lse[((int64_t)b * H + h) * Sp + row] = row < S ? lse2[r] * kLn2 : 0.f;
  }

  // pass 2: dQ = sum over the kv tiles of dS K
  wg::load_rows<D, kThreads>(sq + 2 * T::kTile, kg, 0, S, kv_stride, tid);
  wg::load_rows<D, kThreads>(sq + 3 * T::kTile, vg, 0, S, kv_stride, tid);
  wg::cp_commit();
  float dqa[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) dqa[i] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const uint32_t st = sq + (2 + 2 * ((j + 1) & 1)) * T::kTile;
      wg::load_rows<D, kThreads>(st, kg, (j + 1) * 64, S, kv_stride, tid);
      wg::load_rows<D, kThreads>(st + T::kTile, vg, (j + 1) * 64, S,
                                 kv_stride, tid);
      wg::cp_commit();
      wg::cp_wait<1>();
    } else {
      wg::cp_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const uint32_t sk = sq + (2 + 2 * (j & 1)) * T::kTile;
    const uint32_t sv = sk + T::kTile;

    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::arrive();
    issue_scores<D>(s, sq, sk);
    issue_scores<D>(dp, sdo, sv);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    const int k0 = j * 64;
    const bool edge = k0 + 64 > S || q0 + 64 > S || (causal && k0 + 64 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float p = ex2(fmaf(s[i], scale_log2, -lse2[r]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c_lo + i % 2;
        const int row = r_lo + 8 * r;
        const bool out = (key >= S) | (row >= S) | (causal & (key > row));
        p = out ? 0.f : p;
      }
      dp[i] = p * (dp[i] - dl[r]);
    }
    // dS in bf16 as the register A of four k16 slices of keys
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = wg::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    wg::fence_regs(dqa);
    wg::arrive();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(dqa, da[kk], wg::desc(sk + kk * 2048, wg::kBlockBytes, 1024),
                 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(dqa);
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = dq + q_off + (int64_t)row * q_stride;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj + c_lo) =
          __floats2bfloat162_rn(dqa[4 * jj + 2 * r] * scale,
                                dqa[4 * jj + 2 * r + 1] * scale);
  }
}

// -- 2. dk and dv ---------------------------------------------------------------

// At D <= 64 three blocks share an SM: registers capped at 168 (an 8-byte
// spill), 7 % faster at train-4k's shape than two blocks at 175.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
bwd_main(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
         int S, int H, int KH, int causal, float scale, float scale_log2) {
  using T = Tiles<D>;
  constexpr int kDP = T::kDP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t sb = (raw + 1023) & ~1023u;
  const uint32_t sk = sb, sv = sb + T::kTile;
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (sb - raw) + T::kStats);

  // blocks in launch order take the kv tiles with the most q tiles first
  const int nk = gridDim.x, hb = KH * gridDim.z, Sp = nk * 64;
  const int lin = blockIdx.x + nk * (blockIdx.y + KH * blockIdx.z);
  const int kt = lin / hb;
  const int kvh = lin % hb % KH, b = lin % hb / KH;
  const int rep = H / KH;
  const int k0 = kt * 64;
  const int qt0 = causal ? kt : 0, nqt = nk - qt0;
  const int n_items = rep * nqt;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KH * D;
  const int64_t kv_off = (int64_t)b * S * kv_stride + (int64_t)kvh * D;
  const int tid = threadIdx.x;

  if (D < 64) {  // the copies fill D of 64 columns
    zero_shared(sb, 6 * T::kTile);
    __syncthreads();
  }
  wg::load_rows<D, kThreads>(sk, k + kv_off, k0, S, kv_stride, tid);
  wg::load_rows<D, kThreads>(sv, v + kv_off, k0, S, kv_stride, tid);
  // step it's Q, dO, lse and delta tiles into stage it % 2
  auto issue = [&](int it) {
    const int st = it & 1;
    const int qt = qt0 + it % nqt, h = kvh * rep + it / nqt;
    const uint32_t sq = sb + (2 + 2 * st) * T::kTile;
    const int64_t off = (int64_t)b * S * q_stride + (int64_t)h * D;
    wg::load_rows<D, kThreads>(sq, q + off, qt * 64, S, q_stride, tid);
    wg::load_rows<D, kThreads>(sq + T::kTile, dout + off, qt * 64, S,
                               q_stride, tid);
    if (tid < 32) {
      const float* src = (tid < 16 ? lse : delta) +
                         ((int64_t)b * H + h) * Sp + qt * 64 + 4 * (tid % 16);
      wg::cp16(sb + T::kStats + 512 * st + 16 * tid, src, true);
    }
  };
  issue(0);
  wg::cp_commit();

  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;  // this thread's rows r_lo, r_lo + 8
  const int c_lo = 2 * (lane % 4);        // and columns c_lo + 8 j + {0, 1}
  float dka[kDP / 2], dva[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      issue(it + 1);
      wg::cp_commit();
      wg::cp_wait<1>();
    } else {
      wg::cp_wait<0>();
    }
    wg::fence_async_smem();
    __syncthreads();
    const int st = it & 1;
    const int q0 = (qt0 + it % nqt) * 64;
    const uint32_t sq = sb + (2 + 2 * st) * T::kTile, sdo = sq + T::kTile;
    const float* lse_s = stats + 128 * st;
    const float* delta_s = lse_s + 64;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg::fence_regs(s);
    wg::fence_regs(dp);
    wg::arrive();
    issue_scores<D>(s, sk, sq);
    issue_scores<D>(dp, sv, sdo);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    wg::fence_regs(dp);

    // P^T and dS^T in place of S^T and dP^T; masked entries are 0 in both
    const bool edge = k0 + 64 > S || q0 + 64 > S || (causal && q0 == k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + c_lo);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + c_lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float lse2 = (e % 2 ? ls.y : ls.x) * kLog2e;
        float p = ex2(fmaf(s[i], scale_log2, -lse2));
        if (edge) {
          const int key = k0 + r_lo + 8 * (e / 2);
          const int row = q0 + 8 * j + c_lo + e % 2;
          const bool out = (key >= S) | (row >= S) | (causal & (row < key));
          p = out ? 0.f : p;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - (e % 2 ? dl.y : dl.x));
      }
    }
    // bf16 as the register A of four k16 slices of q rows
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = wg::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = wg::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

    // dV += P^T dO, dK += dS^T Q (dO and Q MN-major)
    wg::fence_regs(dva);
    wg::fence_regs(dka);
    wg::arrive();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(dva, pa[kk], wg::desc(sdo + kk * 2048, wg::kBlockBytes, 1024),
                 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs(dka, da[kk], wg::desc(sq + kk * 2048, wg::kBlockBytes, 1024),
                 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(dva);
    wg::fence_regs(dka);
    __syncthreads();  // the next step refills this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r_lo + 8 * r;
    if (key >= S) continue;
    const int64_t off = kv_off + (int64_t)key * kv_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + c_lo) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale,
                                dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + c_lo) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                   void* delta, int B, int S, int H, int KH, int causal,
                   float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  using bf = __nv_bfloat16;
  const int nt = (S + 63) / 64;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_q<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemQ);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_main<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemMain);
  if (err != cudaSuccess) return err;
  bwd_q<D><<<dim3(nt, H, B), kThreads, T::kSmemQ, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(dout), static_cast<bf*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), S, H, KH, causal,
      scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_main<D><<<dim3(nt, KH, B), kThreads, T::kSmemMain, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf*>(dk), static_cast<bf*>(dv), S, H, KH, causal, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// (dq, dk, dv) of bf16 attention on `stream`, given the forward's output o
// and its gradient dout; lse and delta are float32 [B, H, Sp] (Sp = S
// rounded up to 64), written by the first launch and read by the second.
// Returns the first launch's CUDA error (0 when both were accepted);
// cudaErrorInvalidValue for a head dim it does not take.  B, S, H > 0,
// H % KH == 0 and 16-byte aligned pointers are the caller's to check.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int B,
                                   int S, int H, int KH, int D, int causal,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                        KH, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                        KH, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                        KH, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H,
                         KH, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
