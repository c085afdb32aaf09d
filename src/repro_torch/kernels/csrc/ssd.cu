// K5: the Mamba2 SSD intra-chunk step, for every SSM mixer of the prefill.
//
// Replaces the Pallas kernel `_ssd_kernel` in src/repro/kernels/ssd.py
// (entry `ssd_intra_chunk`).  For each program g (one batch row, chunk and
// head), with i, j over the q positions of the chunk:
//
//   scores[i, j] = (C_i . B_j) * exp(cumA_i - cumA_j)   for i >= j, else 0
//   y[i]         = sum_j scores[i, j] * dtx[j]                  [q, p]
//   S_c          = sum_j exp(cumA_last - cumA_j) B_j dtx_j^T    [n, p]
//
// The inputs are read through strides: each is [G1, heads, q, x] with
// G = G1 * heads (heads = 1 for plain [G, q, x]) and any element strides,
// so a caller passes B and C of a (batch, chunk) once, expanded over its
// heads with stride 0, and dtx and cumA as transposed views, with no copies.
//
// Head groups.  One block of 8 warps takes one outer program g1 (a batch
// row and chunk) and a group of its heads.  When B and C are the same for
// every head (head stride 0) it stages them once and forms the lower
// triangle of C B^T once for the group; then, head by head, it applies the
// head's decay and mask and does the two products.  The group size comes
// from a cost model of the launch (`pick_group`): waves of blocks (the
// blocks an SM holds from the occupancy API) times a block's work.  At
// hymba-1.5b's prefill it picks 13 heads, 256 blocks, two to an SM.  Heads
// with their own B or C take one head a block.  A head's dtx and cumA are
// copied in with cp.async while the block works on the head before it (two
// buffers).  The warps share a head's work as 16-row tiles of y and of S_c
// by 32 columns, longest first onto the least loaded warp (`make_plan`).
//
// Products on the tensor cores, float32-accurate.  All three products (C
// B^T, scores dtx and S_c) run as mma.sync m16n8k8 TF32 with the 3xTF32
// split: each float32 operand is a = hi + lo, hi = a with its low 13
// mantissa bits cleared (a TF32 value) and lo = a - hi, cleared the same
// way; lo hi + hi lo + hi hi accumulate in float32.  That leaves each
// product within 3 x 2^-20 of its value (relative), against 2^-9 for one TF32
// pass, and the sums within what float32 sums alone give
// (tests/test_torch_ssd.py emulates both).  No product stays on the CUDA
// cores.
//
// Layout.  C B^T's tiles, B^T and (while C B^T is formed) C sit in shared
// memory as 16 x 8 tiles in the order a warp loads them as mma operands,
// one 16-byte load a lane.  A warp's 32-column output chunk is four 8-wide
// tiles whose column n is column 4 n + tile, so a lane reads its operands
// of all four from dtx as two 16-byte loads and writes y and S_c as 16-byte
// stores; dtx rows are swizzled (16-byte chunk k of row j at k ^ 2 (j % 4))
// so those loads hit every bank.  Score tiles above the diagonal are never
// formed: C B^T keeps the tiles on or below it, and the products with dtx
// stop there.  Ragged q, n and p are padded with zeros in shared memory (q
// to 16, n to 16, p to 32) and masked at the stores.
//
// Bound: bytes.  Each head reads dtx [q, p] and cumA [q] and writes y
// [q, p] and S_c [n, p] in float32; B and C are read once per (batch,
// chunk).  At hymba-1.5b's prefill (G = 4 * 16 * 50 = 3200, q 128, n 16,
// p 64) that is 225.5 MB, 67 us at 3.35 TB/s; its products are 4.24 Gflop,
// 12.7 Gflop as TF32, 26 us at 495 TFLOP/s.  What it does not do yet: the
// operands are split again at every use (dtx once for each row tile that
// reads it), the products are warp-level mma.sync (tools/mma_rate.py
// measures 301 TFLOP/s of it for TF32 on an H100, not wgmma's 495), and
// the elementwise passes that form dtx and cumA and lay out y stay in
// nn/ssm.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"  // smem_addr, cp16, cp_commit, cp_wait

namespace {

using wg::cp16;
using wg::cp_commit;
using wg::cp_wait;
using wg::smem_addr;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// shared memory a block may use on Hopper (opt-in above 48 KiB)
constexpr int kMaxSmem = 232448;
constexpr int kMaxQ = 128, kMaxN = 128, kMaxP = 128;
// 8-column output tiles of one work item
constexpr int kTiles = 4;
// work items: (row tiles of y + row tiles of S_c) x column chunks
constexpr int kMaxItems = 2 * (kMaxQ / 16) * (kMaxP / 8 / kTiles);

struct Strides {
  // per input: outer program, head, position, last dim (elements)
  int64_t dtx[4], b[4], c[4], a[4];
};

// Padded sizes of one launch (elements).
struct Dims {
  int q, n, p;
  int qp, np, pp;  // q to 16, n to 16, p to whole items (8 kTiles)
  int rt, kb;      // 16-row tiles of q, 8-column steps that reach q
  int cb_tiles;    // 16 x 8 score tiles on or below the diagonal
  int x_floats;    // the two dtx buffers, which first hold C
};

Dims dims_of(int q, int n, int p) {
  Dims d;
  d.q = q, d.n = n, d.p = p;
  d.qp = (q + 15) / 16 * 16;
  d.np = (n + 15) / 16 * 16;
  d.pp = (p + 8 * kTiles - 1) / (8 * kTiles) * (8 * kTiles);
  d.rt = d.qp / 16;
  d.kb = (q + 7) / 8;
  d.cb_tiles = d.rt * (d.rt + 1);
  d.x_floats = std::max(2 * d.qp * d.pp, d.qp * d.np);
  return d;
}

// The score tiles, B^T, two dtx buffers (C first) and two cumA buffers.
long long smem_floats(const Dims& d) {
  return 128LL * d.cb_tiles + (long long)d.np * d.qp + d.x_floats + 2LL * d.qp;
}

// Where element (row, col) of an operand stored in mma order lies: 16 x 8
// tiles, `tiles8` to a row of tiles, each 128 floats with lane l's a0..a3
// at 4 l (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), so a
// warp loads one tile as one 16-byte load a lane.
__device__ __forceinline__ int frag_at(int row, int col, int tiles8) {
  return ((row >> 4) * tiles8 + (col >> 3)) * 128 +
         4 * (4 * (row & 7) + (col & 3)) + ((row >> 3) & 1) + 2 * ((col >> 2) & 1);
}

// Where element (j, c) of a dtx tile lies: rows of pp floats, 16-byte
// chunk k of row j at chunk k ^ 2 (j % 4), which spreads the 16-byte loads
// of rows t and columns 4 g (mma3) over all banks.
__device__ __forceinline__ int x_at(int j, int c, int pp) {
  return j * pp + ((((c >> 2) ^ ((j & 3) << 1))) << 2) + (c & 3);
}

// Each warp's work items for one head: code (kind << 7) | (tile << 3) |
// chunk, kind 0 a 16-row tile of y, 1 a 16-row tile of S_c; items of warp
// w are item[start[w] .. start[w + 1]).
struct Plan {
  uint8_t item[kMaxItems];
  uint8_t start[kWarps + 1];
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// e^x as 2^(x log2 e) on the SFU, flushing results below 2^-126 to 0
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// a = hi + lo + (below 2^-20 |a|): hi is a with its low 13 mantissa bits
// cleared (a TF32 value), lo the exact rest with its own cleared
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of m16n8k8 split for three TF32 products.  Fragments
// (lane = 4 g + t): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2t), d1 (g, 2t + 1), d2
// (g + 8, 2t), d3 (g + 8, 2t + 1).
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ SplitA(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// acc[nt] += a b_nt over the four 8-column tiles of a 32-column chunk of a
// row-major operand, as lo hi + hi lo + hi hi; the tiles interleave, so no
// product waits on the last.  Column n of tile nt is column 4 n + nt of
// the chunk, so lane (g, t) reads its b0 and b1 of all four tiles as two
// 16-byte loads: rows t and t + 4, columns 4 g .. 4 g + 3 (`x` points at
// row t, column 4 g; rows `ld` apart).
__device__ __forceinline__ void mma3(float (&acc)[kTiles][4], const SplitA& a,
                                     const float* x, int ld) {
  static_assert(kTiles == 4, "a lane's four columns are one 16-byte load");
  const float4 r0 = *reinterpret_cast<const float4*>(x);
  const float4 r1 = *reinterpret_cast<const float4*>(x + 4 * ld);
  const float b0[4] = {r0.x, r0.y, r0.z, r0.w};
  const float b1[4] = {r1.x, r1.y, r1.z, r1.w};
  uint32_t bh[kTiles][2], bl[kTiles][2];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    split(b0[nt], bh[nt][0], bl[nt][0]);
    split(b1[nt], bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) mma(acc[nt], a.lo, bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) mma(acc[nt], a.hi, bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) mma(acc[nt], a.hi, bh[nt][0], bh[nt][1]);
}

// y or S_c rows (r0, r0 + 8) of an item's accumulators (columns as mma3
// maps them: lane (g, t) holds columns c0 + 8 t .. c0 + 8 t + 7 of both
// rows), masked to [rows, p); `out` is the program's [rows, p] output.
__device__ __forceinline__ void store_tiles(float* out, const float (&acc)[kTiles][4],
                                            int r0, int rows, int c0, int p,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c = c0 + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows || c >= p) continue;
    float* o = out + (int64_t)r * p + c;
    const float v[8] = {acc[0][2 * h], acc[1][2 * h], acc[2][2 * h], acc[3][2 * h],
                        acc[0][2 * h + 1], acc[1][2 * h + 1], acc[2][2 * h + 1],
                        acc[3][2 * h + 1]};
    if ((p & 3) == 0) {  // c + 3 < p, and c + 7 < p once c + 4 < p
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      if (c + 4 < p) *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + i < p) o[i] = v[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_intra(const float* __restrict__ dtx, const float* __restrict__ bm,
          const float* __restrict__ cm, const float* __restrict__ cum,
          float* __restrict__ y, float* __restrict__ sc, Strides st, Dims d,
          Plan plan, int heads, int group, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* cbt = smem;                           // C B^T tiles, mma order
  float* bfr = cbt + 128 * d.cb_tiles;         // B^T [np, qp], mma order
  float* xs0 = bfr + d.np * d.qp;              // dtx [qp, pp], swizzled
  float* xs1 = xs0 + d.qp * d.pp;              // dtx [qp, pp], swizzled
  float* cfr = xs0;                            // C [qp, np], mma order, first
  float* as0 = xs0 + d.x_floats;               // [qp] cumA
  float* as1 = as0 + d.qp;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = d.q, n = d.n, p = d.p;
  const int groups = (heads + group - 1) / group;
  const int64_t g1 = blockIdx.x / groups;
  const int head0 = (blockIdx.x % groups) * group;
  const int nh = min(group, heads - head0);

  // dtx and cumA of head `hh` (of this block) into buffer `buf`: only the
  // [q, p] and [q] parts, so the zero padding written once stays
  auto fetch = [&](int hh, int buf) {
    const int64_t head = head0 + hh;
    const float* xg = dtx + g1 * st.dtx[0] + head * st.dtx[1];
    const float* ag = cum + g1 * st.a[0] + head * st.a[1];
    float* xs = buf ? xs1 : xs0;
    float* as = buf ? as1 : as0;
    // element (row j, column c) of the [q, per] copies a thread makes,
    // stepped by kThreads without a division
    const int per = vec ? p / 4 : p, dj = kThreads / per, dc = kThreads % per;
    for (int j = tid / per, c = tid % per; j < q;) {
      if (vec) {
        cp16(smem_addr(xs + x_at(j, 4 * c, d.pp)), xg + j * st.dtx[2] + 4 * c, true);
      } else {
        cp4(smem_addr(xs + x_at(j, c, d.pp)), xg + j * st.dtx[2] + c * st.dtx[3]);
      }
      c += dc, j += dj;
      if (c >= per) c -= per, ++j;
    }
    for (int j = tid; j < q; j += kThreads) cp4(smem_addr(as + j), ag + j * st.a[2]);
    cp_commit();
  };
  auto zero_pad = [&](float* xs) {
    for (int e = tid; e < d.qp * d.pp; e += kThreads) {
      const int j = e / d.pp, c = e % d.pp;
      if (j >= q || c >= p) xs[x_at(j, c, d.pp)] = 0.f;
    }
  };

  // B^T and C of the group's first head (the same for all of them when the
  // group has more than one), zero-padded, in mma order: B^T [np, qp] is
  // S_c's a operand, C [qp, np] C B^T's (C B^T's b operand is read from
  // B^T's tiles)
  const float* bg = bm + g1 * st.b[0] + head0 * st.b[1];
  {
    const float* cg = cm + g1 * st.c[0] + head0 * st.c[1];
    for (int e = tid; e < d.qp * d.np; e += kThreads) {
      const int i = e / d.np, k = e % d.np;
      const bool in = i < q && k < n;
      bfr[frag_at(k, i, d.qp / 8)] = in ? bg[i * st.b[2] + k * st.b[3]] : 0.f;
      cfr[frag_at(i, k, d.np / 8)] = in ? cg[i * st.c[2] + k * st.c[3]] : 0.f;
    }
  }
  for (int j = q + tid; j < d.qp; j += kThreads) as0[j] = as1[j] = 0.f;
  __syncthreads();

  // C B^T, the 16 x 8 tiles (r, kb) with kb <= 2r + 1 that reach q; each
  // stored masked (j > i -> 0) in mma order, tile (r, kb) at r (r + 1) + kb
  {
    const float4* cfr4 = reinterpret_cast<const float4*>(cfr);
    int tile = 0;
    for (int r = 0; r < d.rt; ++r) {
      for (int kb = 0; kb <= 2 * r + 1; ++kb, ++tile) {
        if (tile % kWarps != warp || kb >= d.kb) continue;
        // one accumulator per product, so the k-steps' products overlap
        float acc[3][4] = {};
        for (int ks = 0; ks < d.np / 8; ++ks) {
          const float4 c = cfr4[(r * (d.np / 8) + ks) * 32 + lane];
          const SplitA a(c.x, c.y, c.z, c.w);
          uint32_t bh0, bl0, bh1, bl1;
          split(bfr[frag_at(8 * ks + t, 8 * kb + g, d.qp / 8)], bh0, bl0);
          split(bfr[frag_at(8 * ks + t + 4, 8 * kb + g, d.qp / 8)], bh1, bl1);
          mma(acc[0], a.lo, bh0, bh1);
          mma(acc[1], a.hi, bl0, bl1);
          mma(acc[2], a.hi, bh0, bh1);
        }
        float* dst = cbt + tile * 128;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = g + 8 * (e >> 1), cc = 2 * t + (e & 1);
          const bool keep = 8 * kb + cc <= 16 * r + rr;
          dst[frag_at(rr, cc, 1)] = keep ? (acc[0][e] + acc[1][e]) + acc[2][e] : 0.f;
        }
      }
    }
  }
  __syncthreads();  // C is dead: its space holds dtx from here
  zero_pad(xs0);
  if (nh > 1) zero_pad(xs1);
  fetch(0, 0);

  for (int hh = 0; hh < nh; ++hh) {
    const int buf = hh & 1;
    cp_wait<0>();
    __syncthreads();  // head hh has landed; every warp is done with hh - 1
    if (hh + 1 < nh) fetch(hh + 1, buf ^ 1);
    const float* xs = buf ? xs1 : xs0;
    const float* as = buf ? as1 : as0;
    const int64_t prog = g1 * heads + head0 + hh;
    float* yg = y + prog * q * p;
    float* sg = sc + prog * n * p;
    const float4* cbt4 = reinterpret_cast<const float4*>(cbt);

    for (int it = plan.start[warp]; it < plan.start[warp + 1]; ++it) {
      const int code = plan.item[it];
      const int tile = (code >> 3) & 7, chunk = code & 7;
      const int c0 = chunk * kTiles * 8;
      const float* xc = xs + x_at(t, c0 + 4 * g, d.pp);  // b0s of step 0
      float acc[kTiles][4] = {};
      if (code < 0x80) {
        // y rows 16 tile + (g, g + 8): scores (decayed C B^T) times dtx,
        // k-steps up to the diagonal
        const int i0 = 16 * tile + g, i1 = i0 + 8;
        const float ci0 = as[i0], ci1 = as[i1];
        const int steps = min(2 * tile + 2, d.kb);
        const int base = tile * (tile + 1);
        auto step = [&](int kb, bool diagonal) {
          const float4 v = cbt4[(base + kb) * 32 + lane];
          const int j0 = 8 * kb + t, j1 = j0 + 4;
          const float cj0 = as[j0], cj1 = as[j1];
          float e0 = ci0 - cj0, e1 = ci1 - cj0, e2 = ci0 - cj1, e3 = ci1 - cj1;
          if (diagonal) {  // exp only where j <= i (the rest of v is 0)
            e0 = j0 <= i0 ? e0 : neg_inf();
            e1 = j0 <= i1 ? e1 : neg_inf();
            e2 = j1 <= i0 ? e2 : neg_inf();
            e3 = j1 <= i1 ? e3 : neg_inf();
          }
          const SplitA a(v.x * exp_approx(e0), v.y * exp_approx(e1),
                         v.z * exp_approx(e2), v.w * exp_approx(e3));
          mma3(acc, a, xc + 8 * kb * d.pp, d.pp);
        };
        const int below = min(2 * tile, steps);  // tiles left of the diagonal
#pragma unroll 2
        for (int kb = 0; kb < below; ++kb) step(kb, false);
        for (int kb = below; kb < steps; ++kb) step(kb, true);
        store_tiles(yg, acc, 16 * tile, q, c0, p, lane);
      } else {
        // S_c rows 16 tile + (g, g + 8): (B decayed to the chunk's end)^T
        // times dtx over every position
        const float last = as[q - 1];
        const float4* b4 = reinterpret_cast<const float4*>(bfr) + tile * (d.qp / 8) * 32 + lane;
#pragma unroll 2
        for (int kb = 0; kb < d.kb; ++kb) {
          const float4 v = b4[kb * 32];
          const float s0 = exp_approx(last - as[8 * kb + t]);
          const float s1 = exp_approx(last - as[8 * kb + t + 4]);
          const SplitA a(v.x * s0, v.y * s0, v.z * s1, v.w * s1);
          mma3(acc, a, xc + 8 * kb * d.pp, d.pp);
        }
        store_tiles(sg, acc, 16 * tile, n, c0, p, lane);
      }
    }
  }
}

// The warps' work items for one head, longest first onto the least loaded
// warp; returns the most k-steps x tiles any warp does (a head's time).
int make_plan(const Dims& d, Plan* plan) {
  const int chunks = d.pp / (8 * kTiles);
  int cost[kMaxItems], code[kMaxItems], order[kMaxItems], m = 0;
  for (int kind = 0; kind < 2; ++kind) {
    const int rows = kind ? d.np / 16 : d.rt;
    for (int r = 0; r < rows; ++r) {
      for (int c = 0; c < chunks; ++c, ++m) {
        const int steps = kind ? d.kb : std::min(2 * r + 2, d.kb);
        cost[m] = steps * kTiles;
        code[m] = (kind << 7) | (r << 3) | c;
        order[m] = m;
      }
    }
  }
  std::stable_sort(order, order + m, [&](int a, int b) { return cost[a] > cost[b]; });
  int load[kWarps] = {}, owner[kMaxItems];
  for (int i = 0; i < m; ++i) {
    const int w = std::min_element(load, load + kWarps) - load;
    owner[order[i]] = w;
    load[w] += cost[order[i]];
  }
  int k = 0;
  for (int w = 0; w < kWarps; ++w) {
    plan->start[w] = k;
    for (int i = 0; i < m; ++i)
      if (owner[order[i]] == w) plan->item[k++] = code[order[i]];
  }
  plan->start[kWarps] = k;
  return *std::max_element(load, load + kWarps);
}

// Heads a block takes when B and C are shared: the fewest waves of blocks
// times a block's time, counted in k-steps x tiles of its warps (C B^T
// once, each head's items, and the block's start, about half a head).
int pick_group(const Dims& d, int head_cost, int G1, int heads, int slots) {
  const int cb_steps = (d.cb_tiles + kWarps - 1) / kWarps * (d.np / 8);
  long long best = -1;
  int pick = 1;
  for (int grp = 1; grp <= heads; ++grp) {
    const long long blocks = (long long)G1 * ((heads + grp - 1) / grp);
    const long long waves = (blocks + slots - 1) / slots;
    const long long cost = waves * (cb_steps + head_cost / 2 + (long long)grp * head_cost);
    if (best < 0 || cost < best) best = cost, pick = grp;
  }
  return pick;
}

}  // namespace

// y [G, q, p] and S_c [G, n, p] (contiguous float32) of the intra-chunk
// step on `stream`, with `group` heads a block (0: chosen here).  `strides`
// is a host array of 16 element strides: dtx, B, C, cumA in turn, each
// (outer program, head, position, last dim), with program g = outer *
// heads + head.  Takes q, n, p up to 128 within kMaxSmem bytes of shared
// memory.  Returns the launch's CUDA error (0 when it was accepted).
extern "C" int ssd_intra_chunk_group(const float* dtx, const float* bm,
                                     const float* cm, const float* cum,
                                     float* y, float* sc,
                                     const long long* strides, int G,
                                     int heads, int q, int n, int p, int group,
                                     void* stream) {
  Strides st;
  for (int k = 0; k < 4; ++k) {
    st.dtx[k] = strides[k];
    st.b[k] = strides[4 + k];
    st.c[k] = strides[8 + k];
    st.a[k] = strides[12 + k];
  }
  if (q < 1 || q > kMaxQ || n < 1 || n > kMaxN || p < 1 || p > kMaxP ||
      heads < 1 || G % heads || group < 0)
    return cudaErrorInvalidValue;
  const Dims d = dims_of(q, n, p);
  const long long smem = 4 * smem_floats(d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of L1 as shared memory, so two blocks fit where their sizes allow
  err = cudaFuncSetAttribute(ssd_intra,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  Plan plan;
  const int head_cost = make_plan(d, &plan);
  const int G1 = G / heads;
  const bool shared = st.b[1] == 0 && st.c[1] == 0;
  if (!shared) {
    group = 1;
  } else if (group == 0) {
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssd_intra,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    group = pick_group(d, head_cost, G1, heads, sms * std::max(per_sm, 1));
  }
  group = std::min(group, heads);
  const int vec = st.dtx[3] == 1 && p % 4 == 0 && st.dtx[0] % 4 == 0 &&
                  st.dtx[1] % 4 == 0 && st.dtx[2] % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(dtx) % 16 == 0;
  const long long blocks = (long long)G1 * ((heads + group - 1) / group);
  ssd_intra<<<(unsigned)blocks, kThreads, (size_t)smem,
              static_cast<cudaStream_t>(stream)>>>(dtx, bm, cm, cum, y, sc, st,
                                                   d, plan, heads, group, vec);
  return cudaGetLastError();
}

// The same with the group chosen here.
extern "C" int ssd_intra_chunk(const float* dtx, const float* bm,
                               const float* cm, const float* cum, float* y,
                               float* sc, const long long* strides, int G,
                               int heads, int q, int n, int p, void* stream) {
  return ssd_intra_chunk_group(dtx, bm, cm, cum, y, sc, strides, G, heads, q,
                               n, p, 0, stream);
}
