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
// The exponent is formed only where i >= j: the upper triangle's exponents
// are positive and would overflow (the reference masks the log-decay to
// -1e30 before exp for the same reason).
//
// On the TPU each program is one grid step with its whole working set in
// VMEM.  Here each program is one thread block: C, B, cumA and dtx of the
// chunk are staged in shared memory as float32, the [q, q] score tile is
// formed there (64 KiB at q = 128), then y and S_c are read off it.  The
// inputs are read through strides: each is [G1, heads, q, x] with G = G1 *
// heads (heads = 1 for plain [G, q, x]) and any element strides, so a caller
// passes B and C of a (batch, chunk) once, expanded over its heads with
// stride 0, and dtx and cumA as transposed views, with no copies.
//
// Bound: bytes.  Each program reads dtx [q, p] and cumA [q] and writes y
// [q, p] and S_c [n, p] in float32; B and C are read once per (batch,
// chunk).  At hymba-1.5b's prefill (G = 4 * 16 * 50 = 3200, q 128, n 16,
// p 64) that is 225.5 MB, 67 us at 3.35 TB/s, against 9.2 Gflop.  What
// the design does for it: every input element is read from device memory
// once per program and the score tile never leaves the SM; B's rows are
// padded by one float so the score threads, which walk B by row, hit
// distinct banks; y and S_c are written by consecutive threads to
// consecutive addresses.  What it does not do: the heads of a (batch,
// chunk) that share B and C do not share a block, so B and C are read once
// per head (from L2 after the first), and the products run on the CUDA
// cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// shared memory a block may use on Hopper (opt-in above 48 KiB)
constexpr int kMaxSmem = 232448;

struct Strides {
  // per input: outer program, head, position, last dim (elements)
  int64_t dtx[4], b[4], c[4], a[4];
};

__global__ void __launch_bounds__(kThreads)
ssd_intra(const float* __restrict__ dtx, const float* __restrict__ bm,
          const float* __restrict__ cm, const float* __restrict__ cum,
          float* __restrict__ y, float* __restrict__ sc, Strides st,
          int heads, int q, int n, int p) {
  extern __shared__ __align__(16) float smem[];
  const int nb = n + 1;  // padded row of B and C
  float* cs = smem;               // [q, nb]
  float* bs = cs + q * nb;        // [q, nb]
  float* xs = bs + q * nb;        // [q, p]
  float* sco = xs + q * p;        // [q, q]
  float* as = sco + q * q;        // [q]  cumA
  float* seg = as + q;            // [q]  exp(cumA_last - cumA)

  const int g = blockIdx.x;
  const int64_t g1 = g / heads, hh = g % heads;
  const float* xg = dtx + g1 * st.dtx[0] + hh * st.dtx[1];
  const float* bg = bm + g1 * st.b[0] + hh * st.b[1];
  const float* cg = cm + g1 * st.c[0] + hh * st.c[1];
  const float* ag = cum + g1 * st.a[0] + hh * st.a[1];

  for (int e = threadIdx.x; e < q * n; e += kThreads) {
    const int i = e / n, k = e % n;
    bs[i * nb + k] = bg[i * st.b[2] + k * st.b[3]];
    cs[i * nb + k] = cg[i * st.c[2] + k * st.c[3]];
  }
  for (int e = threadIdx.x; e < q * p; e += kThreads) {
    const int i = e / p, c = e % p;
    xs[e] = xg[i * st.dtx[2] + c * st.dtx[3]];
  }
  for (int i = threadIdx.x; i < q; i += kThreads) as[i] = ag[i * st.a[2]];
  __syncthreads();
  const float last = as[q - 1];
  for (int i = threadIdx.x; i < q; i += kThreads) seg[i] = expf(last - as[i]);

  // score tile: thread e takes (i, j) = (e / q, e % q); only i >= j is
  // formed, the rest is 0 and never read
  for (int e = threadIdx.x; e < q * q; e += kThreads) {
    const int i = e / q, j = e % q;
    if (j > i) continue;
    const float* ci = cs + i * nb;
    const float* bj = bs + j * nb;
    float dot = 0.f;
    for (int k = 0; k < n; ++k) dot = fmaf(ci[k], bj[k], dot);
    sco[e] = dot * expf(as[i] - as[j]);
  }
  __syncthreads();

  float* yg = y + (int64_t)g * q * p;
  for (int e = threadIdx.x; e < q * p; e += kThreads) {
    const int i = e / p, c = e % p;
    const float* si = sco + i * q;
    float acc = 0.f;
    for (int j = 0; j <= i; ++j) acc = fmaf(si[j], xs[j * p + c], acc);
    yg[e] = acc;
  }
  float* sg = sc + (int64_t)g * n * p;
  for (int e = threadIdx.x; e < n * p; e += kThreads) {
    const int k = e / p, c = e % p;
    float acc = 0.f;
    for (int j = 0; j < q; ++j)
      acc = fmaf(bs[j * nb + k] * seg[j], xs[j * p + c], acc);
    sg[e] = acc;
  }
}

// Shared memory bytes one program needs (the wrapper computes the same
// figure and raises above kMaxSmem before it launches).
long long smem_bytes(int q, int n, int p) {
  return 4LL * (2LL * q * (n + 1) + (long long)q * p + (long long)q * q +
                2LL * q);
}

}  // namespace

// y [G, q, p] and S_c [G, n, p] (contiguous float32) of the intra-chunk
// step on `stream`.  `strides` is a host array of 16 element strides: dtx,
// B, C, cumA in turn, each (outer program, head, position, last dim), with
// program g = outer * heads + head.  Returns the launch's CUDA error (0 when
// it was accepted).
extern "C" int ssd_intra_chunk(const float* dtx, const float* bm,
                               const float* cm, const float* cum, float* y,
                               float* sc, const long long* strides, int G,
                               int heads, int q, int n, int p, void* stream) {
  Strides st;
  for (int k = 0; k < 4; ++k) {
    st.dtx[k] = strides[k];
    st.b[k] = strides[4 + k];
    st.c[k] = strides[8 + k];
    st.a[k] = strides[12 + k];
  }
  const long long smem = smem_bytes(q, n, p);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_intra<<<G, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      dtx, bm, cm, cum, y, sc, st, heads, q, n, p);
  return cudaGetLastError();
}
