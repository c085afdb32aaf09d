// The Mamba2 mixer's elementwise passes around K5, fused into two kernels.
//
// Port-only: the JAX package (src/repro/nn/ssm.py) writes these passes as
// jnp ops that XLA fuses, and has no Pallas kernel for them.  On the card
// the same ops ran as some 30 float32 and bf16 torch passes a layer, many
// of them on strided slices, and took most of the mixer's time.
//
// The activations are of one type T (bf16 or float32, `dtype` 0 or 1);
// every weight comes as float32; the arithmetic is float32.
//
// ssm_prologue: from in_proj's output, xBC [b, l, di + 2 n] and dt [b, l,
// h] (each with a token stride of its own, di = h p), to K5's inputs.  The
// depthwise causal conv over the K taps (zero rows before each row's first
// position), its bias and SiLU, accumulated in float32 and rounded once to
// T; dt = softplus(dt + dt_bias); cumA, the inclusive sum of -exp(A_log) dt
// over each chunk's q positions, in position order.  Writes
//   dtx  [b nc, h, q, p]  float32, float(x) dt
//   B, C [b nc, q, n]     float32, the conv's rounded outputs widened
//   cumA [b nc, h, q]     float32
//   x    [b, l, di]       T, for the epilogue's D x
// A block takes 32 positions of one (row, chunk) and 128 conv channels; a
// thread one channel over those positions, the K - 1 raw values before
// each position kept in registers, the next 8 positions loaded ahead.
// The block first forms softplus(dt) of its heads in shared memory, from
// the chunk's first position to its own last; each thread then sums its
// head's cumA in position order from the chunk's start.
//
// ssm_epilogue: from K5's y_intra [b nc h, q, p], the inter-chunk product
// C S_in (any strides, indexed [b, nc, q, h, p]), cumA and x to out_proj's
// input, one token a block and every channel of it, since the RMSNorm
// spans di (a thread's channels step by the block's width, so their heads
// and positions step without a division):
//   y   = y_intra + exp(cumA) (C S_in) + D x
//   g   = y silu(z)
//   out = g rsqrt(sum(g^2) / di_norm + eps) norm        (T)
// float32 throughout, one rounding at the store.  A thread keeps its V
// channels in registers between the sum of squares and the store; the sum
// goes over the block in a fixed order, so a run repeats bit for bit.
// Where the heads are split over ranks (a tensor-parallel layout) the sum
// spans them: `mode` 1 writes each token's own sum to `ss` and stops, the
// caller adds the ranks' sums, and `mode` 2 takes the total from `ss`;
// `mode` 0 is the one launch of the whole row.  The mode is a template
// argument, so the whole row's kernel reads no mode.
//
// Bound: bytes.  At hymba-1.5b's prefill (di 3200, n 16, h 50) the
// prologue reads 6.5 KB a token and writes 19.5 KB; the epilogue reads
// 38.6 KB and writes 6.4 KB.  On one H100 at a 16,384-token step they run
// at 58 % and 73 % of 3.35 TB/s (granite-4.0-h-small's widths: 62 % and
// 62 %); the torch ops they replace take 8-16 times as long.  Not done: two
// channels a thread (4-byte loads of bf16 pairs); loading 16 positions
// ahead instead of 8 gained nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPThreads = 128;  // conv channels a prologue block
constexpr int kPos = 32;        // positions a prologue block
constexpr int kAhead = 8;       // positions a prologue thread loads ahead
constexpr int kMaxK = 4;
constexpr int kMaxDi = 32768;
constexpr int kDefaultSmem = 48 * 1024;

__device__ inline float to_f(bf16 v) { return __bfloat162float(v); }
__device__ inline float to_f(float v) { return v; }

template <typename T>
__device__ inline T from_f(float v);
template <>
__device__ inline bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ inline float from_f<float>(float v) { return v; }

template <typename T>
struct PrologueArgs {
  const T* xbc;  // [b, l, di + 2 n], token stride ld_xbc
  long long ld_xbc;
  const T* dt;  // [b, l, h], token stride ld_dt
  long long ld_dt;
  const float* conv_w;  // [K, C]
  const float* conv_b;  // [C]
  const float* dt_bias;
  const float* a_log;
  float* dtx;
  float* bm;
  float* cm;
  float* cum;
  T* x;
  int l, nc, q, h, p, n;
};

// Heads whose x channels lie in channel tile [ch0, ch0 + kPThreads): first
// and count (0 for a tile of B and C channels only).
__host__ __device__ inline void tile_heads(int ch0, int di, int p, int* h0,
                                           int* nh) {
  if (ch0 >= di) {
    *h0 = 0, *nh = 0;
    return;
  }
  const int end = ch0 + kPThreads < di ? ch0 + kPThreads : di;
  *h0 = ch0 / p;
  *nh = (end - 1) / p + 1 - *h0;
}

template <typename T, int K>
__global__ void __launch_bounds__(kPThreads, 8)
    ssm_prologue_kernel(PrologueArgs<T> a) {
  extern __shared__ float sdt[];  // softplus(dt), [positions][nh]
  const int di = a.h * a.p, C = di + 2 * a.n;
  const int tiles = (a.q + kPos - 1) / kPos;
  const int g = blockIdx.x / tiles, row = g / a.nc, c = g - row * a.nc;
  const int i0 = (blockIdx.x - g * tiles) * kPos;
  const int i1 = i0 + kPos < a.q ? i0 + kPos : a.q;
  const int ch0 = blockIdx.y * kPThreads, ch = ch0 + threadIdx.x;
  const long long tok0 = (long long)row * a.l + (long long)c * a.q;
  int h0, nh;
  tile_heads(ch0, di, a.p, &h0, &nh);
  // softplus(dt) of the tile's heads at the chunk's positions up to i1:
  // those before i0 start the tile's cumA
  const T* dts = a.dt + tok0 * a.ld_dt;
  for (int e = threadIdx.x; e < i1 * nh; e += kPThreads) {
    const int i = e / nh, hh = h0 + (e - i * nh);
    const float v = to_f(dts[(long long)i * a.ld_dt + hh]) + a.dt_bias[hh];
    sdt[e] = v > 20.f ? v : log1pf(expf(v));  // F.softplus, threshold 20
  }
  __syncthreads();
  if (ch >= C) return;

  float w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = a.conv_w[(long long)k * C + ch];
  const float bias = a.conv_b[ch];
  const T* __restrict__ src = a.xbc + (tok0 + i0) * a.ld_xbc + ch;
  // the K - 1 raw values before the position, zeros before the row's start
  float win[K > 1 ? K - 1 : 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int back = K - 1 - j;
    win[j] = (long long)c * a.q + i0 >= back
                 ? to_f(src[-(long long)back * a.ld_xbc])
                 : 0.f;
  }
  const bool is_x = ch < di;
  const int hh = is_x ? ch / a.p : 0, pp = ch - hh * a.p, hl = hh - h0;
  const float neg_a = is_x ? -expf(a.a_log[hh]) : 0.f;
  const long long head_row = ((long long)g * a.h + hh) * a.q + i0;
  float* __restrict__ dtx = a.dtx + head_row * a.p + pp;
  float* __restrict__ cum_out = a.cum + head_row;
  T* __restrict__ x = a.x + (tok0 + i0) * di + ch;
  float* __restrict__ bc = nullptr;  // a B or C channel's column
  float cum = 0.f;
  if (is_x) {
    for (int i = 0; i < i0; ++i) cum += neg_a * sdt[i * nh + hl];
  } else {
    const int j = ch - di;
    bc = (j < a.n ? a.bm + j : a.cm + (j - a.n)) +
         ((long long)g * a.q + i0) * a.n;
  }
  for (int ib = i0; ib < i1; ib += kAhead) {
    float raw[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      raw[u] = ib + u < i1 ? to_f(src[(long long)u * a.ld_xbc]) : 0.f;
    src += (long long)kAhead * a.ld_xbc;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = ib + u;
      if (i >= i1) break;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K - 1; ++k) acc = fmaf(win[k], w[k], acc);
      acc = fmaf(raw[u], w[K - 1], acc);
      if constexpr (K > 1) {
#pragma unroll
        for (int k = 0; k + 1 < K - 1; ++k) win[k] = win[k + 1];
        win[K - 2] = raw[u];
      }
      acc += bias;
      const T r = from_f<T>(acc / (1.f + expf(-acc)));
      const float xv = to_f(r);
      if (is_x) {
        const float dt = sdt[i * nh + hl];
        cum += neg_a * dt;
        *x = r;
        *dtx = xv * dt;
        if (pp == 0) *cum_out = cum;
        x += di, dtx += a.p, ++cum_out;
      } else {
        *bc = xv;
        bc += a.n;
      }
    }
  }
}

template <typename T>
struct EpilogueArgs {
  const float* y;   // K5's y_intra [b nc h, q, p]
  const float* cs;  // C S_in, strides below in [b, nc, q, h, p] order
  long long cs_st[5];
  const float* cum;  // [b nc, h, q]
  const T* x;        // [b, l, di]
  const T* z;        // row (token) stride z_ld
  long long z_ld;
  const float* d;
  const float* norm;
  float* ss;  // [b l]: mode 1 writes the token's sum, mode 2 reads it
  T* out;     // [b, l, di]
  int l, nc, q, h, p;
  float di_norm, eps;
};

template <typename T, int V, int Th, int Mode>
__global__ void __launch_bounds__(Th) ssm_epilogue_kernel(EpilogueArgs<T> a) {
  __shared__ float part[32];
  const int di = a.h * a.p;
  const long long tok = blockIdx.x;
  const int row = (int)(tok / a.l), t = (int)(tok - (long long)row * a.l);
  const int c = t / a.q, i = t - c * a.q;
  const long long g = (long long)row * a.nc + c;
  // the token's rows, at head 0: y_intra and cumA (head strides q p and
  // q), C S_in, x and z
  const float* __restrict__ y = a.y + (g * a.h * a.q + i) * a.p;
  const float* __restrict__ cum = a.cum + g * a.h * a.q + i;
  const float* __restrict__ cs =
      a.cs + row * a.cs_st[0] + c * a.cs_st[1] + i * a.cs_st[2];
  const T* __restrict__ x = a.x + tok * di;
  const T* __restrict__ z = a.z + tok * a.z_ld;
  const int hqp = a.q * a.p;
  // channel threadIdx.x + k Th: head hh, position pp, stepped by (Th / p,
  // Th % p) from k to k + 1
  int hh = threadIdx.x / a.p, pp = threadIdx.x - hh * a.p;
  const int dh = Th / a.p, dp = Th - dh * a.p;
  float v[V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = threadIdx.x + k * Th;
    v[k] = 0.f;
    if (ch < di) {
      const float yv = y[hh * hqp + pp] +
                       cs[hh * a.cs_st[3] + pp * a.cs_st[4]] *
                           expf(cum[hh * a.q]) +
                       a.d[hh] * to_f(x[ch]);
      const float zv = to_f(z[ch]);
      v[k] = yv * (zv / (1.f + expf(-zv)));
      ss += v[k] * v[k];
    }
    pp += dp, hh += dh;
    if (pp >= a.p) pp -= a.p, ++hh;
  }
  float total;
  if constexpr (Mode == 2) {
    total = a.ss[tok];
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    total = 0.f;
    for (int w = 0; w < Th / 32; ++w) total += part[w];
    if constexpr (Mode == 1) {
      if (threadIdx.x == 0) a.ss[tok] = total;
      return;
    }
  }
  const float r = rsqrtf(total / a.di_norm + a.eps);
  T* __restrict__ out = a.out + tok * di;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = threadIdx.x + k * Th;
    if (ch < di) out[ch] = from_f<T>(v[k] * r * a.norm[ch]);
  }
}

template <typename T>
void* prologue_for(int K) {
  switch (K) {
    case 1: return (void*)ssm_prologue_kernel<T, 1>;
    case 2: return (void*)ssm_prologue_kernel<T, 2>;
    case 3: return (void*)ssm_prologue_kernel<T, 3>;
    default: return (void*)ssm_prologue_kernel<T, 4>;
  }
}

template <typename T>
int prologue_launch(const void* xbc, long long ld_xbc, const void* dt,
                    long long ld_dt, const float* conv_w,
                    const float* conv_b, const float* dt_bias,
                    const float* a_log, float* dtx, float* bm, float* cm,
                    float* cum, void* x, int b, int l, int q, int h, int p,
                    int n, int K, cudaStream_t stream) {
  const int di = h * p, C = di + 2 * n;
  int nh = 0;
  for (int ch0 = 0; ch0 < di; ch0 += kPThreads) {
    int h0, k;
    tile_heads(ch0, di, p, &h0, &k);
    nh = k > nh ? k : nh;
  }
  const size_t smem = sizeof(float) * (size_t)q * nh;
  const int tiles = (q + kPos - 1) / kPos;
  void* fn = prologue_for<T>(K);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  PrologueArgs<T> a{static_cast<const T*>(xbc), ld_xbc,
                    static_cast<const T*>(dt), ld_dt, conv_w, conv_b,
                    dt_bias, a_log, dtx, bm, cm, cum, static_cast<T*>(x),
                    l, l / q, q, h, p, n};
  void* args[] = {&a};
  const dim3 grid((unsigned)b * (l / q) * tiles,
                  (C + kPThreads - 1) / kPThreads);
  cudaError_t err =
      cudaLaunchKernel(fn, grid, dim3(kPThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int Mode>
int epilogue_mode(const EpilogueArgs<T>& a, int b, cudaStream_t s) {
  const int di = a.h * a.p;
  // 256 threads of up to 32 channels each; wider rows 1024 threads of 32
  const int threads = di <= 256 * 32 ? 256 : 1024;
  const int per = (di + threads - 1) / threads;
  const unsigned blocks = (unsigned)b * a.l;
  if (threads == 1024)
    ssm_epilogue_kernel<T, 32, 1024, Mode><<<blocks, 1024, 0, s>>>(a);
  else if (per <= 4)
    ssm_epilogue_kernel<T, 4, 256, Mode><<<blocks, 256, 0, s>>>(a);
  else if (per <= 8)
    ssm_epilogue_kernel<T, 8, 256, Mode><<<blocks, 256, 0, s>>>(a);
  else if (per <= 16)
    ssm_epilogue_kernel<T, 16, 256, Mode><<<blocks, 256, 0, s>>>(a);
  else
    ssm_epilogue_kernel<T, 32, 256, Mode><<<blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int epilogue_launch(const float* y, const float* cs, const long long* cs_st,
                    const float* cum, const void* x, const void* z,
                    long long z_ld, const float* d, const float* norm,
                    float* ss, void* out, int b, int l, int q, int h, int p,
                    int mode, float di_norm, float eps, cudaStream_t s) {
  const EpilogueArgs<T> a{y,
                          cs,
                          {cs_st[0], cs_st[1], cs_st[2], cs_st[3], cs_st[4]},
                          cum,
                          static_cast<const T*>(x),
                          static_cast<const T*>(z),
                          z_ld,
                          d,
                          norm,
                          ss,
                          static_cast<T*>(out),
                          l,
                          l / q,
                          q,
                          h,
                          p,
                          di_norm,
                          eps};
  if (mode == 1) return epilogue_mode<T, 1>(a, b, s);
  if (mode == 2) return epilogue_mode<T, 2>(a, b, s);
  return epilogue_mode<T, 0>(a, b, s);
}

}  // namespace

// The prologue on `stream`.  xbc [b, l, di + 2 n] and dt [b, l, h] of type
// `dtype` (0 bf16, 1 float32), each with its token stride (ld_xbc,
// ld_dt, elements) and unit channel stride; conv_w [K, di + 2 n], conv_b,
// dt_bias and A_log float32, contiguous; outputs contiguous as above, x of
// type `dtype`.  l a multiple of q, K 1 to 4.  Returns the launch's CUDA
// error (0 when it was accepted).
extern "C" int ssm_prologue(const void* xbc, long long ld_xbc, const void* dt,
                            long long ld_dt, const float* conv_w,
                            const float* conv_b, const float* dt_bias,
                            const float* a_log, float* dtx, float* bm,
                            float* cm, float* cum, void* x, int b, int l,
                            int q, int h, int p, int n, int K, int dtype,
                            void* stream) {
  if (b < 1 || q < 1 || h < 1 || p < 1 || n < 1 || l % q || K < 1 ||
      K > kMaxK || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return prologue_launch<bf16>(xbc, ld_xbc, dt, ld_dt, conv_w, conv_b,
                                 dt_bias, a_log, dtx, bm, cm, cum, x, b, l,
                                 q, h, p, n, K, s);
  return prologue_launch<float>(xbc, ld_xbc, dt, ld_dt, conv_w, conv_b,
                                dt_bias, a_log, dtx, bm, cm, cum, x, b, l, q,
                                h, p, n, K, s);
}

// The epilogue on `stream`.  y: K5's y_intra [b (l / q) h, q, p]
// contiguous; cs: C S_in with element strides cs_st over [b, l / q, q, h,
// p]; cum [b (l / q), h, q] contiguous; x [b, l, h p] contiguous and z
// (token stride z_ld, unit channel stride) of type `dtype`; D [h] and norm
// [h p] float32; ss [b l] float32 (mode 1 and 2 only, else null); out [b,
// l, h p] of type `dtype`.  The mean of the squares divides by di_norm.
// h p at most kMaxDi.  Returns the launch's CUDA error.
extern "C" int ssm_epilogue(const float* y, const float* cs,
                            const long long* cs_st, const float* cum,
                            const void* x, const void* z, long long z_ld,
                            const float* d, const float* norm, float* ss,
                            void* out, int b, int l, int q, int h, int p,
                            int mode, float di_norm, float eps, int dtype,
                            void* stream) {
  const int di = h * p;
  if (b < 1 || q < 1 || h < 1 || p < 1 || l % q || di > kMaxDi ||
      mode < 0 || mode > 2 || (mode && !ss) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return epilogue_launch<bf16>(y, cs, cs_st, cum, x, z, z_ld, d, norm, ss,
                                 out, b, l, q, h, p, mode, di_norm, eps, s);
  return epilogue_launch<float>(y, cs, cs_st, cum, x, z, z_ld, d, norm, ss,
                                out, b, l, q, h, p, mode, di_norm, eps, s);
}
