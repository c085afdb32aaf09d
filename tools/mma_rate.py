"""Peak rate of the warp-level tensor-core product K5 uses (``mma.sync``
m16n8k8 TF32, float32 accumulate) on the card, beside bf16's m16n8k16 and
float32 FMAs on the CUDA cores.

    python3 tools/mma_rate.py         # from the repo root, on an H100 host

Builds the CUDA source below with ``nvcc`` for ``sm_90a`` into
``src/repro_torch/kernels/_build/``.  Each kernel runs 8 warps a block,
4 blocks an SM, and each warp issues ``ITERS`` rounds of 8 independent
products (8 accumulators, so no product waits on the one before); the rate
is the flops over the CUDA-event time of one launch after a warm-up.  The
accumulators are written out so nothing is optimised away.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import nvidia_smi  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

ITERS = 4096
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256) k_tf32(float* out, int iters, uint32_t s) {
  float d[8][4] = {};
  uint32_t a[4] = {s, s + 1, s + 2, s + 3}, b0 = s + 4, b1 = s + 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(256) k_bf16(float* out, int iters, uint32_t s) {
  float d[8][4] = {};
  uint32_t a[4] = {s, s + 1, s + 2, s + 3}, b0 = s + 4, b1 = s + 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(256) k_ffma(float* out, int iters, uint32_t s) {
  float d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = __uint_as_float(s + k);
  const float x = __uint_as_float(s + 9), y = __uint_as_float(s + 10);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = fmaf(d[k], x, y);
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += d[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int mma_rate(int which, float* out, int blocks, int iters,
                        void* stream) {
  auto fn = which == 0 ? k_tf32 : which == 1 ? k_bf16 : k_ffma;
  fn<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 0u);
  return cudaGetLastError();
}
"""
# (name, flops a warp-level instruction: 2 m n k, or 2 x 32 lanes)
KINDS = (("mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
         ("mma.sync m16n8k16 bf16", 2 * 16 * 8 * 16),
         ("ffma float32", 2 * 32))


def main() -> int:
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_rate.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libmma_rate.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if res.returncode:
        print(res.stdout + res.stderr)
        return 1
    fn = ctypes.CDLL(str(lib)).mma_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 4 * sms
    out = torch.empty(blocks * 256, device="cuda")
    print(f"card: {nvidia_smi('name,power.limit')}")
    for which, (name, flops) in enumerate(KINDS):
        def run():
            build.launch(fn, out.device, which, out.data_ptr(), blocks,
                         ITERS)
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        total = blocks * 8 * ITERS * 8 * flops
        clock = float(nvidia_smi("clocks.sm").split()[0])
        per_sm_clk = total / sms / (ms * 1e-3 * clock * 1e6)
        print(f"{name}: {total / ms / 1e9:.1f} TFLOP/s ({ms:.3f} ms, SM "
              f"clock {clock:.0f} MHz after the run: {per_sm_clk:.0f} "
              f"flop a clock an SM)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
