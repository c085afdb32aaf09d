"""Check each bf16 ``wgmma`` operand form of K4's tensor-core path alone,
on one warpgroup, before the attention kernel is built on them.

    python3 tools/wgmma_probe.py      # from the repo root, on an H100 host

Builds ``tools/wgmma_probe.cu`` (with the helpers of
``src/repro_torch/kernels/csrc/wgmma.cuh``) with ``nvcc`` for ``sm_90a``
and holds each product to ``torch.matmul`` in float32 on seeded inputs:

- ``ss``: ``A[64, K] B[64, K]^T``, both K-major with the 128-byte swizzle
  (K 64: one atom along K; K 128: two), the form of ``Q K^T``;
- ``rs``: ``A[64, 64] V[64, N]`` with A in registers and V MN-major
  (transpose bit set), for V's descriptor offsets (LBO, SBO) both ways
  round; N 128 tells them apart;
- ``chain``: ``bf16(A B^T) V``, the ``ss`` accumulator turned into ``rs``'s
  A in registers, as ``S -> P`` in flash attention.

Products of bf16 values are exact in float32, so ``ss`` and ``rs`` differ
from float32 ``torch.matmul`` only by the order of the sums (bound 1e-5 of
the sum of magnitudes); ``chain`` rounds S to bf16 as torch does, where the
two may round a sum one bf16 ulp apart (bound 2^-8 of the magnitudes).
Prints one line a case and exits 1 if a form K4 uses is off.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

SRC = ROOT / "tools" / "wgmma_probe.cu"
# V's (LBO, SBO): the form K4 uses first, then the swapped one
V_FORMS = ((8192, 1024), (1024, 8192))


def _library():
    out = build.BUILD_DIR / "libwgmma_probe.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", str(out), str(SRC)],
                         capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  nvcc:", line.strip())
    if res.returncode:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    fn = lib.wgmma_probe
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("wgmma_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = _library()
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    def run(mode, K, N, a, b, v, lbo, sbo, rows_out):
        c = torch.full((64, rows_out), float("nan"), device="cuda")
        err = fn(mode, K, N, a.data_ptr(), b.data_ptr(), v.data_ptr(),
                 c.data_ptr(), lbo, sbo,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe launch failed with CUDA error {err}")
        torch.cuda.synchronize()
        return c

    ok = {}
    for K in (64, 128):
        a, b, v = rnd(64, K), rnd(64, K), rnd(64, 64)
        got = run(0, K, 64, a, b, v, *V_FORMS[0], 64)
        want = a.float() @ b.float().T
        mag = a.float().abs() @ b.float().abs().T
        err = float(((got - want).abs() / mag).nan_to_num(1e9).max())
        ok[("ss", K)] = err <= 1e-5
        print(f"ss K {K}: max error / magnitude {err:.3g} "
              f"{'ok' if ok[('ss', K)] else 'WRONG'}")
    for N in (64, 128):
        for lbo, sbo in V_FORMS:
            a, v = rnd(64, 64), rnd(64, N)
            got = run(1, 64, N, a, a, v, lbo, sbo, N)
            want = a.float() @ v.float()
            mag = a.float().abs() @ v.float().abs()
            err = float(((got - want).abs() / mag).nan_to_num(1e9).max())
            ok[("rs", N, lbo, sbo)] = err <= 1e-5
            print(f"rs N {N} LBO {lbo} SBO {sbo}: max error / magnitude "
                  f"{err:.3g} {'ok' if err <= 1e-5 else 'WRONG'}")
    for K in (64, 128):
        for N in (64, 128):
            a, b, v = rnd(64, K), rnd(64, K), rnd(64, N)
            got = run(2, K, N, a, b, v, *V_FORMS[0], N)
            p = (a.float() @ b.float().T).bfloat16().float()
            want = p @ v.float()
            mag = p.abs() @ v.float().abs()
            err = float(((got - want).abs() / mag).nan_to_num(1e9).max())
            ok[("chain", K, N)] = err <= 2.0 ** -8
            print(f"chain K {K} N {N}: max error / magnitude {err:.3g} "
                  f"{'ok' if err <= 2.0 ** -8 else 'WRONG'}")
    used = [key for key in ok if key[0] != "rs" or key[2:] == V_FORMS[0]]
    bad = [key for key in used if not ok[key]]
    print("forms K4 uses:", "all ok" if not bad else f"WRONG: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
