"""K5 on the card: build it, print its compiler lines and the tensor-core
instructions of its entry, hold it to its plain version on every shape the
port gives it, and time it at hymba-1.5b's and mamba2-130m's prefill shapes
for several head-group sizes.

    python3 tools/k5_check.py         # from the repo root, on an H100 host

Parity: q 1, 16, 24, 64, 100 and 128 (ragged q is padded inside the
kernel), n 8, 16 and 128, p 16 and 64, with B and C expanded over 5 heads
(stride 0) and dtx and cumA transposed views, as ``nn.ssm.ssd_chunked``
passes them, and a few plain ``[G, q, x]`` inputs (one head a block); each
case is held to ``chip_smoke.K5_TOL``.  Timing: CUDA events over 10
launches after a warm-up, of the launch alone with the group the kernel
picks and with each group size forced through the C entry
``ssd_intra_chunk_group``, beside the plain version, at G1 = 64 (4 prompts
of 2048 tokens in chunks of 128) and h = 50 (hymba) or 24 (mamba2).
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

from chip_smoke import K5_TOL, cuda_ms, nvidia_smi  # noqa: E402
from repro_torch.kernels import build, ssd  # noqa: E402

# (label, G1, heads, q, n, p) at full width
WIDE = (("hymba-1.5b", 64, 50, 128, 16, 64),
        ("mamba2-130m", 64, 24, 128, 128, 64))
GROUPS = (1, 2, 3, 5, 8, 10, 13, 25, 50)


def inputs(gen, G1, h, q, n, p, shared=True):
    """dtx, B, C, cumA as the mixer passes them (a decay per step of
    -A dt, A from 1 to 16 over the heads, dt = softplus(N(0, 1)))."""
    dev = "cuda"
    dtx = torch.randn(G1, q, h, p, generator=gen, device=dev)
    if shared:
        Bm, Cm = (torch.randn(G1, 1, q, n, generator=gen, device=dev)
                  .expand(G1, h, q, n) for _ in range(2))
    else:
        Bm, Cm = (torch.randn(G1, h, q, n, generator=gen, device=dev)
                  for _ in range(2))
    A = torch.linspace(1, 16, h, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(G1, q, h, generator=gen, device=dev))
    cum = (-A * dt).cumsum(1)
    return (dtx.permute(0, 2, 1, 3), Bm, Cm,
            cum.permute(0, 2, 1)[..., None])


def err(args) -> float:
    got = ssd.ssd_intra_chunk(*args)
    want = ssd.ssd_intra_chunk_plain(*args)
    worst = 0.0
    for g, w in zip(got, want):
        e = (g - w).abs()
        ratio = float((e / (K5_TOL + K5_TOL * w.abs())).max())
        if not bool(torch.isfinite(g).all()):
            ratio = float("inf")
        worst = max(worst, ratio)
    return worst


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi('name,power.limit')}; clocks "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}", flush=True)
    logs = build.build_kernels()
    for line in logs.get("ssd", "").splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "error",
                                   "Compiling")):
            print("  ptxas:", line.strip())
    lib = build.library_path("ssd")
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    hmma = [ln.strip() for ln in sass.splitlines() if "HMMA" in ln]
    print(f"SASS: {len(hmma)} HMMA lines, "
          f"{sum('TF32' in ln for ln in hmma)} TF32, FFMA "
          f"{sum('FFMA' in ln for ln in sass.splitlines())}")
    for ln in hmma[:3]:
        print("  ", ln)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, cases = 0.0, 0
    for q in (1, 16, 24, 64, 100, 128):
        for n in (8, 16, 128):
            for p in (16, 64):
                r = err(inputs(gen, 6, 5, q, n, p))
                if r > 1:
                    print(f"  FAIL q {q} n {n} p {p}: {r:.3g} x K5_TOL")
                worst, cases = max(worst, r), cases + 1
    for q, n, p in ((100, 16, 64), (128, 128, 16), (24, 8, 16)):
        r = err(inputs(gen, 12, 1, q, n, p, shared=False))
        if r > 1:
            print(f"  FAIL plain q {q} n {n} p {p}: {r:.3g} x K5_TOL")
        worst, cases = max(worst, r), cases + 1
    print(f"parity: {cases} cases, worst error {worst:.3g} of K5_TOL",
          flush=True)

    fn = build.kernel("ssd", "ssd_intra_chunk_group",
                      (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6)
    for label, G1, h, q, n, p in WIDE:
        args = inputs(gen, G1, h, q, n, p)
        r = err(args)
        y = torch.empty(G1 * h, q, p, device="cuda")
        s = torch.empty(G1 * h, n, p, device="cuda")
        strides = (ctypes.c_longlong * 16)(
            *(st for t in args for st in t.stride()))
        ptrs = [t.data_ptr() for t in args] + [y.data_ptr(), s.data_ptr()]

        def forced(grp):
            build.launch(fn, y.device, *ptrs, strides, G1 * h, h, q, n, p,
                         grp)

        auto = cuda_ms(lambda: ssd._ssd_intra_chunk_cuda(
            *args, G1 * h, h, q, n, p), 10)
        plain = cuda_ms(lambda: ssd.ssd_intra_chunk_plain(*args), 3)
        times = {grp: cuda_ms(lambda: forced(grp), 10)
                 for grp in GROUPS if grp <= h}
        auto2 = cuda_ms(lambda: ssd._ssd_intra_chunk_cuda(
            *args, G1 * h, h, q, n, p), 10)
        print(f"{label} (G1 {G1}, h {h}, q {q}, n {n}, p {p}): error "
              f"{r:.3g} of K5_TOL; launch alone {auto:.4f} / {auto2:.4f} ms "
              f"(group picked by the kernel), plain {plain:.4f} ms; forced "
              f"groups " + ", ".join(f"{g}: {t:.4f}" for g, t in
                                     times.items()), flush=True)
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
