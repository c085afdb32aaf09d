"""What bounds K2: time it whole and with parts taken out, at the sizes of
the full-width sweep's call.

    python3 tools/k2_ablation.py      # from the repo root, on an H100 host

Each variant is ``csrc/queue_walk.cu`` with one text substitution, built by
``nvcc`` into ``src/repro_torch/kernels/_build/ablation_k2/`` (all at once)
and launched through its C entry ``queue_walk`` on one seeded layout of
122,867 regions drawn like the sweep's call (5-26 arrivals, 1.5 % of
regions 60-174):

- ``base``: the kernel as it is (held bit-equal to the plain version);
- ``nocompare``: the compare loop taken out (search, window staging, reads
  and writes stay);
- ``iocopy``: only the reads of ``b`` and the writes of the steps (no
  search, no window, no compares).

Times are CUDA events and the device time under ``torch.profiler``, each
over 50 launches after a warm-up, in two rounds of turns, beside the card's
name, power limit and SM clock.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, kernel_device_ms, nvidia_smi  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402

VARIANTS = {
    "base": [],
    "nocompare": [("for (int i = from; i < to; ++i) less += tile[i] < bj;",
                   "less += from < to;")],
    "iocopy": [("  // this arrival's region start,",
                "  if (live) steps[g] = b[g] + 1;\n  return;\n"
                "  // this arrival's region start,")],
}
OUT = build.BUILD_DIR / "ablation_k2"


def build_variants() -> dict:
    """Compile every variant at once; returns the bound C entries."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "queue_walk.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            src = src.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode()}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).queue_walk
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    print(f"card: {nvidia_smi('name,power.limit')}; clocks "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}", flush=True)
    fns = build_variants()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    counts = rng.integers(5, 27, 122_867)
    big = rng.random(counts.size) < 0.015
    counts[big] = rng.integers(60, 175, int(big.sum()))
    bounds = np.concatenate([[0], np.cumsum(counts)])
    cat = lambda xs: torch.from_numpy(  # noqa: E731
        np.concatenate(xs).astype(np.int64)).to(dev)
    t = (cat([rng.permutation(c) for c in counts]),
         cat([rng.permutation(c) for c in counts]),
         torch.from_numpy(bounds).to(dev))
    b, starts = ks._queue_layout(*t)[:2]
    want = ks.queue_walk_plain(*t)
    out = torch.empty(b.numel(), dtype=torch.int64, device=dev)
    print(f"layout: {b.numel()} arrivals in {counts.size} regions, "
          f"{float(np.sum(counts.astype(np.float64) ** 2) / 2):.4g} compares",
          flush=True)
    for rnd in range(2):
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(b.data_ptr(), starts.data_ptr(), b.numel(),
                         starts.numel(), out.data_ptr(),
                         torch._C._cuda_getCurrentRawStream(dev.index or 0))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "base" and not torch.equal(out, want):
                raise AssertionError("base differs from the plain version")
            print(f"round {rnd} {name:10s} events {cuda_ms(call, 50):.5f} ms,"
                  f" device "
                  f"{kernel_device_ms(call, 'count_earlier_smaller', 50)} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
