"""K3 on the card: hold every operator of the full-width V-cycle to its
plain version at every forced lane count, and time each lane count beside
the lane count ``lanes_for`` picks, the wrapper, the library call and the
bound.

    python3 tools/k3_check.py         # from the repo root, on an H100 host

The hierarchy is ``chip_smoke.py``'s: ``elasticity_like_3d(40)`` (192,000
dof, 6 levels) in 8 x 8 blocks.  For each distinct operator (A of every
level, P and P^T of every level below the finest) with a seeded float32 x:
parity of the launch alone at lanes 1, 2, 4, 8, 16 and 32 (within
``chip_smoke.K3_RTOL`` of the row's sum of magnitudes), the device time of
each lane count under ``torch.profiler`` (20 calls after a warm-up), then
CUDA events over 20 calls after a warm-up of the launch alone with the
picked lanes, of the wrapper as the V-cycle calls it (``cols`` carrying
its range-check record) and of the wrapper on an unrecorded copy of
``cols`` (the per-call ``aminmax`` sync the record saves),
``torch.sparse_csr_tensor @ x`` (the library yardstick, also its device
time) and the bytes bound (every slot of the blocks, ids and x read once,
y written once, at 3.35 TB/s).  The sums over a cycle weigh each operator
by its calls (A 5 a level above the coarsest, 50 on the coarsest, P and
P^T once).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (FULL, HBM_BYTES_PER_S, K3_RTOL, cuda_ms,  # noqa: E402
                        nvidia_smi)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import spmv_ell as ell  # noqa: E402

LANES = (1, 2, 4, 8, 16, 32)


def err(blocks, cols, x, lanes) -> float:
    """Worst error of one launch as a share of its bound."""
    got = ell._spmv_block_ell_cuda(blocks, cols, x, lanes)
    want = ell.spmv_block_ell_plain(blocks, cols, x)
    scale = ell.spmv_block_ell_plain(blocks.abs(), cols, x.abs())
    e = (got - want).abs() / (K3_RTOL * scale).clamp_min(1e-30)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(e.max())


def device_ms(fn, reps: int = 20, key: str | None = "ell_rows") -> float:
    """Device time a call of ``fn`` spends in kernels whose name holds
    ``key`` (every kernel for ``None``) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (key is None or key in e.key)) / 1e3 / reps


def operators():
    """(label, host CSR, calls a cycle, (blocks, cols)) of every operator."""
    from repro_torch.sparse.amg import DeviceHierarchy, build_hierarchy
    from repro_torch.sparse.problems import elasticity_like_3d

    levels = build_hierarchy(elasticity_like_3d(FULL["nx"]))
    h = DeviceHierarchy.build(levels, bs=8)
    last = len(levels) - 1
    for k, (lv, hl) in enumerate(zip(h.levels, levels)):
        yield f"L{k} A", hl.A, 50 if k == last else 5, lv.A
        if lv.P is not None:
            yield f"L{k} P^T", hl.P.transpose(), 1, lv.PT
            yield f"L{k} P", hl.P, 1, lv.P


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi('name,power.limit')}; clocks "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}", flush=True)
    for line in build.build_kernels().get("spmv_ell", "").splitlines():
        if any(w in line for w in ("registers", "spill", "error")):
            print("  ptxas:", line.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    total = {}
    for label, M, calls, (blocks, cols) in operators():
        nbr, max_bpr, bs, _ = blocks.shape
        ncb = -(-M.shape[1] // bs)
        x = torch.from_numpy(rng.standard_normal(ncb * bs)
                             .astype(np.float32)).to(dev)
        errs = [err(blocks, cols, x, lanes) for lanes in LANES]
        worst = max(worst, *errs)
        picked = ell.lanes_for(nbr * bs, bs, max_bpr)
        dev_by = {lanes: device_ms(lambda: ell._spmv_block_ell_cuda(
            blocks, cols, x, lanes)) for lanes in LANES}
        bare = cols.clone()                   # no range-check record
        S = torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr), torch.from_numpy(M.indices),
            torch.from_numpy(M.data.astype(np.float32)), size=M.shape,
            device=dev)
        xs = x[:M.shape[1]]
        moved = (blocks.numel() * 4 + cols.numel() * 4 + x.numel() * 4
                 + nbr * bs * 4)
        f = dict(
            ms=cuda_ms(lambda: ell.spmv_block_ell(blocks, cols, x), 20),
            unrecorded_ms=cuda_ms(lambda: ell.spmv_block_ell(blocks, bare, x),
                                  20),
            kernel_ms=cuda_ms(lambda: ell._spmv_block_ell_cuda(
                blocks, cols, x), 20),
            device_ms=dev_by[picked], device_lanes1_ms=dev_by[1],
            device_best_ms=min(dev_by.values()),
            library_ms=cuda_ms(lambda: S @ xs, 20),
            library_device_ms=device_ms(lambda: S @ xs, key=None),
            bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        print(f"{label} ({calls} a cycle): {tuple(blocks.shape)}, picked "
              f"lanes {picked}; worst error {max(errs):.3g} of the bound; "
              f"device by lanes "
              + ", ".join(f"{k}: {t:.4f}" for k, t in dev_by.items())
              + f" ms; launch alone {f['kernel_ms']:.4f} ms, wrapper "
              f"{f['ms']:.4f} ms (unrecorded cols {f['unrecorded_ms']:.4f});"
              f" library {f['library_ms']:.4f} ms (device "
              f"{f['library_device_ms']:.4f}); bound {f['bound_ms']:.5f} ms",
              flush=True)
        for k, t in f.items():
            total[k] = total.get(k, 0.0) + calls * t
    print("one cycle (85 calls) summed: " + ", ".join(
        f"{k} {t:.4f}" for k, t in total.items()), flush=True)
    print(f"parity: worst error {worst:.3g} of the bound", flush=True)
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
