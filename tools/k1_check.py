"""K1 on the card: build it, print its compiler lines, hold both paths to
the plain version on ragged inputs, and time it at the five calls of the
full-width strategy sweep.

    python3 tools/k1_check.py         # from the repo root, on an H100 host

Parity: sorted runs (46 phases, as ``phase_id``), random ids, one hot
segment, signed values, empty segments, ids above the shared-memory
capacity (sorted, random, and short runs as the contention call has), a
16-byte-misaligned start and tiny n; each on the global path and, where
``n_seg`` fits, the smem path.  Sums within rtol 1e-4 / atol 1e-6 of the
sum of ``|values|`` from the float64 sum (the float32 plain version's own
atomics drift further on one hot segment), maxima bit-equal.

Timing: the sweep of ``chip_smoke.py`` (``elasticity_like_3d(40)``, 8,192
ranks) is run once with K1's inputs captured; for each of its five calls,
CUDA events over 20 calls after a warm-up of the wrapper, the launch alone
on the path ``k1_path`` picks and on each other path that applies, the
plain version and ``index_add_`` + ``scatter_reduce`` (the library
yardstick), the device time of the launch alone under ``torch.profiler``,
and the bytes bound (8 B read a message, 8 B written a segment, at 3.35
TB/s).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (ATOL, FULL, HBM_BYTES_PER_S, RTOL,  # noqa: E402
                        amg_patterns, cuda_ms, nvidia_smi)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402


def cases(rng):
    """(label, values, ids, n_seg) on the host."""
    counts = rng.integers(30_000, 55_000, 46)
    phase = np.repeat(np.arange(46), counts)
    yield "sorted runs", rng.exponential(1e3, phase.size), phase, 46
    yield "random ids", rng.exponential(1.0, 1_000_003), \
        rng.integers(0, 300, 1_000_003), 300
    hot = np.full(1_500_000, 7)
    hot[rng.integers(0, hot.size, 1000)] = rng.integers(0, 50, 1000)
    yield "one hot segment", rng.exponential(10.0, hot.size), hot, 50
    yield "signed values", rng.standard_normal(777_777) * 1e3, \
        rng.integers(0, 37, 777_777), 37
    yield "empty segments", rng.exponential(1.0, 500_000), \
        2 * rng.integers(0, 2000, 500_000), 4001
    ids = np.sort(rng.integers(0, 400_000, 2_000_000))
    yield "sorted, above capacity", rng.exponential(1.0, ids.size), ids, \
        400_000
    yield "random, above capacity", rng.standard_normal(2_000_000), \
        rng.integers(0, 40_000, 2_000_000), 40_000
    keys = np.repeat(np.sort(rng.integers(0, 36_000, 1_500_000)),
                     rng.integers(1, 5, 1_500_000))
    yield "short runs, above capacity", rng.exponential(1.0, keys.size), \
        keys, 36_000
    for n in (0, 1, 5, 1029):
        yield f"n={n}", rng.exponential(1.0, n), rng.integers(0, 3, n), 3


def check(values, ids, n_seg, path) -> float:
    """Worst error of one launch on ``path``, as a share of its bound;
    raises on a maximum that differs."""
    s, m = ks._segment_reduce_cuda(values, ids, n_seg, path)
    _, wm = ks.segment_reduce_plain(values, ids, n_seg)
    ws = ks.segment_reduce_plain(values.double(), ids, n_seg)[0]
    scale = ks.segment_reduce_plain(values.double().abs(), ids, n_seg)[0]
    if not torch.equal(m, wm):
        bad = int(torch.nonzero(m != wm)[0])
        raise AssertionError(f"maximum of segment {bad}: {float(m[bad])} "
                             f"vs {float(wm[bad])} ({path})")
    if not n_seg:
        return 0.0
    return float(((s - ws).abs() / (ATOL + RTOL * scale)).max())


def device_ms(fn, reps: int = 20) -> float:
    """Device time a call of ``fn`` spends in K1's kernels (and its
    memset) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ("seg_" in e.key or "emset" in e.key)) / 1e3 / reps


def sweep_calls():
    """The five K1 calls of the full-width sweep, captured."""
    from repro_torch.comm import strategies
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine(FULL["torus"])
    _, _, pats = amg_patterns(FULL["nx"], m, FULL["max_ranks"])
    calls = []
    real = ks.segment_reduce

    def spy(*args):
        calls.append(args)
        return real(*args)
    ks.segment_reduce = spy
    try:
        strategies.best_strategy_many(pats, m)
    finally:
        ks.segment_reduce = real
    return calls


def main() -> int:
    print(f"card: {nvidia_smi('name,power.limit')}; clocks "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}", flush=True)
    logs = build.build_kernels()
    for name in ("segment_reduce", "spmv_ell"):
        for line in logs.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "warning",
                                       "error", "Compiling", "smem")):
                print(f"  ptxas {name}:", line.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    for label, vals, ids, n_seg in cases(rng):
        v = torch.from_numpy(vals.astype(np.float32)).to(dev)
        i = torch.from_numpy(ids.astype(np.int32)).to(dev)
        paths = ["global"] + (["smem"] if n_seg <= ks.K1_BIN_CAP else [])
        errs = {p: check(v, i, n_seg, p) for p in paths}
        if v.numel() > 1:
            errs.update({f"{p}, misaligned": check(v[1:], i[1:], n_seg, p)
                         for p in paths})
        print(f"parity {label} (n {v.numel()}, n_seg {n_seg}): "
              + ", ".join(f"{p} {e:.3g}" for p, e in errs.items())
              + " of the bound; maxima equal", flush=True)
        worst = max(worst, *errs.values())
    print(f"parity: worst error {worst:.3g} of the bound", flush=True)

    calls = sweep_calls()
    total = {}
    for values, ids, n_seg in calls:
        idx = ids.long()
        s_out = torch.empty(n_seg, device=dev)
        m_out = torch.empty(n_seg, device=dev)

        def library():
            s_out.zero_().index_add_(0, idx, values)
            m_out.zero_().scatter_reduce_(0, idx, values, "amax",
                                          include_self=False)

        picked = ks.k1_path(n_seg)
        worst = max(worst, check(values, ids, n_seg, picked))
        f = dict(
            ms=cuda_ms(lambda: ks.segment_reduce(values, ids, n_seg), 20),
            kernel_ms=cuda_ms(lambda: ks._segment_reduce_cuda(
                values, ids, n_seg), 20),
            device_ms=device_ms(lambda: ks._segment_reduce_cuda(
                values, ids, n_seg)),
            plain_ms=cuda_ms(lambda: ks.segment_reduce_plain(
                values, ids, n_seg), 20),
            library_ms=cuda_ms(library, 20),
            bound_ms=(8 * values.numel() + 8 * n_seg) / HBM_BYTES_PER_S
            * 1e3)
        other = {p: cuda_ms(lambda: ks._segment_reduce_cuda(
            values, ids, n_seg, p), 20)
            for p in ("smem", "global") if p != picked
            and (p == "global" or n_seg <= ks.K1_BIN_CAP)}
        h = ids.cpu().numpy()
        runs = 1 + int((h[1:] != h[:-1]).sum()) if h.size else 0
        print(f"sweep call n {values.numel()}, n_seg {n_seg}, {runs} runs: "
              f"path {picked}; wrapper {f['ms']:.4f} ms, launch alone "
              f"{f['kernel_ms']:.4f} ms, device {f['device_ms']:.4f} ms, "
              + "".join(f"forced {p} {t:.4f} ms, " for p, t in other.items())
              + f"plain {f['plain_ms']:.4f} ms, library "
              f"{f['library_ms']:.4f} ms, bound {f['bound_ms']:.5f} ms",
              flush=True)
        for k, t in f.items():
            total[k] = total.get(k, 0.0) + t
    print("sweep, 5 calls summed: " + ", ".join(
        f"{k} {t:.4f}" for k, t in total.items()), flush=True)
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
