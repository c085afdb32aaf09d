"""K2 on the card: build it, print its compiler lines, hold it to the plain
version on the parity layouts of ``chip_smoke.py``, and time it at the
full-width sweep's call and on synthetic layouts.

    python3 tools/k2_check.py         # from the repo root, on an H100 host

The sweep of ``chip_smoke.py`` (``elasticity_like_3d(40)``, 8,192 ranks)
is run once with K2's input captured; that call is held bit-equal to the
plain version and timed as ``chip_smoke.py``'s row times it (wrapper,
launch alone and plain version by CUDA events, the kernel's device time
under ``torch.profiler``, the same bound).  Then, launch alone and device
time on synthetic layouts: 100,000 regions of sizes drawn like the
full-width call's (held to the plain version), one region of 10,000
arrivals (held to the plain version), and one region of 10^6 arrivals,
the quadratic case the kernel's header states (CUDA events only: the
profiler keeps one of several launches this long): its first 4,000 and
last 16 steps are held to the count formula computed in numpy (a step
depends only on the arrivals before it), since the plain walk would take
one round an arrival.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (FULL, amg_patterns, cuda_ms,  # noqa: E402
                        k2_call_figures, k2_check, k2_parity,
                        kernel_device_ms, nvidia_smi)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import comm_stack as ks  # noqa: E402

TAG = "count_earlier_smaller"


def sweep_call():
    """The K2 call of the full-width sweep, captured."""
    from repro_torch.comm import strategies
    from repro_torch.net.machine import blue_waters_machine

    m = blue_waters_machine(FULL["torus"])
    _, _, pats = amg_patterns(FULL["nx"], m, FULL["max_ranks"])
    calls = []
    real = ks.queue_walk

    def spy(*args):
        calls.append(args)
        return real(*args)
    ks.queue_walk = spy
    try:
        strategies.best_strategy_many(pats, m)
    finally:
        ks.queue_walk = real
    return calls


def layout(counts, rng, dev):
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cat = lambda xs: torch.from_numpy(np.concatenate(xs).astype(np.int64))
    return (cat([rng.permutation(c) for c in counts]).to(dev),
            cat([rng.permutation(c) for c in counts]).to(dev),
            torch.from_numpy(bounds).to(dev))


def count_formula(b: np.ndarray, js) -> np.ndarray:
    """Steps of arrivals ``js`` of one region by the count formula."""
    return np.array([b[j] + 1 - int((b[:j] < b[j]).sum()) for j in js])


def main() -> int:
    print(f"card: {nvidia_smi('name,power.limit')}; clocks "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}", flush=True)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    logs = build.build_kernels()
    for line in logs.get("queue_walk", "").splitlines():
        if any(w in line for w in ("registers", "spill", "warning", "error",
                                   "Compiling", "smem")):
            print("  ptxas queue_walk:", line.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    k2_parity(ks, dev, rng)

    for posted, arrival, bounds in sweep_call():
        k2_check(ks, posted, arrival, bounds)
        f = k2_call_figures(ks, posted, arrival, bounds, clock_hz)
        print("sweep call: " + ", ".join(f"{k} {v}" for k, v in f.items()),
              flush=True)

    counts = rng.integers(5, 27, 100_000)
    big = rng.random(counts.size) < 0.015
    counts[big] = rng.integers(60, 175, int(big.sum()))
    for label, counts in (("100,000 regions, full-width size mix", counts),
                          ("one region of 10,000 arrivals", [10_000]),
                          ("one region of 10^6 arrivals", [1_000_000])):
        t = layout(counts, rng, dev)
        b, starts = ks._queue_layout(*t)[:2]
        got = ks.queue_walk(*t)
        if len(counts) > 1 or counts[0] <= 10_000:
            k2_check(ks, *t)
            held = "bit-equal to the plain version"
        else:
            h, g = b.cpu().numpy(), got.cpu().numpy()
            js = [*range(4000), *range(h.size - 16, h.size)]
            if not np.array_equal(g[js], count_formula(h, js)):
                raise AssertionError(f"{label}: steps differ from the count "
                                     "formula")
            held = "first 4,000 and last 16 steps equal the count formula"
        launch = lambda: ks._queue_walk_cuda(b, starts)   # noqa: E731
        compares = float(np.sum(np.asarray(counts, np.float64) ** 2) / 2)
        # the profiler kept one of several launches of a kernel as long as
        # the 10^6 case's: time that by CUDA events alone, its device time
        short = max(counts) < 10 ** 6
        device = kernel_device_ms(launch, TAG, 20) if short else None
        print(f"{label} ({b.numel()} arrivals, {len(counts)} regions, "
              f"{compares:.4g} compares): launch alone "
              f"{cuda_ms(launch, 20 if short else 3):.4f} ms, device "
              f"{'not measured' if device is None else f'{device:.4f}'} ms; "
              f"{held}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
