"""The virtual-rank executor on the card: where a full-width run's time goes.

    python3 tools/exec_check.py       # from the repo root, on an H100 host

Level 0 of ``chip_smoke.py``'s full-width hierarchy (``elasticity_like_3d(40)``
over 8,192 ranks of ``blue_waters_machine((8, 8, 4))``, 165,930 messages) is
lowered by each of the three node-aware strategies and run by
``repro_torch.exec.build_executor``.  Per strategy, CUDA-event times (mean of
10 after a warm-up) of the whole run and of its start alone (the same
schedule with no phases: the two dense int32 fills and the payload
scatters), the rounds being the difference; the host wall time of a run
ending in a sync; the bytes bound of the start (each buffer written once at
3.35 TB/s); and the device time by kernel of one run under
``torch.profiler``, beside the sum of its rows.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (FULL, HBM_BYTES_PER_S, amg_patterns,  # noqa: E402
                        cuda_ms, nvidia_smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("exec_check: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.comm.strategies import STRATEGIES
    from repro_torch.exec import build_executor, build_schedule
    from repro_torch.net.machine import blue_waters_machine

    print(f"card: {nvidia_smi('name,power.limit')}; torch "
          f"{torch.__version__}", flush=True)
    m = blue_waters_machine(FULL["torus"])
    _, _, pats = amg_patterns(FULL["nx"], m, FULL["max_ranks"])
    phase = pats[0].bind(m)
    for strat in STRATEGIES:
        sched = build_schedule(phase, strat)
        run = build_executor(sched)
        start = build_executor(dataclasses.replace(sched, phases=()))
        ms_run, ms_start = cuda_ms(run, 10), cuda_ms(start, 10)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
        P, U = sched.n_procs, sched.n_units
        bound = 2 * 4 * P * (U + 1) / HBM_BYTES_PER_S * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        print(f"{strat}: {P} ranks, {U} units, {sched.n_rounds} rounds; run "
              f"{ms_run:.4f} ms (events), start alone {ms_start:.4f} ms "
              f"(bytes bound {bound:.4f} ms), rounds {ms_run - ms_start:.4f}"
              f" ms ({(ms_run - ms_start) / max(sched.n_rounds, 1):.4f} ms a "
              f"round); host wall of one run {wall:.4f} ms; the profiler's "
              f"rows sum to {sum(r[0] for r in rows) / 1e3:.4f} ms:",
              flush=True)
        for us, count, key in rows[:8]:
            print(f"  {us / 1e3:9.4f} ms  x{count:<4d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
