"""Delta re-pricing on the card: where a candidate's time goes.

    python3 tools/delta_check.py      # from the repo root, on an H100 host

The full-width search of ``chip_smoke.py``'s phase 8 (``elasticity_like_3d(40)``,
192,000 rows over 8,192 ranks of ``blue_waters_machine((8, 8, 4))``, 64
moves, the ``contention`` level) is taken apart: the one-time setup
(``SpmvPatternState.build``, the bind, ``DeltaStack.from_phases``, the
first cost) is timed alone, then each priced candidate's three steps,
each ending in a device sync: the pattern delta (host numpy,
``spmv_comm_pattern_delta``), ``DeltaStack.apply`` (host bookkeeping, the
columns' uploads and scatters, two K1 launches) and ``phase_cost_many``
(one host read).  Then the search through ``optimize_partition`` runs
under ``cProfile`` and the functions with the most cumulative time are
printed.  Times are host wall clock (``time.perf_counter``) after a
``torch.cuda.synchronize``; each candidate's cost is held to the search's
within rtol 1e-4.
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import FULL, RTOL, nvidia_smi, sync_time  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("delta_check: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.comm.delta import DeltaStack
    from repro_torch.core.models import phase_cost_many
    from repro_torch.kernels import comm_stack as ks
    from repro_torch.net.machine import blue_waters_machine
    from repro_torch.sparse import (RowPartition, SpmvPatternState,
                                    elasticity_like_3d, optimize_partition,
                                    spmv_comm_pattern_delta)

    print(f"card: {nvidia_smi('name,power.limit')}; torch "
          f"{torch.__version__}", flush=True)
    ks.build_kernels()
    A = elasticity_like_3d(FULL["nx"])
    m = blue_waters_machine(FULL["torus"])
    kw = dict(n_procs=min(FULL["max_ranks"], A.n_rows // 2), moves=64,
              seed=0, level="contention")
    optimize_partition(A, m, **dict(kw, moves=2))           # warm-up
    res, t_search = sync_time(lambda: optimize_partition(A, m, **kw))

    t = {}
    part = RowPartition.balanced(A.n_rows, kw["n_procs"])
    state, t["state build"] = sync_time(lambda: SpmvPatternState.build(A,
                                                                       part))
    phase, t["bind"] = sync_time(lambda: state.pattern.bind(m))
    delta, t["from_phases"] = sync_time(lambda: DeltaStack.from_phases(
        [phase]))
    cost, t["first cost"] = sync_time(lambda: phase_cost_many(
        delta, level=kw["level"])[0].total)
    steps = {"pattern delta": [], "apply": [], "phase_cost_many": []}
    for mv in res.moves:
        if np.isnan(mv.cost):
            continue
        (rm, add, cand_state), a = sync_time(
            lambda: spmv_comm_pattern_delta(state, mv.starts))
        cand, b = sync_time(lambda: delta.apply(rm, {0: add}))
        c, d = sync_time(lambda: phase_cost_many(cand,
                                                 level=kw["level"])[0].total)
        np.testing.assert_allclose(c, mv.cost, rtol=RTOL)
        for k, v in zip(steps, (a, b, d)):
            steps[k].append(v)
        if mv.accepted:
            state, delta = cand_state, cand
    n = len(steps["apply"])
    print(f"full-width search: {A.n_rows} rows over {kw['n_procs']} ranks, "
          f"{phase.n_msgs} messages, {n} candidates priced; "
          f"optimize_partition {t_search:.3f} s", flush=True)
    print("setup: " + ", ".join(f"{k} {v:.4f} s" for k, v in t.items())
          + f" (sum {sum(t.values()):.4f} s)")
    print("a candidate (ms, mean / min / max over "
          f"{n}): " + "; ".join(
              f"{k} {1e3 * np.mean(v):.3f} / {1e3 * np.min(v):.3f} / "
              f"{1e3 * np.max(v):.3f}" for k, v in steps.items())
          + f"; all three {1e3 * sum(np.mean(v) for v in steps.values()):.3f}")

    prof = cProfile.Profile()
    prof.enable()
    optimize_partition(A, m, **kw)
    torch.cuda.synchronize()
    prof.disable()
    print("optimize_partition under cProfile, by cumulative time:")
    pstats.Stats(prof, stream=sys.stdout).sort_stats(
        "cumulative").print_stats(25)
    print(nvidia_smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
