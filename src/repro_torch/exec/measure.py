"""Timed schedule runs and measured-vs-predicted strategy orderings.

:func:`time_schedule` runs a lowered schedule on the device with warmup
iterations followed by ``reps`` timed runs, reporting the **median**
(warmup + median-of-k: first-use costs land in warmup, the median rejects
scheduler outliers).  :func:`measure_strategies` sweeps every strategy of a
phase through lower + time; :func:`predicted_costs` prices the same
strategies' pricing plans through the model ladder — optionally with a
*fitted* parameter table from :mod:`repro_torch.exec.calibrate` — and
:func:`ordering` / :func:`pairwise_agreement` turn both cost dicts into
comparable rankings.

Port note: a timed run is a host wall time closed by
``torch.cuda.synchronize()`` on the card (the executor returns before the
device finishes); on the CPU torch runs synchronously.  With ``mesh=``
each rank times its own part of the run, collectives included; where the
ranks are threads sharing one card (``launch.mesh.run_ranks``) a time is
of the whole world's work serialised on that card, not a network's.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.comm.phase import CommPhase
from repro_torch.comm.strategies import rewrite, strategies_for
from repro_torch.core.models import sequence_cost
from repro_torch.device import resolve_device

from .lower import build_executor
from .plan import UNIT_BYTES, ExecSchedule, build_schedule


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timed schedule: ``median_s`` over ``times_s`` (the individual
    timed runs, post-warmup), plus the schedule's round count ``n_rounds``
    for overhead normalization."""

    median_s: float
    times_s: tuple
    n_rounds: int


def time_schedule(schedule: ExecSchedule, *, device=None, mesh=None,
                  reps: int = 5, warmup: int = 2) -> Measurement:
    """Time ``schedule`` on ``device`` (``None`` = CUDA): ``warmup``
    untimed runs, then ``reps`` timed runs, median reported.  Each run's
    wall time ends in a device synchronize on the card.  ``mesh`` as in
    :func:`repro_torch.exec.lower.build_executor` (called on every rank,
    each timing its own part)."""
    dev = resolve_device(device)
    run = build_executor(schedule, device=dev, mesh=mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(1, warmup)):
        run()
    sync()
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        run()
        sync()
        times.append(time.perf_counter() - t0)
    return Measurement(median_s=float(np.median(times)),
                       times_s=tuple(times), n_rounds=schedule.n_rounds)


def launch_overhead(phase: CommPhase, *, device=None, mesh=None,
                    reps: int = 5, warmup: int = 2) -> float:
    """The fixed cost of launching a lowered schedule, in seconds: the
    median time of the ``standard`` schedule of an *empty* exchange bound
    to ``phase``'s machine (same rank count, zero messages — all launch,
    no transport).  ``device`` / ``mesh`` / ``reps`` / ``warmup`` as in
    :func:`time_schedule`."""
    empty = CommPhase.build(phase.machine, [], [], [],
                            n_procs=phase.n_procs)
    sched = build_schedule(empty, "standard")
    return time_schedule(sched, device=device, mesh=mesh, reps=reps,
                         warmup=warmup).median_s


def measure_strategies(phase: CommPhase, strategies=None, *,
                       unit_bytes: float = UNIT_BYTES,
                       coloring: str = "greedy", device=None, mesh=None,
                       reps: int = 5, warmup: int = 2) -> dict:
    """Lower and time every strategy of ``phase``: returns ``{strategy:
    (ExecSchedule, Measurement)}``.  ``strategies`` defaults to
    :func:`repro_torch.comm.strategies.strategies_for` the phase's machine;
    ``unit_bytes`` / ``coloring`` feed the planner and ``device`` /
    ``mesh`` / ``reps`` / ``warmup`` feed :func:`time_schedule`."""
    dev = resolve_device(device)
    names = (strategies if strategies is not None
             else strategies_for(phase.machine))
    out = {}
    for name in names:
        sched = build_schedule(phase, name, unit_bytes=unit_bytes,
                               coloring=coloring)
        out[name] = (sched, time_schedule(sched, device=dev, mesh=mesh,
                                          reps=reps, warmup=warmup))
    return out


def predicted_costs(phase: CommPhase, strategies=None, *,
                    level: str = "contention", params=None,
                    device=None) -> dict:
    """Model-ladder cost per strategy of ``phase`` at ladder ``level``,
    priced on ``device`` (``None`` = CUDA): ``{strategy:
    predicted_seconds}``.  ``params`` substitutes a fitted table
    (:func:`repro_torch.exec.calibrate.calibrate`) for the machine's ground
    truth — the calibrated-model side of the measured-vs-predicted
    comparison; ``strategies`` as in :func:`measure_strategies`."""
    dev = resolve_device(device)
    names = (strategies if strategies is not None
             else strategies_for(phase.machine))
    return {name: float(sequence_cost(rewrite(phase, name).phases,
                                      level=level, params=params,
                                      device=dev).total)
            for name in names}


def ordering(costs: dict) -> tuple:
    """Strategy names of the ``costs`` dict, cheapest first (ties broken by
    name for determinism)."""
    return tuple(sorted(costs, key=lambda k: (costs[k], k)))


def pairwise_agreement(a: dict, b: dict) -> float:
    """Fraction of strategy pairs ranked in the same order by cost dicts
    ``a`` and ``b`` (1.0 = identical orderings; keys must match).  This is
    the ordering-agreement statistic ``bench_exec`` reports."""
    if set(a) != set(b):
        raise ValueError(f"orderings cover different strategies: "
                         f"{sorted(a)} vs {sorted(b)}")
    names = sorted(a)
    same = total = 0
    for i, x in enumerate(names):
        for y in names[i + 1:]:
            total += 1
            same += (a[x] < a[y]) == (b[x] < b[y])
    return 1.0 if total == 0 else same / total
