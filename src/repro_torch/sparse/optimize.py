"""Model-guided local search over row partitions, priced incrementally.

The paper's model ladder is cheap enough to *steer* communication decisions,
not just report them.  :func:`optimize_partition` walks the space of
contiguous row partitions with boundary-shift moves, prices every candidate
with the chosen ladder level, and keeps the moves the model likes.

Each candidate costs O(changed), not O(matrix):

* :func:`~repro_torch.sparse.partition.spmv_comm_pattern_delta` re-derives
  only the messages the move's two processes touch (host numpy);
* the resulting (removed, added) message delta feeds
  :meth:`repro_torch.comm.delta.DeltaStack.apply`, which re-prices the
  mutated arena on the device from its incremental caches (kernel K1 for
  the dirty phase's row and bytes) instead of rebuilding the phase.

``pricer="rebuild"`` runs the same search loop with full per-candidate
reconstruction (fresh pattern extraction + ``CommPhase.build`` + pricing on
the same device) — the reference implementation.  Each move also records
its candidate partition (``Move.starts``), so the recorded candidate
sequence can be re-priced independently.

Port note: candidate costs are float64 sums of float32 aggregates, so a
candidate whose float64 cost ties the current one to within float32's
resolution may be accepted on one side and not the other; compare two
searches by replaying one's recorded candidates, not by racing them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.comm.delta import DeltaStack
from repro_torch.device import resolve_device

from .csr import CSR
from .partition import (CommPattern, RowPartition, SpmvPatternState,
                        spmv_comm_pattern, spmv_comm_pattern_delta)

__all__ = ["Move", "OptimizeResult", "optimize_partition"]

PRICERS = ("delta", "rebuild")


@dataclasses.dataclass(frozen=True)
class Move:
    """One local-search step: a boundary shift and the model's verdict.

    ``cost`` is the candidate's modeled total (NaN when the proposal was
    infeasible and never priced); ``starts`` is the candidate partition —
    kept so a replay can re-price the exact same candidates.
    """

    boundary: int
    shift: int
    cost: float
    accepted: bool
    starts: np.ndarray


@dataclasses.dataclass(frozen=True)
class OptimizeResult:
    """Outcome of a partition search.

    ``verdicts`` holds ``(move index, StrategyVerdict)`` rows for accepted
    moves when ``rerun_strategies=True`` — the strategy sweep re-judged on
    the improved partition.
    """

    partition: RowPartition
    pattern: CommPattern
    initial_cost: float
    cost: float
    moves: list
    verdicts: list

    @property
    def n_accepted(self) -> int:
        return sum(m.accepted for m in self.moves)

    @property
    def improvement(self) -> float:
        """Fractional modeled-cost reduction (0 = no gain)."""
        if self.initial_cost <= 0.0:
            return 0.0
        return 1.0 - self.cost / self.initial_cost


def optimize_partition(A: CSR, machine, n_procs: int | None = None, *,
                       part: RowPartition | None = None, moves: int = 64,
                       step: int | None = None, level: str = "contention",
                       seed: int = 0, pricer: str = "delta",
                       verify: bool = False,
                       rerun_strategies: bool = False,
                       device=None) -> OptimizeResult:
    """Greedy local search over contiguous row partitions of ``A``, priced
    on ``device`` (``None`` = CUDA; raises when no CUDA device exists).

    Parameters
    ----------
    A, machine : the operator and the machine whose model prices candidates.
    n_procs / part : either a process count (balanced initial partition) or
        an explicit starting :class:`RowPartition`.
    moves : number of candidate moves to propose and price.
    step : rows moved per boundary shift (default: ``max(1, n_rows /
        (8 P))``).
    level : model-ladder level the search optimizes
        (:data:`repro_torch.core.models.MODEL_LEVELS`).
    seed : drives the move proposals (boundary + direction per step).
    pricer : ``"delta"`` (incremental, the point of this module) or
        ``"rebuild"`` (full per-candidate reconstruction, the reference).
    verify : run the :class:`~repro_torch.comm.delta.DeltaStack` parity
        check after every apply — debugging only, it re-prices the whole
        arena.
    rerun_strategies : judge the strategy sweep
        (:func:`repro_torch.comm.strategies.best_strategy`, on the same
        device) on every accepted move's pattern and collect the verdicts.

    A move shifts one interior boundary by ``±step`` rows (reassigning that
    many boundary rows between the two adjacent processes); proposals that
    would empty a process are recorded as infeasible and skipped.  A
    candidate is accepted when its modeled total at ``level`` drops.
    """
    from repro_torch.core.models import MODEL_LEVELS, phase_cost_many
    if level not in MODEL_LEVELS:
        raise ValueError(f"unknown model level {level!r}")
    if pricer not in PRICERS:
        raise ValueError(f"unknown pricer {pricer!r}; expected one of "
                         f"{PRICERS}")
    if part is None:
        if n_procs is None:
            raise ValueError("pass n_procs or an explicit part")
        part = RowPartition.balanced(A.n_rows, n_procs)
    device = resolve_device(device)
    starts = np.asarray(part.starts, dtype=np.int64).copy()
    P = len(starts) - 1
    if step is None:
        step = max(1, A.n_rows // (8 * P))

    state = SpmvPatternState.build(A, RowPartition(starts))
    delta = None
    if pricer == "delta":
        delta = DeltaStack.from_phases([state.pattern.bind(machine)],
                                       device=device, verify=verify)
        cost = phase_cost_many(delta, level=level)[0].total
    else:
        cost = phase_cost_many([state.pattern.bind(machine)], level=level,
                               device=device)[0].total
    initial = cost

    rng = np.random.default_rng(seed)
    trace: list[Move] = []
    verdicts: list = []
    for it in range(moves):
        b = int(rng.integers(1, P)) if P > 1 else 0
        d = int(rng.choice((-step, step)))
        if b == 0:
            trace.append(Move(b, d, math.nan, False, starts.copy()))
            continue
        new_starts = starts.copy()
        new_starts[b] += d
        if not starts[b - 1] < new_starts[b] < starts[b + 1]:
            trace.append(Move(b, d, math.nan, False, new_starts))
            continue
        if pricer == "delta":
            rm, add, cand_state = spmv_comm_pattern_delta(state, new_starts)
            cand = delta.apply(rm, {0: add})
            cand_cost = phase_cost_many(cand, level=level)[0].total
        else:
            cand_state = cand = None
            cand_cost = phase_cost_many(
                [spmv_comm_pattern(A, RowPartition(new_starts))
                 .bind(machine)], level=level, device=device)[0].total
        accepted = cand_cost < cost
        trace.append(Move(b, d, cand_cost, accepted, new_starts))
        if accepted:
            starts, cost = new_starts, cand_cost
            if pricer == "delta":
                state, delta = cand_state, cand
            else:
                state = SpmvPatternState.build(A, RowPartition(starts))
            if rerun_strategies:
                from repro_torch.comm.strategies import best_strategy
                phase = (delta.phases[0] if delta is not None
                         else state.pattern.bind(machine))
                verdicts.append((it, best_strategy(phase, seed=seed,
                                                   device=device)))
    return OptimizeResult(partition=RowPartition(starts),
                          pattern=state.pattern, initial_cost=initial,
                          cost=cost, moves=trace, verdicts=verdicts)
