"""Row partitions and the communication pattern of parallel SpMV.

Given a 1-D (row-wise) partition of a sparse matrix over P processes, the
halo exchange of y = A x sends, for every (owner -> requester) pair, the
distinct x entries the requester's rows touch (8 bytes each); the SpGEMM
C = A B fetches the B rows behind those columns (12 bytes a nonzero).
:meth:`CommPattern.bind` turns a pattern into a machine-bound
:class:`~repro_torch.comm.phase.CommPhase` and :func:`stack_patterns` a
sweep of them into one :class:`~repro_torch.comm.stack.PhaseStack`.

Port note: pattern extraction is host numpy; only :func:`stack_patterns`
(and the entry points a pattern feeds) put anything on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.comm.phase import CommPhase
from repro_torch.comm.stack import PhaseStack

from .csr import CSR

SPMV_ENTRY_BYTES = 8
SPGEMM_NNZ_BYTES = 12    # value (8) + column index (4) per fetched B nonzero


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Contiguous balanced row partition: rows [starts[p], starts[p+1])."""

    starts: np.ndarray   # [P+1]

    @classmethod
    def balanced(cls, n_rows: int, n_procs: int) -> "RowPartition":
        base = n_rows // n_procs
        extra = n_rows % n_procs
        sizes = np.full(n_procs, base, dtype=np.int64)
        sizes[:extra] += 1
        return cls(np.concatenate([[0], np.cumsum(sizes)]))

    @property
    def n_procs(self) -> int:
        return len(self.starts) - 1

    def owner_of(self, rows) -> np.ndarray:
        return np.searchsorted(self.starts, np.asarray(rows), side="right") - 1


@dataclasses.dataclass
class CommPattern:
    """One communication phase: message (src[i] -> dst[i], size[i] bytes)."""

    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    n_procs: int

    @property
    def n_msgs(self) -> int:
        return int(self.src.size)

    @property
    def total_bytes(self) -> float:
        return float(self.size.sum())

    def max_msgs_per_proc(self) -> int:
        if self.src.size == 0:
            return 0
        return int(np.bincount(self.dst, minlength=self.n_procs).max())

    def validate(self, where: str | None = None) -> "CommPattern":
        """Run the typed validation layer over this pattern and return it.

        Raises a precise :class:`repro_torch.comm.guard.PatternError`
        subclass for NaN / negative message sizes, out-of-range or
        non-integral ranks, or an int32-overflow arena — before the pattern
        reaches any kernel.  ``where`` labels the pattern in error text
        (default: ``'CommPattern'``).  Returns ``self``, so it chains:
        ``pattern.validate().bind(machine)``.
        """
        from repro_torch.comm.guard import validate_phase
        validate_phase(self, where=where)
        return self

    def bind(self, machine, n_procs: int | None = None,
             validate: bool = False) -> CommPhase:
        """Bind this pattern to a machine: a :class:`CommPhase` with
        locality, protocol, torus endpoints and active-sender counts
        cached.  ``validate=True`` runs the typed validation first."""
        return CommPhase.build(machine, self.src, self.dst, self.size,
                               n_procs=self.n_procs if n_procs is None
                               else n_procs, validate=validate)

    def rewrite(self, machine, strategy: str):
        """Bind to ``machine`` and apply a node-aware strategy rewrite: a
        :class:`repro_torch.comm.strategies.StrategyPlan` whose phase
        sequence the batched entry points price directly."""
        from repro_torch.comm.strategies import rewrite
        return rewrite(self.bind(machine), strategy)

    def best_strategy(self, machine, **kw):
        """Sweep every strategy on this pattern: the model ladder's predicted
        winner plus the simulator's verdict
        (:func:`repro_torch.comm.strategies.best_strategy`, same keyword
        arguments, ``device`` included)."""
        from repro_torch.comm.strategies import best_strategy
        return best_strategy(self, machine, **kw)


def stack_patterns(patterns, machine, device=None) -> PhaseStack:
    """Bind a sweep of :class:`CommPattern` objects (an AMG hierarchy, a
    partition scan) to one machine as a single
    :class:`~repro_torch.comm.stack.PhaseStack` on ``device`` (``None`` =
    CUDA) — the input the batched entry points price in one segmented pass
    per quantity."""
    return PhaseStack.build([p.bind(machine) for p in patterns],
                            device=device)


def _needed_pairs(A: CSR, part: RowPartition) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (requesting proc, off-proc column) pairs over A's nonzeros."""
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    req = part.owner_of(rows)          # proc that owns the row
    own = part.owner_of(A.indices)     # proc that owns the column
    off = req != own
    if not off.any():
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    key = req[off].astype(np.int64) * A.n_cols + A.indices[off]
    uniq = np.unique(key)
    return (uniq // A.n_cols).astype(np.int64), (uniq % A.n_cols).astype(np.int64)


def spmv_comm_pattern(A: CSR, part: RowPartition) -> CommPattern:
    """Messages for the halo exchange of y = A x under ``part``."""
    req, col = _needed_pairs(A, part)
    if req.size == 0:
        return CommPattern(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
                           np.zeros(0), part.n_procs)
    owner = part.owner_of(col)
    # one message per distinct (owner -> requester), size = count * 8
    pair_key = owner * part.n_procs + req
    uniq, counts = np.unique(pair_key, return_counts=True)
    return CommPattern(src=(uniq // part.n_procs).astype(np.int64),
                       dst=(uniq % part.n_procs).astype(np.int64),
                       size=counts.astype(np.float64) * SPMV_ENTRY_BYTES,
                       n_procs=part.n_procs)


def spgemm_comm_pattern(A: CSR, B: CSR, part: RowPartition) -> CommPattern:
    """Messages to fetch remote B rows for C = A B under ``part``.

    Process p gathers B rows for its off-process A columns; message size is
    the total nnz of those rows times 12 bytes.
    """
    req, col = _needed_pairs(A, part)
    if req.size == 0:
        return CommPattern(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
                           np.zeros(0), part.n_procs)
    owner = part.owner_of(col)
    row_nnz = B.row_lengths()[col].astype(np.float64)
    pair_key = owner * part.n_procs + req
    order = np.argsort(pair_key, kind="stable")
    pair_key, row_nnz = pair_key[order], row_nnz[order]
    uniq, starts = np.unique(pair_key, return_index=True)
    sums = np.add.reduceat(row_nnz, starts)
    return CommPattern(src=(uniq // part.n_procs).astype(np.int64),
                       dst=(uniq % part.n_procs).astype(np.int64),
                       size=sums * SPGEMM_NNZ_BYTES,
                       n_procs=part.n_procs)
