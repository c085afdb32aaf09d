"""Row partitions and the communication pattern of parallel SpMV.

Given a 1-D (row-wise) partition of a sparse matrix over P processes, the
halo exchange of y = A x sends, for every (owner -> requester) pair, the
distinct x entries the requester's rows touch (8 bytes each); the SpGEMM
C = A B fetches the B rows behind those columns (12 bytes a nonzero).
:meth:`CommPattern.bind` turns a pattern into a machine-bound
:class:`~repro_torch.comm.phase.CommPhase` and :func:`stack_patterns` a
sweep of them into one :class:`~repro_torch.comm.stack.PhaseStack`.

A boundary-shift move on the partition changes only the messages of the two
adjacent processes: :class:`SpmvPatternState` and
:func:`spmv_comm_pattern_delta` re-derive exactly those, as the
``(removed, added)`` delta :meth:`repro_torch.comm.delta.DeltaStack.apply`
takes.

Port note: pattern extraction and the incremental state are host numpy;
only :func:`stack_patterns` (and the entry points a pattern feeds) put
anything on the device.
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


# -- incremental SpMV pattern re-derivation ----------------------------------
#
# A local-search move on the row partition (shift one boundary) changes the
# ownership of a handful of rows — and therefore only the messages that
# involve the two adjacent processes.  ``SpmvPatternState`` keeps the
# partition-independent needs of every process (the distinct columns its rows
# touch) as one sorted packed array, so a move re-derives exactly the
# affected messages:
#
# * the *requester* side — messages **to** a changed process — from that
#   process's recomputed need set (O(its rows' nnz));
# * the *owner* side — messages **from** a changed process to everyone else —
#   by counting each unchanged process's needs inside the mover's new
#   contiguous row range: two ``searchsorted`` probes per process on the
#   packed (process, column) array, no nnz traversal at all.
#
# The returned (removed indices, added messages) pair feeds
# :meth:`repro_torch.comm.delta.DeltaStack.apply` directly; survivors keep
# their arena positions, additions append — the delta arena and the state
# stay in lockstep message order.

@dataclasses.dataclass(frozen=True)
class SpmvPatternState:
    """Incrementally-maintained SpMV halo-exchange pattern for one matrix.

    ``pairs`` holds every distinct (row-owner process ``q``, column ``c``)
    pair — including locally-owned columns, because a boundary move can turn
    a local column remote — packed as ``q * n_cols + c`` and globally
    sorted; ``seg[q]:seg[q+1]`` is process ``q``'s slice.  ``src/dst/size``
    mirror the live message order of the delta arena built from this state.

    Successor states created by :func:`spmv_comm_pattern_delta` carry the
    splice of the changed processes' need segments *lazily*: candidate
    evaluation never touches it, so a rejected candidate's state costs
    nothing beyond its own message delta; the splice resolves on first
    access (i.e. when an accepted state is searched from).
    """

    A: CSR
    starts: np.ndarray       # [P+1] current partition boundaries
    src: np.ndarray          # current messages, arena order
    dst: np.ndarray
    size: np.ndarray
    # resolved form {"pairs": ..., "seg": ...}, or the deferred splice
    # {"parent": state, "changed": ..., "segs_new": ...}
    _box: dict = dataclasses.field(repr=False, compare=False,
                                   default_factory=dict)

    @classmethod
    def build(cls, A: CSR, part: RowPartition) -> "SpmvPatternState":
        """Full derivation (the one-time cost a fresh pattern also pays)."""
        starts = np.asarray(part.starts, dtype=np.int64)
        P = part.n_procs
        rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
        req = part.owner_of(rows).astype(np.int64)
        pairs = np.unique(req * A.n_cols + A.indices)
        seg = np.searchsorted(pairs, np.arange(P + 1) * A.n_cols)
        src, dst, size = _pairs_to_messages(pairs, starts, A.n_cols, P)
        return cls(A=A, starts=starts, src=src, dst=dst, size=size,
                   _box={"pairs": pairs, "seg": seg})

    def _resolve(self) -> dict:
        box = self._box
        if "pairs" not in box:
            parent = box.pop("parent")
            changed = box.pop("changed")
            segs_new = box.pop("segs_new")
            P = self.n_procs
            parts, prev = [], 0
            for q in changed:
                parts.append(parent.pairs[parent.seg[prev]:parent.seg[q]])
                parts.append(segs_new[int(q)])
                prev = int(q) + 1
            parts.append(parent.pairs[parent.seg[prev]:])
            box["pairs"] = np.concatenate(parts)
            box["seg"] = np.searchsorted(box["pairs"],
                                         np.arange(P + 1) * self.A.n_cols)
        return box

    @property
    def pairs(self) -> np.ndarray:
        return self._resolve()["pairs"]

    @property
    def seg(self) -> np.ndarray:
        return self._resolve()["seg"]

    @property
    def n_procs(self) -> int:
        return len(self.starts) - 1

    @property
    def part(self) -> RowPartition:
        return RowPartition(self.starts)

    @property
    def pattern(self) -> CommPattern:
        """The current messages as a :class:`CommPattern` (arena order)."""
        return CommPattern(self.src, self.dst, self.size, self.n_procs)


def _pairs_to_messages(pairs, starts, n_cols, P):
    """Messages per distinct (owner -> requester) pair, sorted by (src, dst)
    — the same derivation and order as :func:`spmv_comm_pattern`."""
    if pairs.size == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
                np.zeros(0))
    q = pairs // n_cols
    col = pairs % n_cols
    owner = np.searchsorted(starts, col, side="right") - 1
    off = owner != q
    key = owner[off] * P + q[off]
    uniq, counts = np.unique(key, return_counts=True)
    return ((uniq // P).astype(np.int64), (uniq % P).astype(np.int64),
            counts.astype(np.float64) * SPMV_ENTRY_BYTES)


def spmv_comm_pattern_delta(state: SpmvPatternState, new_starts
                            ) -> tuple[np.ndarray, tuple, "SpmvPatternState"]:
    """Re-derive only the messages a partition change affects.

    Returns ``(removed_idx, (src, dst, size), new_state)``: the indices (into
    the state's — and the delta arena's — current message order) of every
    message that involves a process whose row range changed, the replacement
    messages for those processes, and the successor state.  Functional: the
    input state is untouched, so a rejected candidate is discarded for free.
    The surviving + added message multiset always equals a fresh
    :func:`spmv_comm_pattern` under ``new_starts``.
    """
    A = state.A
    starts = state.starts
    P = state.n_procs
    new_starts = np.asarray(new_starts, dtype=np.int64)
    if new_starts.shape != starts.shape:
        raise ValueError("new_starts must keep the process count fixed")
    if (new_starts[0] != 0 or new_starts[-1] != A.n_rows
            or (np.diff(new_starts) < 0).any()):
        raise ValueError("new_starts must be a non-decreasing partition of "
                         f"[0, {A.n_rows}]")
    changed = np.nonzero((starts[:-1] != new_starts[:-1])
                         | (starts[1:] != new_starts[1:]))[0]
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
             np.zeros(0))
    if changed.size == 0:
        return np.zeros(0, dtype=np.int64), empty, state
    cmask = np.zeros(P, dtype=bool)
    cmask[changed] = True
    removed_idx = np.nonzero(cmask[state.src] | cmask[state.dst])[0]

    # recompute the need segments of the changed processes only
    segs_new = {}
    for q in changed:
        r0, r1 = int(new_starts[q]), int(new_starts[q + 1])
        cols_q = np.unique(A.indices[A.indptr[r0]:A.indptr[r1]])
        segs_new[int(q)] = int(q) * A.n_cols + cols_q

    add_src, add_dst, add_size = [], [], []
    # requester side: messages *to* each changed process, from its needs
    for q in changed:
        cols_q = segs_new[int(q)] - int(q) * A.n_cols
        owner = np.searchsorted(new_starts, cols_q, side="right") - 1
        off = owner != q
        cnt = np.bincount(owner[off], minlength=P)
        o = np.nonzero(cnt)[0]
        add_src.append(o)
        add_dst.append(np.full(o.size, q, dtype=np.int64))
        add_size.append(cnt[o].astype(np.float64) * SPMV_ENTRY_BYTES)
    # owner side: messages *from* each changed process to unchanged ones —
    # count every other process's needs inside the new contiguous row range.
    # Unchanged processes' segments are identical in the current ``pairs``
    # array, so the probes run on it directly; the spliced successor array
    # is deferred (see SpmvPatternState._resolve) and never built for a
    # candidate that gets rejected.
    pairs = state.pairs
    others = np.nonzero(~cmask)[0]
    base = others * A.n_cols
    for o in changed:
        lo, hi = new_starts[o], new_starts[o + 1]
        cnt = (np.searchsorted(pairs, base + hi)
               - np.searchsorted(pairs, base + lo))
        sel = cnt > 0
        add_src.append(np.full(int(sel.sum()), o, dtype=np.int64))
        add_dst.append(others[sel])
        add_size.append(cnt[sel].astype(np.float64) * SPMV_ENTRY_BYTES)

    added = (np.concatenate(add_src) if add_src else empty[0],
             np.concatenate(add_dst) if add_dst else empty[1],
             np.concatenate(add_size) if add_size else empty[2])
    keep = np.ones(state.src.size, dtype=bool)
    keep[removed_idx] = False
    new_state = SpmvPatternState(
        A=A, starts=new_starts,
        src=np.concatenate([state.src[keep], added[0]]),
        dst=np.concatenate([state.dst[keep], added[1]]),
        size=np.concatenate([state.size[keep], added[2]]),
        _box={"parent": state, "changed": changed, "segs_new": segs_new})
    return removed_idx, added, new_state
