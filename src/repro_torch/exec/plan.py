"""Lower a strategy rewrite to an executable message-passing schedule.

The pricing layer (:mod:`repro_torch.comm.strategies`) rewrites a bound
:class:`~repro_torch.comm.phase.CommPhase` into a sequence of phases whose
*sizes* are what the model and simulator consume — aggregated and (for the
split strategies) divided into fractional per-injector shares.  Fractions price
correctly but cannot be *executed* byte-exactly, so the planner here works
in **integral payload units**: each original message becomes
``ceil(size / unit_bytes)`` (>= 1) tagged int32 words, and every unit takes
the integer-rank route that mirrors its strategy's rewrite semantics:

``standard`` / ``local``
    origin -> destination, one hop.
``two_step``
    origin -> sender-node leader -> receiver-node leader -> destination.
``three_step`` / ``host_staged``
    unit ``j`` of a message rides injector slot ``j mod k`` (``k`` = ranks
    available on both end nodes, exactly the rewrite's share fan-out):
    origin -> sender-node rank ``k_j`` -> receiver-node rank ``k_j`` ->
    destination.  ``host_staged`` additionally records the ``d2h`` / ``h2d``
    coalesced self-copy phases (zero data motion across ranks — rounds are
    empty, the copy cost lives in the pricing plan).
``device_direct``
    origin -> its device leader -> the destination's device leader ->
    destination.

Hops whose endpoints coincide collapse, so a node leader's own payload
needs no gather message — the same dedup the rewrites apply.  Within each
phase the unit hops are grouped into messages per (holder, next-holder)
pair and the messages are edge-colored into **rounds**: a round is one
permutation (each rank sends to at most one peer and receives from at most
one peer), the collective step the virtual-rank executor
(:mod:`repro_torch.exec.lower`) replays as one gather and two scatter-adds
on the device.  The numpy reference executor
(:mod:`repro_torch.exec.reference`) walks the identical rounds serially,
which is what makes bit-identity a meaningful oracle: both executors
consume *the same* schedule, only the transport differs.

Every schedule self-checks at build time: units flow origin -> destination
through the recorded hops (flow conservation), and the lowered (role, src,
dst) pair set is a subset of the pricing plan's rewritten message rows
(:meth:`repro_torch.comm.strategies.StrategyPlan.schedule`) — the planner
can never invent traffic the model did not price.

Port note: a copy of the reference planner, host numpy throughout, so its
schedules equal the reference's field by field: the greedy, order-dependent
edge coloring, the stable argsort and the ``np.unique`` grouping are kept
exactly (another coloring would change the rounds).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.comm.phase import CommPhase
from repro_torch.comm.primitives import segmented_arange
from repro_torch.comm.strategies import (ROLES, StrategyPlan, _avail,
                                         _remote_mask, rewrite)

#: Default payload-unit granularity (bytes per int32 tracer unit).  Small
#: enough that multi-unit messages exercise the k-way injector fan-out on
#: realistic sizes, large enough to keep unit counts modest.
UNIT_BYTES = 512.0

#: Round-construction policies: ``greedy`` edge-colors each phase's messages
#: into few permutation rounds; ``per_message`` gives every message its own
#: round (the naive one-round-per-message baseline the perf gate compares
#: against).
COLORINGS = ("greedy", "per_message")

_PAYLOAD_MOD = 2147483647


def units_for(size, unit_bytes: float = UNIT_BYTES) -> np.ndarray:
    """Payload units per message: ``ceil(size / unit_bytes)`` with a floor
    of one, so zero- and sub-unit-``size`` messages still carry a traceable
    payload unit."""
    size = np.asarray(size, dtype=np.float64).ravel()
    return np.maximum(1, np.ceil(size / float(unit_bytes))).astype(np.int64)


def synth_payload(unit_msg) -> np.ndarray:
    """Deterministic nonzero int32 payload per unit: a multiplicative hash
    of the unit index and its owning message id ``unit_msg``, so a dropped,
    duplicated or misrouted unit always changes the delivered matrix."""
    unit_msg = np.asarray(unit_msg, dtype=np.int64).ravel()
    u = np.arange(unit_msg.size, dtype=np.int64)
    return ((u * 2654435761 + unit_msg * 40503 + 97) % _PAYLOAD_MOD
            + 1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ExecRound:
    """One collective step: a permutation plus its gather/scatter index
    tables.

    ``perm`` is the (sender, receiver) pair tuple (each rank appears at most
    once per side).  ``pack[p, w]`` is the unit id rank ``p`` loads into
    send slot ``w``; on arrival the receiver scatters slot ``w`` into its
    holding buffer at ``stage[p, w]`` (unit still in transit) or into its
    delivered buffer at ``final[p, w]`` (unit at its destination).  Unused
    slots point at the sink column (index ``n_units``), whose junk flow is
    discarded — padding never aliases a real unit.
    """

    perm: tuple
    pack: np.ndarray
    stage: np.ndarray
    final: np.ndarray

    @property
    def width(self) -> int:
        return int(self.pack.shape[1])


@dataclasses.dataclass(frozen=True)
class ExecPhase:
    """One lowered phase: the strategy role, the per-(src, dst) message
    grouping, and the permutation rounds that move it.

    ``msg_src[i] -> msg_dst[i]`` carries ``msg_units[i]`` payload units.
    Copy roles (``d2h`` / ``h2d``) hold coalesced self-messages and no
    rounds — they stage payload in place, moving nothing across ranks.
    """

    role: str
    msg_src: np.ndarray
    msg_dst: np.ndarray
    msg_units: np.ndarray
    rounds: tuple

    @property
    def n_msgs(self) -> int:
        return int(self.msg_src.size)

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


@dataclasses.dataclass(frozen=True)
class ExecSchedule:
    """An executable lowering of one strategy applied to one phase.

    ``payload[u]`` is the int32 word unit ``u`` carries from rank
    ``unit_src[u]`` to rank ``unit_dst[u]`` on behalf of original message
    ``unit_msg[u]``; ``phases`` are the lowered :class:`ExecPhase` steps in
    execution order and ``plan`` is the pricing-side
    :class:`~repro_torch.comm.strategies.StrategyPlan` the schedule was
    lowered from (the model prices ``plan``, the executors run ``phases`` —
    the measured-vs-predicted comparison joins the two).  ``unit_bytes`` and
    ``coloring`` record the planner knobs that produced it.
    """

    strategy: str
    n_procs: int
    unit_bytes: float
    coloring: str
    payload: np.ndarray
    unit_src: np.ndarray
    unit_dst: np.ndarray
    unit_msg: np.ndarray
    phases: tuple
    plan: StrategyPlan

    @property
    def n_units(self) -> int:
        return int(self.payload.size)

    @property
    def n_rounds(self) -> int:
        return sum(ph.n_rounds for ph in self.phases)

    @property
    def n_msgs(self) -> int:
        return sum(ph.n_msgs for ph in self.phases)


def _color_rounds(msg_src, msg_dst, coloring: str) -> list:
    """Greedy edge coloring: place each message in the first round where its
    sender and receiver are both free (each rank sends/receives at most once
    per round)."""
    if coloring == "per_message":
        return [[i] for i in range(msg_src.size)]
    rounds: list = []
    for i in range(msg_src.size):
        s, d = int(msg_src[i]), int(msg_dst[i])
        for senders, receivers, members in rounds:
            if s not in senders and d not in receivers:
                senders.add(s)
                receivers.add(d)
                members.append(i)
                break
        else:
            rounds.append(({s}, {d}, [i]))
    return [members for _, _, members in rounds]


def _movement_phase(role, frm, to, uid, unit_dst, n_procs, sink, coloring):
    """Group one hop set into messages and color them into rounds; None when
    every hop collapses (endpoints equal) or the set is empty."""
    move = frm != to
    frm, to, uid = frm[move], to[move], uid[move]
    if frm.size == 0:
        return None
    order = np.argsort(frm * np.int64(n_procs) + to, kind="stable")
    frm, to, uid = frm[order], to[order], uid[order]
    key = frm * np.int64(n_procs) + to
    _, starts, counts = np.unique(key, return_index=True, return_counts=True)
    msg_src, msg_dst = frm[starts], to[starts]

    rounds = []
    for members in _color_rounds(msg_src, msg_dst, coloring):
        width = int(max(counts[i] for i in members))
        pack = np.full((n_procs, width), sink, dtype=np.int32)
        stage = np.full((n_procs, width), sink, dtype=np.int32)
        final = np.full((n_procs, width), sink, dtype=np.int32)
        perm = []
        for i in members:
            s, d = int(msg_src[i]), int(msg_dst[i])
            ids = uid[starts[i]:starts[i] + counts[i]]
            w = ids.size
            pack[s, :w] = ids
            at_dest = unit_dst[ids] == d
            final[d, :w][at_dest] = ids[at_dest]
            stage[d, :w][~at_dest] = ids[~at_dest]
            perm.append((s, d))
        rounds.append(ExecRound(perm=tuple(perm), pack=pack, stage=stage,
                                final=final))
    return ExecPhase(role=role, msg_src=msg_src, msg_dst=msg_dst,
                     msg_units=counts.astype(np.int64), rounds=tuple(rounds))


def _copy_phase(role, ranks, uid) -> ExecPhase:
    """A ``d2h``/``h2d`` staging phase: one coalesced self-copy per rank,
    zero rounds (nothing crosses a rank boundary)."""
    uranks, counts = np.unique(ranks, return_counts=True)
    return ExecPhase(role=role, msg_src=uranks, msg_dst=uranks,
                     msg_units=counts.astype(np.int64), rounds=())


def build_schedule(phase: CommPhase, strategy: str, *,
                   unit_bytes: float = UNIT_BYTES,
                   coloring: str = "greedy") -> ExecSchedule:
    """Lower ``strategy`` applied to the bound ``phase`` into an
    :class:`ExecSchedule`.

    ``unit_bytes`` sets the payload-unit granularity (module default
    ``UNIT_BYTES``); ``coloring`` picks the round policy from ``COLORINGS``.
    The returned schedule is self-checked: units are flow-conserved through
    the recorded hops and the lowered pair set is a subset of the pricing
    plan's (:func:`pairs_subset_of_plan`).
    """
    if coloring not in COLORINGS:
        raise ValueError(f"unknown coloring {coloring!r}; "
                         f"expected one of {COLORINGS}")
    m, P = phase.machine, phase.n_procs
    plan = rewrite(phase, strategy)
    u = units_for(phase.size, unit_bytes)
    msg = np.repeat(np.arange(phase.n_msgs), u)
    unit_src = phase.src[msg].astype(np.int64)
    unit_dst = phase.dst[msg].astype(np.int64)
    uid = np.arange(msg.size)
    payload = synth_payload(msg)
    sink = msg.size

    # hop groups in execution order; degenerate rewrites (no remote traffic)
    # lower exactly like ``standard``, mirroring the pricing side
    degenerate = plan.roles == ("standard",)
    groups: list = []
    if strategy == "standard" or degenerate:
        groups.append(("standard", unit_src, unit_dst, uid))
    else:
        remote = _remote_mask(phase)[msg]
        groups.append(("local", unit_src[~remote], unit_dst[~remote],
                       uid[~remote]))
        rs, rd, ru = unit_src[remote], unit_dst[remote], uid[remote]
        if strategy == "device_direct":
            ppd = np.int64(m.procs_per_device)
            inj = (rs // ppd) * ppd
            rinj = (rd // ppd) * ppd
        else:
            ppn = np.int64(m.procs_per_node)
            sn = np.asarray(m.node_of(rs), dtype=np.int64)
            dn = np.asarray(m.node_of(rd), dtype=np.int64)
            if strategy == "two_step":
                slot = np.zeros(rs.size, dtype=np.int64)
            else:
                j = segmented_arange(u)[remote]     # unit index in message
                slot = j % np.minimum(_avail(m, sn, P), _avail(m, dn, P))
            inj = sn * ppn + slot
            rinj = dn * ppn + slot
        if strategy == "host_staged":
            groups.append(("d2h", rs, rs, ru))
        groups.append(("gather", rs, inj, ru))
        groups.append(("inter", inj, rinj, ru))
        groups.append(("scatter", rinj, rd, ru))
        if strategy == "host_staged":
            groups.append(("h2d", rd, rd, ru))

    # flow conservation: every unit walks origin -> destination through the
    # recorded hops, each hop leaving from the unit's current holder
    holder = unit_src.copy()
    for role, frm, to, gid in groups:
        if role in ("d2h", "h2d"):
            continue
        mov = frm != to
        if not np.array_equal(holder[gid[mov]], frm[mov]):
            raise ValueError(f"flow violation lowering {strategy!r}: "
                             f"{role} hop leaves from a non-holder rank")
        holder[gid[mov]] = to[mov]
    if not np.array_equal(holder, unit_dst):
        raise ValueError(f"flow violation lowering {strategy!r}: "
                         "units do not end at their destinations")

    phases = []
    for role, frm, to, gid in groups:
        if role in ("d2h", "h2d"):
            ph = _copy_phase(role, frm, gid) if frm.size else None
        else:
            ph = _movement_phase(role, frm, to, gid, unit_dst, P, sink,
                                 coloring)
        if ph is not None:
            phases.append(ph)

    schedule = ExecSchedule(strategy=strategy, n_procs=P,
                            unit_bytes=float(unit_bytes), coloring=coloring,
                            payload=payload, unit_src=unit_src,
                            unit_dst=unit_dst, unit_msg=msg.astype(np.int64),
                            phases=tuple(phases), plan=plan)
    if not pairs_subset_of_plan(schedule):
        raise ValueError(f"lowering {strategy!r} produced a (role, src, dst) "
                         "pair its pricing plan does not carry")
    return schedule


def pairs_subset_of_plan(schedule: ExecSchedule) -> bool:
    """True when every (role, src, dst) message of ``schedule``'s lowered
    phases appears among its pricing plan's rewritten rows
    (:meth:`repro_torch.comm.strategies.StrategyPlan.schedule`) — the
    integral unit routing must never invent traffic the model did not
    price.  The sets coincide exactly when every remote message carries at
    least ``k`` units; with fewer, the lowered set is a strict subset
    (unused injector slots send nothing)."""
    rows = schedule.plan.schedule()
    plan_pairs = set(zip(rows["role"].tolist(), rows["src"].tolist(),
                         rows["dst"].tolist()))
    for ph in schedule.phases:
        role = ROLES.index(ph.role)
        for s, d in zip(ph.msg_src.tolist(), ph.msg_dst.tolist()):
            if (role, s, d) not in plan_pairs:
                return False
    return True
