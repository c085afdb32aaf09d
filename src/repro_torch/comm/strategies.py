"""Node-aware communication strategies and the strategy sweep.

A strategy is a **rewrite** that transforms one bound
:class:`~repro_torch.comm.phase.CommPhase` into a *sequence* of CommPhases
carrying the same payload along a different route.  Because each step is
itself an ordinary CommPhase, the model ladder and the simulator price
every strategy unchanged and sum the steps.

Strategies (``STRATEGIES``): ``standard`` (identity), ``two_step``
(gather to node leaders, one aggregated message per node pair, scatter) and
``three_step`` (two-step with each node pair's traffic split across ``k``
injectors).  GPU-aware strategies (``GPU_STRATEGIES``, heterogeneous
machines only): ``host_staged`` (d2h copies, node-level k-split aggregation
over the host NIC path, h2d copies) and ``device_direct`` (per-device
3-step injected GPU-NIC direct).  ``strategies_for(machine)`` returns the
set a machine supports; the sweeps default to it.

:func:`best_strategy_many` sweeps every (pattern, strategy) candidate in
one arena per machine: :func:`candidate_set` rewrites the patterns and draws
their arrival orders on the host, :func:`price_candidates` prices the arena
with the model ladder and the simulator on the device.

Port note: the rewrites are host numpy (``np.unique`` / ``bincount``
aggregation via :func:`~repro_torch.comm.primitives.sum_by_pairs`), and each
candidate's random arrival orders come from its own
``np.random.default_rng(seed)``, the reference's stream, so queue steps
compare bit for bit.  A failure while pricing raises; nothing is retried on
another backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.models import CostBreakdown, phase_cost_many
from repro_torch.device import resolve_device
from repro_torch.net.simulator import PhaseResult, simulate_many

from .phase import CommPhase
from .primitives import segmented_arange, sum_by_pairs
from .stack import PhaseStack

STRATEGIES = ("standard", "two_step", "three_step")

#: Heterogeneous-machine strategies (Lockhart's host-staged vs GPU-direct).
GPU_STRATEGIES = ("host_staged", "device_direct")

#: Phase roles, in execution order, as they appear in ``StrategyPlan.roles``.
#: ``d2h`` / ``h2d`` are the staging copy phases (coalesced per-process
#: self-copies at the ``h2d`` rate class) of the ``host_staged`` strategy.
ROLES = ("standard", "local", "d2h", "gather", "inter", "scatter", "h2d")


def strategies_for(machine) -> tuple[str, ...]:
    """The strategy names worth sweeping on ``machine``: the three node-aware
    CPU strategies everywhere, plus ``GPU_STRATEGIES`` when the machine has
    device endpoints and its rate table carries the staged classes."""
    p = machine.params
    if getattr(machine, "devices_per_node", 0) and all(
            p.has_class(c) for c in ("h2d", "host_staged", "device_direct")):
        return STRATEGIES + GPU_STRATEGIES
    return STRATEGIES


def _require_hetero(machine, name: str) -> None:
    """GPU-aware rewrites need device endpoints and the staged rate classes."""
    if name not in strategies_for(machine):
        raise ValueError(
            f"the {name!r} strategy needs a heterogeneous machine (device "
            f"endpoints plus h2d/host_staged/device_direct rate classes); "
            f"{getattr(machine, 'name', machine)!r} has "
            f"{machine.params.locality_names}")


@dataclasses.dataclass(frozen=True)
class StrategyPlan:
    """A strategy applied to one phase: the rewritten phase sequence.

    ``phases[i]`` plays role ``roles[i]`` (see ``ROLES``).  A ``standard``
    role marks an unrewritten phase (the identity strategy, or a rewrite of
    a phase with no inter-node traffic, where every strategy degenerates to
    the identity).
    """

    strategy: str
    original: CommPhase
    phases: tuple[CommPhase, ...]
    roles: tuple[str, ...]

    @property
    def n_phases(self) -> int:
        return len(self.phases)


def _remote_mask(phase: CommPhase) -> np.ndarray:
    """Messages whose sender and receiver live on different nodes."""
    dst_node = np.asarray(phase.machine.node_of(phase.dst), dtype=np.int64)
    return phase.send_node != dst_node


def _avail(machine, nodes: np.ndarray, n_procs: int) -> np.ndarray:
    """Processes of each node that exist within the phase's process range.

    A phase may span fewer processes than the machine hosts (a coarse AMG
    level on a big partition); shares are only fanned across ranks that are
    actually in ``[0, n_procs)``.  Every node that appears in the phase hosts
    at least its leader, so the result is always >= 1.
    """
    ppn = machine.procs_per_node
    return np.minimum(np.int64(ppn), n_procs - nodes * np.int64(ppn))


def _build(machine, parts, n_procs: int) -> tuple[tuple[CommPhase, ...],
                                                  tuple[str, ...]]:
    phases, roles = [], []
    for part in parts:
        role, src, dst, size = part[:4]
        loc = part[4] if len(part) > 4 else None    # explicit class override
        if len(src):
            phases.append(CommPhase.build(machine, src, dst, size,
                                          n_procs=n_procs, loc=loc))
            roles.append(role)
    return tuple(phases), tuple(roles)


def standard(phase: CommPhase) -> StrategyPlan:
    """Identity strategy: the phase as given, in a one-phase sequence."""
    return StrategyPlan("standard", phase, (phase,), ("standard",))


def two_step(phase: CommPhase) -> StrategyPlan:
    """Node-aware aggregation of one bound phase: gather -> one inter-node
    message per node pair -> scatter."""
    return _aggregated(phase, "two_step", split=False)


def three_step(phase: CommPhase) -> StrategyPlan:
    """Two-step of one bound phase with each node pair's traffic split
    across k injectors."""
    return _aggregated(phase, "three_step", split=True)


def host_staged(phase: CommPhase) -> StrategyPlan:
    """Copy-to-host aggregation of one bound phase (hetero machines only):
    d2h copies -> node-level k-way-split aggregation over the *host* NIC
    path -> h2d copies on the receiving side."""
    _require_hetero(phase.machine, "host_staged")
    return _aggregated(phase, "host_staged", split=True, staged=True)


def _aggregated(phase: CommPhase, name: str, split: bool,
                staged: bool = False) -> StrategyPlan:
    m, P = phase.machine, phase.n_procs
    ppn = np.int64(m.procs_per_node)
    remote = _remote_mask(phase)
    if not remote.any():            # nothing to aggregate: identity
        return StrategyPlan(name, phase, (phase,), ("standard",))

    parts = [("local", phase.src[~remote], phase.dst[~remote],
              phase.size[~remote])]
    rs, rd, rsz = phase.src[remote], phase.dst[remote], phase.size[remote]
    rsn = phase.send_node[remote]
    rdn = np.asarray(m.node_of(rd), dtype=np.int64)

    inter_loc = None
    if staged:
        # the staging decision, as explicit class overrides: each process
        # coalesces its off-node payload into one host<->device copy, and
        # the aggregated traffic rides the host NIC path
        h2d = m.params.class_index("h2d")
        inter_loc = m.params.class_index("host_staged")
        parts.append(("d2h", *sum_by_pairs(rs, rs, rsz), h2d))

    # shares per message: 1 (leader only) or k = procs available on both ends
    if split:
        k = np.minimum(_avail(m, rsn, P), _avail(m, rdn, P))
    else:
        k = np.ones(rs.size, dtype=np.int64)
    rep = np.repeat(np.arange(rs.size), k)      # message id of each share
    rank = segmented_arange(k)                  # injector rank of each share
    share = rsz[rep] / k[rep]

    # gather: origin -> the k injector ranks on its own node (equal shares;
    # the share an injector originates itself needs no message)
    g_src, g_dst = rs[rep], rsn[rep] * ppn + rank
    keep = g_src != g_dst
    parts.append(("gather", *sum_by_pairs(g_src[keep], g_dst[keep],
                                          share[keep])))

    # inter: aggregate payload per (send node, recv node), then one message
    # per injector rank r: (S, r) -> (D, r)
    Sn, Dn, B = sum_by_pairs(rsn, rdn, rsz)
    if split:
        kp = np.minimum(_avail(m, Sn, P), _avail(m, Dn, P))
    else:
        kp = np.ones(Sn.size, dtype=np.int64)
    prep = np.repeat(np.arange(Sn.size), kp)
    prank = segmented_arange(kp)
    parts.append(("inter", Sn[prep] * ppn + prank, Dn[prep] * ppn + prank,
                  B[prep] / kp[prep], inter_loc))

    # scatter: the k receiving ranks on the destination node forward each
    # final destination its shares (a rank's own share needs no message)
    s_src, s_dst = rdn[rep] * ppn + rank, rd[rep]
    keep = s_src != s_dst
    parts.append(("scatter", *sum_by_pairs(s_src[keep], s_dst[keep],
                                           share[keep])))

    if staged:
        parts.append(("h2d", *sum_by_pairs(rd, rd, rsz), h2d))

    phases, roles = _build(m, parts, P)
    return StrategyPlan(name, phase, phases, roles)


def device_direct(phase: CommPhase) -> StrategyPlan:
    """Per-device 3-step of one bound phase (hetero machines only): gather
    to device leaders -> one GPU-NIC-direct message per (send-device,
    recv-device) pair -> scatter.  Every node's devices are its injectors;
    no host staging, so no copy phases."""
    m, P = phase.machine, phase.n_procs
    _require_hetero(m, "device_direct")
    ppd = np.int64(m.procs_per_device)
    dd = m.params.class_index("device_direct")
    remote = _remote_mask(phase)
    if not remote.any():            # nothing to aggregate: identity
        return StrategyPlan("device_direct", phase, (phase,), ("standard",))

    parts = [("local", phase.src[~remote], phase.dst[~remote],
              phase.size[~remote])]
    rs, rd, rsz = phase.src[remote], phase.dst[remote], phase.size[remote]
    rsd = rs // ppd                 # global device of origin / destination
    rdd = rd // ppd

    # gather: origin -> its device leader (the device's lowest rank; the
    # leader's own payload needs no message).  Intra-device traffic.
    g_src, g_dst = rs, rsd * ppd
    keep = g_src != g_dst
    parts.append(("gather", *sum_by_pairs(g_src[keep], g_dst[keep],
                                          rsz[keep])))

    # inter: one aggregated leader-to-leader message per (send-device,
    # recv-device) pair, explicitly on the device-direct network path
    # (remote pairs always cross nodes, so the override is consistent with
    # pair geometry even when the machine's default path is host_staged)
    Sd, Dd, B = sum_by_pairs(rsd, rdd, rsz)
    parts.append(("inter", Sd * ppd, Dd * ppd, B, dd))

    # scatter: the receiving device leader forwards each final destination
    # its payload (a leader's own payload needs no message)
    s_src, s_dst = rdd * ppd, rd
    keep = s_src != s_dst
    parts.append(("scatter", *sum_by_pairs(s_src[keep], s_dst[keep],
                                           rsz[keep])))

    phases, roles = _build(m, parts, P)
    return StrategyPlan("device_direct", phase, phases, roles)


_REWRITES = {"standard": standard, "two_step": two_step,
             "three_step": three_step,
             "host_staged": host_staged, "device_direct": device_direct}


def rewrite(phase: CommPhase, strategy: str) -> StrategyPlan:
    """Apply one named ``strategy`` rewrite to a bound ``phase``."""
    try:
        fn = _REWRITES[strategy]
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{STRATEGIES + GPU_STRATEGIES}") from None
    return fn(phase)




# -- the strategy sweep ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StrategyVerdict:
    """Every strategy priced by the model ladder and judged by the simulator.

    ``model[s]`` is the model-ladder total (at the requested level) summed
    over strategy ``s``'s phase sequence; ``sim[s]`` is the simulator's.  The
    *predicted* winner comes from the model alone — the simulator's verdict
    is the ground truth the prediction is scored against.
    """

    plans: dict[str, StrategyPlan]
    model: dict[str, float]
    sim: dict[str, float]
    model_winner: str
    sim_winner: str

    @property
    def agree(self) -> bool:
        return self.model_winner == self.sim_winner


@dataclasses.dataclass(frozen=True)
class CandidateSet:
    """Every (pattern, strategy) candidate of a sweep, rewritten on the host
    and ready to price.

    ``plans[k][s]`` is strategy ``s`` applied to pattern ``k`` and
    ``rows[k][s]`` the arena rows of its phase sequence; ``phases[r]`` is
    arena row ``r`` and ``arrivals[r]`` its arrival-order spec (``None`` =
    posted order).
    """

    plans: list[dict[str, StrategyPlan]]
    rows: list[dict[str, list[int]]]
    phases: list[CommPhase]
    arrivals: list

    @property
    def n_msgs(self) -> int:
        """Messages in the arena (every distinct candidate phase)."""
        return sum(ph.n_msgs for ph in self.phases)


def candidate_set(phases, strategies=None, arrival: str = "random",
                  seed: int = 0) -> CandidateSet:
    """Rewrite every bound phase into every strategy and draw each
    candidate's arrival orders (host numpy).

    ``strategies`` defaults to :func:`strategies_for` each phase's machine.
    ``arrival='random'`` draws each candidate's envelope-arrival orders from
    its own ``np.random.default_rng(seed)``, phase by phase; ``'posted'``
    uses in-order arrival.  A rewrite that leaves a phase alone returns the
    bound phase object itself, always first in its plan and so drawn from a
    fresh generator: that phase takes one arena row, shared by every
    candidate that contains it, so equal candidates price to equal totals.
    """
    if arrival not in ("random", "posted"):
        raise ValueError(f"unknown arrival regime {arrival!r}; "
                         "expected 'random' or 'posted'")
    plans_out, rows_out, arena, arrivals = [], [], [], []
    row_of: dict[int, int] = {}
    for phase in phases:
        plans, rows = {}, {}
        names = (strategies if strategies is not None
                 else strategies_for(phase.machine))
        for name in names:
            plan = rewrite(phase, name)
            rng = np.random.default_rng(seed)
            plans[name] = plan
            rows[name] = []
            for ph in plan.phases:
                spec = (ph.random_arrival_flat(rng) if arrival == "random"
                        else None)
                if id(ph) not in row_of:
                    row_of[id(ph)] = len(arena)
                    arena.append(ph)
                    arrivals.append(spec)
                rows[name].append(row_of[id(ph)])
        plans_out.append(plans)
        rows_out.append(rows)
    return CandidateSet(plans_out, rows_out, arena, arrivals)


def _machine_groups(phases) -> list[list[int]]:
    """Partition ``phases`` indices by machine identity, first-seen order."""
    groups: dict[int, list[int]] = {}
    for i, ph in enumerate(phases):
        groups.setdefault(id(ph.machine), []).append(i)
    return list(groups.values())


def price_candidates(cands: CandidateSet, level: str = "contention",
                     params=None, device=None
                     ) -> tuple[list[CostBreakdown], list[PhaseResult]]:
    """Price every arena row with the model ladder (at ``level``, with
    ``params`` substituted for the machine's table when given) and with the
    simulator (under each row's arrival orders), on ``device`` (``None`` =
    CUDA): one :class:`~repro_torch.comm.stack.PhaseStack` per machine,
    shared by both passes."""
    device = resolve_device(device)
    costs: list = [None] * len(cands.phases)
    sims: list = [None] * len(cands.phases)
    for idx in _machine_groups(cands.phases):
        stack = PhaseStack.build([cands.phases[i] for i in idx], device)
        sub_costs = phase_cost_many(stack, level=level, params=params)
        sub_sims = simulate_many(
            stack, arrival_orders=[cands.arrivals[i] for i in idx])
        for i, c, r in zip(idx, sub_costs, sub_sims):
            costs[i] = c
            sims[i] = r
    return costs, sims


def best_strategy_many(patterns, machine=None, *, strategies=None,
                       level: str = "contention", arrival: str = "random",
                       seed: int = 0, params=None,
                       device=None) -> list[StrategyVerdict]:
    """Sweep strategies over every pattern; return, per pattern, the model's
    pick and the simulator's verdict.

    ``patterns`` holds :class:`repro_torch.sparse.partition.CommPattern`
    objects (bound to ``machine`` here) or already-bound phases (rebound
    when ``machine`` is another machine).  Every (pattern, strategy)
    candidate is rewritten on the host (:func:`candidate_set`) and the
    whole candidate set is priced in one arena per machine on ``device``
    (``None`` = CUDA; raises when no CUDA device exists) by the model
    ladder at ``level`` and by the simulator (:func:`price_candidates`).
    ``params`` substitutes another table — a fitted one — on the model
    side only.  Each candidate keeps its own seeded arrival stream.
    """
    device = resolve_device(device)
    phases = []
    for pat in patterns:
        if hasattr(pat, "bind"):
            if machine is None:
                raise ValueError("a CommPattern needs a machine to bind to")
            phases.append(pat.bind(machine))
        elif machine is not None and machine is not pat.machine:
            phases.append(CommPhase.build(machine, pat.src, pat.dst,
                                          pat.size, n_procs=pat.n_procs))
        else:
            phases.append(pat)
    cands = candidate_set(phases, strategies=strategies, arrival=arrival,
                          seed=seed)
    costs, sims = price_candidates(cands, level=level, params=params,
                                   device=device)
    out = []
    for plans, rows in zip(cands.plans, cands.rows):
        model = {name: sum(costs[r].total for r in rows[name])
                 for name in plans}
        sim = {name: sum(sims[r].time for r in rows[name]) for name in plans}
        out.append(StrategyVerdict(
            plans=plans, model=model, sim=sim,
            model_winner=min(model, key=model.get),
            sim_winner=min(sim, key=sim.get)))
    return out


def best_strategy(pattern, machine=None, **kw) -> StrategyVerdict:
    """:func:`best_strategy_many` for one pattern (same keyword
    arguments)."""
    return best_strategy_many([pattern], machine, **kw)[0]
