"""Communication performance models, priced over a PhaseStack on a device.

Model hierarchy (each row adds one of the paper's contributions):

==============  =====================================================
``postal``      T = alpha + s / Rb                      (single class)
``maxrate``     T = alpha + ppn*s / min(RN, ppn*Rb)     (single class)
``node_aware``  per-locality (alpha, Rb, RN)            (Section 3)
``+queue``      + gamma * n_recv^2                      (Section 4.1)
``+contention`` + delta * ell                           (Section 4.2)
==============  =====================================================

Aggregation follows the paper: per-process transport sums (max over
processes), a single worst-process queue term ``gamma * n^2`` and a single
contention term ``delta * ell`` per phase.

Port note: a bound phase, or a sweep of them, is priced as one
:class:`~repro_torch.comm.stack.PhaseStack` on its device, whose results
come back to the host once per ladder level.  The array-level entry
:func:`phase_cost` prices raw message arrays with torch ops on the device:
per-message times by :func:`message_time`, per-process sums by kernel K1
(:func:`~repro_torch.comm.primitives.per_proc_sums`) and one host read of
its three terms.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.guard import validate_messages
from repro_torch.comm.primitives import (active_senders_per_node,
                                         per_proc_sums, transport_times)
from repro_torch.comm.stack import PhaseStack, as_stack
from repro_torch.device import resolve_device

from .params import CommParams
from .topology import contention_ell

MODEL_LEVELS = ("postal", "maxrate", "node_aware", "queue", "contention")


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Seconds per phase, split by source (paper Figs. 10-11 stacked bars)."""

    transport: float       # max-rate (or postal) term, max over processes
    queue: float           # gamma * n^2, worst process
    contention: float      # delta * ell
    total: float


# -- per-message time ------------------------------------------------------

def message_time(params: CommParams, size, loc, ppn=1, node_aware: bool = True,
                 use_maxrate: bool = True, device=None) -> torch.Tensor:
    """Vectorized single-message time, float32 on ``device`` (``None`` =
    CUDA).

    ``size`` / ``loc`` are host arrays (or scalars) of bytes and locality
    classes; ``ppn`` is the number of *actively communicating* processes on
    the sending node (scalar or per-message array).  With
    ``node_aware=False`` every message is priced with the network-class
    parameters (the paper's Fig.-2 baseline).  With ``use_maxrate=False``
    the injection cap is ignored (pure postal).
    """
    dev = resolve_device(device)
    size, loc, ppn = np.broadcast_arrays(np.asarray(size, dtype=np.float64),
                                         np.asarray(loc, dtype=np.int64),
                                         np.asarray(ppn, dtype=np.float64))
    if not node_aware:
        loc = np.full_like(loc, params.network_locality)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    li = put(loc, torch.int64)
    pi = put(params.protocol_of(size), torch.int64)
    alpha, Rb = put(params.alpha)[li, pi], put(params.Rb)[li, pi]
    size_t = put(size)
    if not use_maxrate:
        return transport_times(size_t, alpha, Rb, use_maxrate=False)
    # only network-class messages contend for injection bandwidth; a node's
    # active senders divide across its NICs (CommParams.n_rails)
    return transport_times(size_t, alpha, Rb, put(params.RN)[li, pi],
                           put(ppn), li >= params.network_locality,
                           rails=params.n_rails)


def queue_time(params: CommParams, n_messages):
    """Paper Eq. (3): T_q = gamma * n^2 (upper bound, adverse receive order);
    ``n_messages`` may be a number or a tensor."""
    return params.gamma * n_messages * n_messages


def contention_time(params: CommParams, n_torus_nodes: int, torus_ndim: int,
                    avg_net_bytes_per_proc: float,
                    procs_per_torus_node: int) -> float:
    """Paper Eqs. (5)-(7): T_c = delta * ell, cube-partition estimate."""
    ell = contention_ell(n_torus_nodes, torus_ndim, avg_net_bytes_per_proc,
                         procs_per_torus_node)
    return float(params.delta * ell)


# -- phase-level aggregation ------------------------------------------------

def _sender_nodes(src: np.ndarray, node_of) -> np.ndarray:
    """Resolve a process->node map (array or callable) to per-message nodes."""
    if callable(node_of):
        try:
            nodes = np.asarray(node_of(src), dtype=np.int64)
            if nodes.shape != src.shape:
                raise TypeError
        except (TypeError, ValueError):   # scalar-only callable fallback
            nodes = np.asarray([node_of(int(p)) for p in src], dtype=np.int64)
        return nodes
    return np.asarray(node_of, dtype=np.int64)[src]


def phase_cost(params: CommParams, src, dst, size, loc, *,
               node_of=None,
               n_torus_nodes: int | None = None,
               torus_ndim: int = 3,
               procs_per_torus_node: int = 1,
               n_procs: int | None = None,
               level: str = "contention",
               active_ppn=None, validate: bool = False,
               device=None) -> CostBreakdown:
    """Model the cost of one communication phase (e.g. one SpMV halo
    exchange) from its message arrays, on ``device`` (``None`` = CUDA).

    Parameters
    ----------
    src, dst, size, loc : per-message host arrays.
    node_of : process -> node map (callable or array); required for max-rate.
    n_torus_nodes, torus_ndim, procs_per_torus_node : contention geometry.
    level : which rung of the model ladder to evaluate (``MODEL_LEVELS``).
    active_ppn : precomputed active-senders-per-node array (e.g. the cached
        ``CommPhase.active_ppn``); skips the ``node_of`` recomputation.
    validate : run :func:`repro_torch.comm.guard.validate_messages` over the
        message arrays first — NaN/negative sizes and out-of-range ranks
        raise a precise ``PatternError`` subclass instead of pricing garbage.

    Per-message times are float32 on the device; the per-process transport
    sums are one call of kernel K1, the receive counts one ``bincount``, and
    the worst process's transport, the worst receive count and the network
    bytes come back to the host in one read.
    """
    if level not in MODEL_LEVELS:
        raise ValueError(f"unknown model level {level!r}")
    dev = resolve_device(device)
    if validate:
        validate_messages(np.asarray(src).ravel(), np.asarray(dst).ravel(),
                          np.asarray(size).ravel(), n_procs=n_procs,
                          where="phase_cost")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    size = np.asarray(size, dtype=np.float64)
    loc = np.asarray(loc, dtype=np.int64)
    rank = MODEL_LEVELS.index(level)
    node_aware = rank >= MODEL_LEVELS.index("node_aware")
    use_maxrate = rank >= MODEL_LEVELS.index("maxrate")

    if src.size == 0:
        return CostBreakdown(0.0, 0.0, 0.0, 0.0)

    is_net = loc >= params.network_locality
    if use_maxrate and active_ppn is not None:
        ppn = np.asarray(active_ppn, dtype=np.float64)
    elif use_maxrate and node_of is not None:
        ppn = active_senders_per_node(src, _sender_nodes(src, node_of),
                                      is_net)
    else:
        ppn = np.ones_like(size)
    t_msg = message_time(params, size, loc, ppn=ppn, node_aware=node_aware,
                         use_maxrate=use_maxrate, device=dev)

    n_procs = int(n_procs if n_procs is not None
                  else max(src.max(), dst.max()) + 1)
    src_t, dst_t = (torch.from_numpy(a.ravel()).to(dev) for a in (src, dst))
    net = torch.from_numpy(np.where(is_net, size, 0.0).ravel()).to(dev)
    # transport: worst process over the send-side sums (K1)
    transport, n_recv, net_bytes = torch.stack([
        per_proc_sums(src_t, t_msg.ravel(), n_procs).max().double(),
        torch.bincount(dst_t, minlength=n_procs).max().double(),
        net.sum()]).tolist()

    queue = 0.0
    if rank >= MODEL_LEVELS.index("queue"):
        queue = float(queue_time(params, n_recv))

    cont = 0.0
    if (level == "contention" and n_torus_nodes is not None
            and n_torus_nodes > 1 and net_bytes > 0.0):
        b = net_bytes / n_procs   # avg bytes sent per process (paper's b)
        cont = contention_time(params, n_torus_nodes, torus_ndim, b,
                               procs_per_torus_node)

    return CostBreakdown(transport, queue, cont, transport + queue + cont)


def model_ladder(params: CommParams, src, dst, size, loc,
                 **kw) -> dict[str, CostBreakdown]:
    """Evaluate every model level on the same phase (for accuracy tables);
    keyword arguments, ``device`` included, go to :func:`phase_cost`."""
    return {lvl: phase_cost(params, src, dst, size, loc, level=lvl, **kw)
            for lvl in MODEL_LEVELS}


# -- entry points over bound phases -----------------------------------------

def phase_cost_phase(phase, level: str = "contention",
                     params: CommParams | None = None,
                     device=None) -> CostBreakdown:
    """Price one bound :class:`~repro_torch.comm.phase.CommPhase` on
    ``device`` (``None`` = CUDA), as a one-phase stack.

    Locality, active-sender counts and contention geometry all come from the
    phase's cached arrays and machine; ``params`` overrides the machine's
    ground-truth table (e.g. with a fitted one) while keeping the machine's
    locality classification (a table that reclassifies localities gets its
    active-sender counts recomputed).
    """
    if level not in MODEL_LEVELS:
        raise ValueError(f"unknown model level {level!r}")
    dev = resolve_device(device)
    if phase.n_msgs == 0:
        return CostBreakdown(0.0, 0.0, 0.0, 0.0)
    return _stack_costs(PhaseStack.build([phase], device=dev), level,
                        params)[0]


def _stack_costs(stack: PhaseStack, level: str,
                 params: CommParams | None,
                 agg_cache: dict | None = None) -> list[CostBreakdown]:
    """Price a stacked sweep at one ladder level: one segmented pass per
    quantity on the stack's device.

    ``agg_cache`` memoizes the raw aggregates by (node_aware, use_maxrate):
    the three ladder levels at or above ``node_aware`` share the same
    transport pass.
    """
    m = stack.machine
    p = params if params is not None else m.params
    rank = MODEL_LEVELS.index(level)
    with_queue = rank >= MODEL_LEVELS.index("queue")
    with_cont = level == "contention" and m.torus.size > 1
    flags = (rank >= MODEL_LEVELS.index("node_aware"),
             rank >= MODEL_LEVELS.index("maxrate"))
    if agg_cache is not None and flags in agg_cache:
        transport, max_recv, net_bytes = agg_cache[flags]
    else:
        transport, max_recv, net_bytes = stack.cost_arrays(
            p, node_aware=flags[0], use_maxrate=flags[1],
            with_queue=with_queue or agg_cache is not None,
            with_net_bytes=with_cont or (agg_cache is not None and flags[0]))
        if agg_cache is not None:
            agg_cache[flags] = (transport, max_recv, net_bytes)
    transport = transport.double()
    zeros = torch.zeros_like(transport)
    queue = (queue_time(p, max_recv.double()) if with_queue else zeros)
    cont = zeros
    if with_cont:
        nb = net_bytes.double()
        b = nb / torch.as_tensor(stack.n_procs, dtype=torch.float64,
                                 device=nb.device)
        ell = contention_ell(m.torus.size, m.torus.ndim, b,
                             m.procs_per_torus_node)
        cont = torch.where(nb > 0.0, p.delta * ell, zeros)
    rows = torch.stack([transport, queue, cont]).T.tolist()
    return [CostBreakdown(t, q, c, t + q + c) for t, q, c in rows]


def phase_cost_many(phases, level: str = "contention",
                    params: CommParams | None = None,
                    device=None) -> list[CostBreakdown]:
    """Price a whole sweep of phases (an AMG hierarchy, a strategy candidate
    set) in one call.

    ``phases`` is a sequence of bound phases on one machine, stacked on
    ``device`` (``None`` = CUDA), or an already-built arena — a
    :class:`~repro_torch.comm.stack.PhaseStack` or a
    :class:`~repro_torch.comm.delta.DeltaStack`, priced on its own device
    (a ``DeltaStack`` from its incremental caches).  ``params`` substitutes
    another table — a fitted one — for the machine's own.
    """
    if level not in MODEL_LEVELS:
        raise ValueError(f"unknown model level {level!r}")
    stack = as_stack(phases, device)
    if stack.n_phases == 0:                    # an empty DeltaStack
        return []
    return _stack_costs(stack, level, params)


def model_ladder_many(phases, params: CommParams | None = None,
                      device=None) -> list[dict[str, CostBreakdown]]:
    """Evaluate the full model ladder on a sweep of phases: the arena is
    stacked once and swept once per ladder level (a ``PhaseStack`` or
    ``DeltaStack`` passes straight through)."""
    stack = as_stack(phases, device)
    if stack.n_phases == 0:                    # an empty DeltaStack
        return []
    out: list[dict[str, CostBreakdown]] = [{} for _ in range(stack.n_phases)]
    agg_cache: dict = {}
    for lvl in MODEL_LEVELS:
        for row, cb in zip(out, _stack_costs(stack, lvl, params,
                                             agg_cache=agg_cache)):
            row[lvl] = cb
    return out


def sequence_cost(phases, level: str = "contention",
                  params: CommParams | None = None,
                  device=None) -> CostBreakdown:
    """Price a multi-phase *sequence* (e.g. a strategy rewrite's
    gather -> inter -> scatter) as one stack on ``device`` (``None`` =
    CUDA).  Phases execute back-to-back — each must complete before the
    next posts — so per-phase costs add."""
    if not isinstance(phases, PhaseStack):
        phases = list(phases)
        if not phases:
            resolve_device(device)
            return CostBreakdown(0.0, 0.0, 0.0, 0.0)
    parts = phase_cost_many(phases, level=level, params=params, device=device)
    return CostBreakdown(
        transport=sum(p.transport for p in parts),
        queue=sum(p.queue for p in parts),
        contention=sum(p.contention for p in parts),
        total=sum(p.total for p in parts))
