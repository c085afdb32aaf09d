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

Port note: only the stack path exists — every sweep, even of one phase, is
one :class:`~repro_torch.comm.stack.PhaseStack` priced on its device; the
per-phase results come back to the host once per ladder level.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm.stack import PhaseStack, as_stack

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


def queue_time(params: CommParams, n_messages):
    """Paper Eq. (3): T_q = gamma * n^2 (upper bound, adverse receive order);
    ``n_messages`` may be a number or a tensor."""
    return params.gamma * n_messages * n_messages


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
    ``device`` (``None`` = CUDA), or an already-built
    :class:`~repro_torch.comm.stack.PhaseStack` (priced on its own device).
    ``params`` substitutes another table — a fitted one — for the
    machine's own.
    """
    if level not in MODEL_LEVELS:
        raise ValueError(f"unknown model level {level!r}")
    return _stack_costs(as_stack(phases, device), level, params)


def model_ladder_many(phases, params: CommParams | None = None,
                      device=None) -> list[dict[str, CostBreakdown]]:
    """Evaluate the full model ladder on a sweep of phases: the arena is
    stacked once and swept once per ladder level."""
    stack = as_stack(phases, device)
    out: list[dict[str, CostBreakdown]] = [{} for _ in range(stack.n_phases)]
    agg_cache: dict = {}
    for lvl in MODEL_LEVELS:
        for row, cb in zip(out, _stack_costs(stack, lvl, params,
                                             agg_cache=agg_cache)):
            row[lvl] = cb
    return out
