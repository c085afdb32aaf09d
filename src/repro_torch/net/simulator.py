"""Event-level communication simulator (the "measured" side of the paper).

For each communication phase of a sweep:

* every message is priced with the machine's ground-truth node-aware
  parameters, with node-injection saturation computed from the *actual*
  number of actively-sending processes per node;
* the MPI receive queue is simulated: each process posts receives in a given
  order, envelopes arrive in network order, and every arrival walks the
  posted queue until it matches — traversal steps are counted exactly and
  priced at gamma per step;
* network messages are routed dimension-ordered over the torus; per-link
  byte counters feed a contention penalty of delta * (hottest-link
  contended bytes).

Port note: a phase, or a sweep of them, is one
:class:`~repro_torch.comm.stack.PhaseStack` priced on its device, with the
exact queue walk in kernel K2 and the reductions in kernel K1 — the
per-phase entries :func:`simulate` and :func:`simulate_phase` price a
one-phase stack.  The optional noise stream stays a numpy generator, drawn
on the host in the reference's order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.phase import CommPhase
from repro_torch.comm.primitives import queue_traversal_steps
from repro_torch.comm.stack import PhaseStack, as_stack
from repro_torch.device import resolve_device

__all__ = ["PhaseResult", "SequenceResult", "simulate", "simulate_phase",
           "simulate_many", "simulate_sequence", "queue_traversal_steps"]


@dataclasses.dataclass
class PhaseResult:
    time: float                      # modeled wall time of the phase (seconds)
    transport: float                 # max over procs of send-side transport
    queue: float                     # gamma * steps, worst process
    contention: float                # delta * hottest-link bytes
    per_proc_transport: torch.Tensor
    per_proc_queue_steps: torch.Tensor
    max_link_bytes: float
    total_net_bytes: float


def _one(order):
    """A per-phase order spec as the one-entry list of a one-phase stack."""
    return None if order is None else [order]


def simulate(phase: CommPhase,
             recv_post_order: dict[int, np.ndarray] | None = None,
             arrival_order: dict[int, np.ndarray] | None = None,
             rng: np.random.Generator | None = None,
             noise: float = 0.0, device=None) -> PhaseResult:
    """Simulate one prebuilt :class:`CommPhase` on ``device`` (``None`` =
    CUDA), as a one-phase stack.

    ``recv_post_order[p]`` / ``arrival_order[p]``: permutations of the indices
    (into src/dst/size) of messages destined to process ``p``, giving the
    order receives are posted and envelopes arrive.  Default: array order for
    both (best case, O(n) queue cost).

    ``noise`` multiplies the total by a lognormal factor drawn from ``rng``.
    The generator is owned by the *sweep*: create it once (e.g.
    ``np.random.default_rng(seed)``) and thread it through every call, as
    :func:`simulate_many` and the ping-pong harnesses do.  An empty phase
    returns zeros and draws no noise.
    """
    if noise > 0.0 and rng is None:
        raise ValueError(
            "noise > 0 needs an explicit rng, created once at the sweep "
            "level (a per-call default would redraw the same noise); "
            "simulate_many seeds np.random.default_rng(0) for you")
    dev = resolve_device(device)
    if phase.n_msgs == 0:
        return PhaseResult(0.0, 0.0, 0.0, 0.0,
                           torch.zeros(0, dtype=torch.float32, device=dev),
                           torch.zeros(0, dtype=torch.int64, device=dev),
                           0.0, 0.0)
    res = _simulate_stack(PhaseStack.build([phase], device=dev),
                          _one(recv_post_order), _one(arrival_order))[0]
    if noise > 0.0:
        res.time *= float(np.exp(rng.normal(0.0, noise)))
    return res


@dataclasses.dataclass
class SequenceResult:
    """Summed result of a multi-phase sequence (a strategy rewrite): the
    phases execute back-to-back, so times add; per-phase results are kept
    for breakdown tables."""
    time: float
    transport: float
    queue: float
    contention: float
    phases: list[PhaseResult]


def simulate_sequence(phases, recv_post_orders=None, arrival_orders=None,
                      rng: np.random.Generator | None = None,
                      noise: float = 0.0, device=None) -> SequenceResult:
    """Simulate a phase *sequence* end-to-end (e.g. the gather -> inter ->
    scatter steps of a strategy rewrite) in one stack on ``device``
    (``None`` = CUDA) and sum the step times."""
    results = simulate_many(phases, recv_post_orders=recv_post_orders,
                            arrival_orders=arrival_orders, rng=rng,
                            noise=noise, device=device)
    return SequenceResult(
        time=sum(r.time for r in results),
        transport=sum(r.transport for r in results),
        queue=sum(r.queue for r in results),
        contention=sum(r.contention for r in results),
        phases=results)


def simulate_phase(machine, src, dst, size,
                   recv_post_order: dict[int, np.ndarray] | None = None,
                   arrival_order: dict[int, np.ndarray] | None = None,
                   rng: np.random.Generator | None = None,
                   noise: float = 0.0, validate: bool = False,
                   device=None) -> PhaseResult:
    """Simulate one phase of point-to-point messages (array-level entry) on
    ``device`` (``None`` = CUDA).

    ``validate=True`` runs the typed validation layer over the message
    arrays first (:func:`repro_torch.comm.guard.validate_messages` via
    :meth:`CommPhase.build`): NaN/negative sizes and out-of-range ranks
    raise a precise ``PatternError`` subclass instead of simulating
    garbage.
    """
    return simulate(CommPhase.build(machine, src, dst, size,
                                    validate=validate),
                    recv_post_order=recv_post_order,
                    arrival_order=arrival_order, rng=rng, noise=noise,
                    device=device)


def _simulate_stack(stack: PhaseStack, recv_post_orders,
                    arrival_orders) -> list[PhaseResult]:
    """Price a stacked sweep's raw aggregates into PhaseResult rows (float
    aggregates float32-allclose to the reference, queue steps bit-equal)."""
    params = stack.machine.params
    raw = stack.sim_arrays(recv_post_orders=recv_post_orders,
                           arrival_orders=arrival_orders)
    qmax = torch.stack([q.amax() if q.numel() else q.new_zeros(())
                        for q in raw.qsteps]).tolist()
    floats = torch.stack([raw.transport, raw.max_link,
                          raw.net_bytes]).double().T.tolist()
    out = []
    for ph, q, (transport, max_link, net_bytes), per_proc, qsteps in zip(
            stack.phases, qmax, floats, raw.per_proc, raw.qsteps):
        if ph.n_msgs == 0:
            out.append(PhaseResult(0.0, 0.0, 0.0, 0.0, per_proc, qsteps,
                                   0.0, 0.0))
            continue
        queue = params.gamma * float(q)
        contention = params.delta * max_link
        out.append(PhaseResult(
            transport + queue + contention, transport, queue, contention,
            per_proc, qsteps, max_link, net_bytes))
    return out


def simulate_many(phases, recv_post_orders=None, arrival_orders=None,
                  rng: np.random.Generator | None = None, noise: float = 0.0,
                  device=None) -> list[PhaseResult]:
    """Simulate a sweep of bound phases (an AMG hierarchy, a strategy
    candidate set) in one call.

    ``phases`` is a sequence of bound phases on one machine, stacked on
    ``device`` (``None`` = CUDA), or an already-built arena (a
    :class:`~repro_torch.comm.stack.PhaseStack`, or a
    :class:`~repro_torch.comm.delta.DeltaStack` serving transport and
    contention from its caches).  ``recv_post_orders[i]`` /
    ``arrival_orders[i]`` apply to phase ``i``.  ``noise`` multiplies each
    non-empty phase's time by a lognormal factor from one shared numpy
    ``rng`` (default ``np.random.default_rng(0)``, created once per call).
    """
    if noise > 0.0 and rng is None:
        rng = np.random.default_rng(0)
    stack = as_stack(phases, device)
    if stack.n_phases == 0:                    # an empty DeltaStack
        return []
    out = _simulate_stack(stack, recv_post_orders, arrival_orders)
    if noise > 0.0:
        for r, ph in zip(out, stack.phases):
            if ph.n_msgs:
                r.time *= float(np.exp(rng.normal(0.0, noise)))
    return out
