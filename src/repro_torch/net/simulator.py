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

Port note: only the stack path exists — a sweep is one
:class:`~repro_torch.comm.stack.PhaseStack` priced on its device, with the
exact queue walk in kernel K2 and the reductions in kernel K1.  The
optional noise stream stays a numpy generator, drawn on the host in the
reference's order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.stack import PhaseStack, as_stack

__all__ = ["PhaseResult", "simulate_many"]


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
    ``device`` (``None`` = CUDA), or an already-built
    :class:`~repro_torch.comm.stack.PhaseStack`.  ``recv_post_orders[i]`` /
    ``arrival_orders[i]`` apply to phase ``i``.  ``noise`` multiplies each
    non-empty phase's time by a lognormal factor from one shared numpy
    ``rng`` (default ``np.random.default_rng(0)``, created once per call).
    """
    if noise > 0.0 and rng is None:
        rng = np.random.default_rng(0)
    stack = as_stack(phases, device)
    out = _simulate_stack(stack, recv_post_orders, arrival_orders)
    if noise > 0.0:
        for r, ph in zip(out, stack.phases):
            if ph.n_msgs:
                r.time *= float(np.exp(rng.normal(0.0, noise)))
    return out
