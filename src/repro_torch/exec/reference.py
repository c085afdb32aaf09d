"""Serial numpy reference executor: the bit-identity oracle for lowered
schedules, and the delivered-payload digest through K1.

Two independent answers for "what payload does each rank end up holding":

* :func:`reference_delivered` — the *semantic* oracle.  It ignores the
  schedule's routing entirely and places every unit's payload directly at
  its destination: the answer any correct exchange must produce.
* :func:`run_reference` — the *operational* oracle.  It walks the
  schedule's phases and rounds serially with plain Python loops, consuming
  the same ``pack`` / ``stage`` / ``final`` index tables the virtual-rank
  executor (:mod:`repro_torch.exec.lower`) runs on the device — so a
  schedule bug (mis-colored round, wrong table entry) makes *both*
  executors disagree with :func:`reference_delivered`, while a transport
  bug makes the device path disagree with this one.

Payloads are int32 and accumulation is addition of disjoint contributions,
so equality is exact (``==``), never approximate.

Port note: both oracles are the reference's numpy, unchanged.  The digest
(:func:`delivered_digest`) reduces through K1 in float32, where the
reference's numpy digest is float64 and exact: payloads reach 2^31 and
float32 sums are not associative, so the port's digest holds to
``np.bincount(unit_dst, payload)`` within rtol 1e-4, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import comm_stack as ks

from .plan import ExecSchedule


def reference_delivered(schedule: ExecSchedule) -> np.ndarray:
    """The semantic delivery oracle for ``schedule``: an ``(n_procs,
    n_units)`` int32 matrix with every unit's payload placed directly at its
    destination rank, no routing involved."""
    out = np.zeros((schedule.n_procs, schedule.n_units), dtype=np.int32)
    out[schedule.unit_dst, np.arange(schedule.n_units)] = schedule.payload
    return out


def run_reference(schedule: ExecSchedule) -> np.ndarray:
    """Execute ``schedule`` serially in numpy and return the delivered
    ``(n_procs, n_units)`` matrix.

    Walks every phase's rounds in order; for each ``(sender, receiver)``
    pair of a round's permutation the sender's ``pack`` row is read from its
    holding buffer and scattered through the receiver's ``stage`` /
    ``final`` rows — the dataflow the device executor runs as one gather
    and two scatter-adds per round.  The padded sink column is carried,
    zeroed after every round and trimmed, as the device path does.
    """
    P, U = schedule.n_procs, schedule.n_units
    hold = np.zeros((P, U + 1), dtype=np.int32)
    deliv = np.zeros((P, U + 1), dtype=np.int32)
    units = np.arange(U)
    hold[schedule.unit_src, units] = schedule.payload
    at_home = schedule.unit_src == schedule.unit_dst
    deliv[schedule.unit_dst[at_home], units[at_home]] = \
        schedule.payload[at_home]

    for phase in schedule.phases:
        for rnd in phase.rounds:
            arrivals = []                       # snapshot: sends are posted
            for s, d in rnd.perm:               # before any receive lands
                arrivals.append((d, hold[s, rnd.pack[s]]))
            for d, recv in arrivals:
                np.add.at(hold[d], rnd.stage[d], recv)
                np.add.at(deliv[d], rnd.final[d], recv)
            hold[:, U] = 0                      # discard sink junk
            deliv[:, U] = 0
    return deliv[:, :U]


def delivered_digest(delivered, schedule: ExecSchedule,
                     device=None) -> torch.Tensor:
    """Per-rank delivered-payload totals of a ``delivered`` matrix: each
    unit's word at its destination, cast to float32 and summed by
    ``unit_dst`` through K1 (:func:`repro_torch.kernels.comm_stack.
    segment_reduce`), as a float32 ``[n_procs]`` tensor.

    A tensor ``delivered`` stays on its own device; a numpy one goes to
    ``device`` (``None`` = CUDA).  On the card this is one K1 launch, on
    the CPU K1's plain version.  For a correct execution of ``schedule``
    it equals ``np.bincount(unit_dst, payload)`` within rtol 1e-4 (float32
    sums of words up to 2^31).
    """
    if isinstance(delivered, torch.Tensor):
        dev = delivered.device
    else:
        dev = resolve_device(device)
        delivered = torch.as_tensor(np.asarray(delivered), device=dev)
    P, U = schedule.n_procs, schedule.n_units
    if tuple(delivered.shape) != (P, U):
        raise ValueError(f"delivered has shape {tuple(delivered.shape)}, "
                         f"the schedule delivers ({P}, {U})")
    dst = torch.as_tensor(schedule.unit_dst, device=dev)
    values = delivered[dst, torch.arange(U, device=dev)]
    sums, _ = ks.segment_reduce(values.to(torch.float32).contiguous(),
                                dst.to(torch.int32).contiguous(), P)
    return sums
