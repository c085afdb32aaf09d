"""Run an :class:`~repro_torch.exec.plan.ExecSchedule` as virtual ranks on
one device.

The reference lowers a schedule to one jitted ``shard_map`` over a rank
mesh, each simulated MPI rank on its own device, each round one static
``ppermute``.  Here every simulated rank is a **row** of one device tensor:
the holding and delivered buffers are ``(n_procs, n_units + 1)`` int32,
flattened, with the sink column last.  A round is three torch operations:

1. gather every sender's ``pack`` slots into one ``[pairs, width]`` tensor
   — the snapshot: every send is read before any receive lands, so a rank
   that sends and receives in one round sends what it held before it;
2. ``index_add_`` the received slots into the holding buffer at ``stage``
   and into the delivered buffer at ``final`` (int64 flat indices:
   ``n_procs * (n_units + 1)`` passes int32 at 8,192 ranks);
3. zero the sink column, where padding and pass-through slots land, so its
   junk never grows.

Each round's tables are uploaded once, when the executor is built, and only
the rows of the round's senders and receivers are kept.  Payloads are
int32 and the adds touch disjoint real columns, so the result is
bit-identical to the serial numpy walk of the same tables
(:func:`repro_torch.exec.reference.run_reference`).

With ``mesh=`` (a 1-D ``("rank",)`` device mesh of ``schedule.n_procs``
ranks, :func:`repro_torch.launch.mesh.make_rank_mesh`) the schedule runs
as the reference runs it, one simulated rank a member of the mesh's
group: each rank holds its own rows, and a round is one
:func:`~repro_torch.parallel.collectives.ppermute` of the rank's ``pack``
slots (one message a pair of the round's ``perm``) and the ``stage`` and
``final`` scatter-adds of what it received.

The round step is not a TPU kernel in the reference (``ppermute`` and
``.at[].add``, no Pallas), so it stays torch operations.  The executor
returns the delivered matrix on the device; the reference copies it to the
host, which at 8,192 ranks would move 5.4 GB a run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import all_gather, axis_index, ppermute

from .plan import ExecSchedule
from .reference import delivered_digest


def initial_buffers(schedule: ExecSchedule) -> tuple[np.ndarray, np.ndarray]:
    """The executor's starting ``(hold, deliv)`` int32 buffers for
    ``schedule``, each ``(n_procs, n_units + 1)`` with the sink column last:
    every unit's payload sits in its origin rank's holding row, and units
    already at home (origin == destination) are pre-delivered.  Host numpy,
    as the reference builds them; the device executor scatters the same
    entries into zeroed device buffers instead of copying these."""
    P, U = schedule.n_procs, schedule.n_units
    units = np.arange(U)
    hold = np.zeros((P, U + 1), dtype=np.int32)
    deliv = np.zeros((P, U + 1), dtype=np.int32)
    hold[schedule.unit_src, units] = schedule.payload
    at_home = schedule.unit_src == schedule.unit_dst
    deliv[schedule.unit_dst[at_home], units[at_home]] = \
        schedule.payload[at_home]
    return hold, deliv


def _flat(rows: np.ndarray, table: np.ndarray, width: int) -> np.ndarray:
    """Flat int64 indices of ``table[rows]`` into a ``(·, width)`` buffer."""
    return (rows[:, None] * np.int64(width)
            + table[rows].astype(np.int64)).ravel()


def build_executor(schedule: ExecSchedule, device=None, mesh=None):
    """Upload ``schedule`` to ``device`` (``None`` = CUDA) and return a
    zero-argument callable that runs it and returns the delivered
    ``(n_procs, n_units)`` int32 tensor on the device (sink trimmed).

    The callable builds the starting buffers on the device (zeros, then a
    scatter of ``payload`` at ``(unit_src, u)`` and, for units already at
    home, at ``(unit_dst, u)``) and runs every round; it is what
    :func:`repro_torch.exec.measure.time_schedule` times.

    With ``mesh`` (a 1-D device mesh of ``schedule.n_procs`` ranks; called
    on every rank of it) the callable runs this rank's part and returns
    its own delivered row ``(n_units,)``; see :func:`_rank_executor`.
    Raises ``ValueError`` when the mesh holds another number of ranks.
    """
    dev = resolve_device(device)
    if mesh is not None:
        return _rank_executor(schedule, dev, mesh)
    P, U = schedule.n_procs, schedule.n_units
    W = U + 1
    units = np.arange(U, dtype=np.int64)
    at_home = schedule.unit_src == schedule.unit_dst

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    payload = put(schedule.payload.astype(np.int32))
    hold_at = put(schedule.unit_src * W + units)
    home_at = put(schedule.unit_dst[at_home] * W + units[at_home])
    home_payload = put(schedule.payload[at_home].astype(np.int32))
    rounds = []
    for phase in schedule.phases:
        for rnd in phase.rounds:
            pairs = np.asarray(rnd.perm, dtype=np.int64).reshape(-1, 2)
            senders, receivers = pairs[:, 0], pairs[:, 1]
            rounds.append((put(_flat(senders, rnd.pack, W)),
                           put(_flat(receivers, rnd.stage, W)),
                           put(_flat(receivers, rnd.final, W))))

    def run() -> torch.Tensor:
        hold = torch.zeros(P * W, dtype=torch.int32, device=dev)
        deliv = torch.zeros(P * W, dtype=torch.int32, device=dev)
        hold[hold_at] = payload
        deliv[home_at] = home_payload
        for pack, stage, final in rounds:
            recv = hold[pack]                   # snapshot before any add
            hold.index_add_(0, stage, recv)
            deliv.index_add_(0, final, recv)
            hold.view(P, W)[:, U].zero_()       # discard sink junk (a
            deliv.view(P, W)[:, U].zero_()      # fill: no host copy)
        return deliv.view(P, W)[:, :U]

    return run


def _rank_executor(schedule: ExecSchedule, dev: torch.device, mesh):
    """This rank's executor of ``schedule`` on ``mesh``'s group: its rows
    of the starting buffers and of each round's tables on ``dev``; a run
    starts from copies of its rows, and each round gathers its ``pack``
    slots (the snapshot), moves them with one ``ppermute`` of the round's
    ``perm`` and scatter-adds what arrived at ``stage`` and ``final``.
    The sink column is zeroed after each round, as on one device."""
    if mesh.size() != schedule.n_procs:
        raise ValueError(f"the mesh holds {mesh.size()} ranks, the schedule "
                         f"{schedule.n_procs}")
    group = mesh.get_group()
    r = axis_index(group)
    U = schedule.n_units
    hold0, deliv0 = initial_buffers(schedule)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    hold_row, deliv_row = put(hold0[r]), put(deliv0[r])
    rounds = [(rnd.perm, put(rnd.pack[r].astype(np.int64)),
               put(rnd.stage[r].astype(np.int64)),
               put(rnd.final[r].astype(np.int64)))
              for phase in schedule.phases for rnd in phase.rounds]

    def run() -> torch.Tensor:
        hold, deliv = hold_row.clone(), deliv_row.clone()
        for perm, pack, stage, final in rounds:
            recv = ppermute(hold[pack], perm, group)
            hold.index_add_(0, stage, recv)
            deliv.index_add_(0, final, recv)
            hold[U:].zero_()
            deliv[U:].zero_()
        return deliv[:U]

    return run


def execute(schedule: ExecSchedule, device=None, mesh=None):
    """Run ``schedule`` once on ``device`` (``None`` = CUDA) and return
    ``(delivered, digest)``: the delivered int32 ``(n_procs, n_units)``
    tensor and its per-rank payload totals through K1
    (:func:`repro_torch.exec.reference.delivered_digest`), both on the
    device.  With ``mesh`` (as in :func:`build_executor`; called on every
    rank) each rank runs its part, the rows are all-gathered and every
    rank returns the whole matrix and its digest."""
    delivered = build_executor(schedule, device=device, mesh=mesh)()
    if mesh is not None:
        delivered = all_gather(delivered, mesh.get_group())
    return delivered, delivered_digest(delivered, schedule)
