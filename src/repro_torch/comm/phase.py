"""CommPhase: one point-to-point communication phase bound to a machine.

The paper evaluates every phase (a set of messages that are all posted, then
all completed — an SpMV halo exchange, one step of a strategy rewrite) twice:
with the closed-form model ladder and with the mechanistic simulator.  Both
need the same derived quantities — per-message locality class, protocol
class, sender node / torus-unit ids, and the number of actively-sending
processes per node.  ``CommPhase`` computes all of them once at
construction.

Port note: a phase is host numpy — binding is host-side construction.  Its
arrays move to the device when phases are concatenated into a
:class:`~repro_torch.comm.stack.PhaseStack`, which is where every pricing
pass runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

from .guard import validate_messages
from .primitives import active_senders_per_node, group_by_receiver


@dataclasses.dataclass(frozen=True, eq=False)
class CommPhase:
    """A message set (src, dst, size) with machine-derived arrays cached."""

    machine: Any                 # MachineSpec (duck-typed)
    src: np.ndarray              # [n_msgs] sending process
    dst: np.ndarray              # [n_msgs] receiving process
    size: np.ndarray             # [n_msgs] bytes
    n_procs: int
    loc: np.ndarray              # [n_msgs] locality class
    proto: np.ndarray            # [n_msgs] protocol class
    is_net: np.ndarray           # [n_msgs] traverses the network
    send_node: np.ndarray        # [n_msgs] sender's node
    torus_src: np.ndarray        # [n_msgs] sender's torus unit
    torus_dst: np.ndarray        # [n_msgs] receiver's torus unit
    active_ppn: np.ndarray       # [n_msgs] active senders on sender's node
    loc_overridden: bool = False  # built with an explicit class override

    @classmethod
    def build(cls, machine, src, dst, size, n_procs: int | None = None,
              loc=None, validate: bool = False) -> "CommPhase":
        """Bind a message set ``(src, dst, size)`` to ``machine``.

        Computes every derived per-message array (locality, protocol,
        ``is_net``, sender node, torus endpoints, active-senders-per-node)
        once, vectorized.  ``n_procs`` fixes the process count (default: the
        largest endpoint + 1).  ``loc`` overrides the machine's locality
        classification with an explicit class index (scalar or per-message
        array) — how the GPU-aware strategy rewrites mark staged phases
        whose class is a routing decision, not a pair geometry.

        ``validate=True`` runs the typed input-validation layer
        (:func:`repro_torch.comm.guard.validate_messages`) first: NaN /
        negative sizes, out-of-range or non-integral ranks and ranks past
        int32 raise a precise :class:`repro_torch.comm.guard.PatternError`
        subclass before any derived array is computed.
        """
        if validate:
            # the raveled raw inputs: the int64/float64 casts below would
            # silently truncate NaN ranks and mask length mismatches
            validate_messages(np.asarray(src).ravel(),
                              np.asarray(dst).ravel(),
                              np.asarray(size).ravel(), n_procs=n_procs,
                              where="CommPhase.build")
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        size = np.asarray(size, dtype=np.float64).ravel()
        params = machine.params
        overridden = loc is not None
        if loc is None:
            loc = np.asarray(machine.locality(src, dst), dtype=np.int64)
        else:
            loc = np.broadcast_to(np.asarray(loc, dtype=np.int64),
                                  src.shape).copy()
            if loc.size and not (0 <= loc.min()
                                 and loc.max() < params.n_locality):
                raise ValueError(
                    f"loc override out of range for a table with "
                    f"{params.n_locality} locality classes")
        proto = params.protocol_of(size)
        is_net = loc >= params.network_locality
        send_node = np.asarray(machine.node_of(src), dtype=np.int64)
        if n_procs is None:
            n_procs = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
        return cls(
            machine=machine, src=src, dst=dst, size=size, n_procs=int(n_procs),
            loc=loc, proto=proto, is_net=is_net, send_node=send_node,
            torus_src=np.asarray(machine.torus_node_of(src), dtype=np.int64),
            torus_dst=np.asarray(machine.torus_node_of(dst), dtype=np.int64),
            active_ppn=active_senders_per_node(src, send_node, is_net),
            loc_overridden=overridden,
        )

    # -- basic stats --------------------------------------------------------
    @property
    def n_msgs(self) -> int:
        return int(self.src.size)

    @property
    def total_bytes(self) -> float:
        return float(self.size.sum())

    @property
    def net_bytes(self) -> float:
        return float(self.size[self.is_net].sum())

    def recv_counts(self) -> np.ndarray:
        """Messages received per process (``[n_procs]`` counts)."""
        return np.bincount(self.dst, minlength=self.n_procs)

    def max_msgs_per_proc(self) -> int:
        """Worst per-process receive count (the queue model's ``n``)."""
        if self.n_msgs == 0:
            return 0
        return int(self.recv_counts().max())

    def class_bytes(self) -> np.ndarray:
        """Payload bytes per locality class (``[n_locality]``): how much
        traffic rides each rate-table row."""
        return np.bincount(self.loc, weights=self.size,
                           minlength=self.machine.params.n_locality)

    # -- receive-queue accounting -------------------------------------------
    @functools.cached_property
    def _receiver_groups(self) -> tuple[np.ndarray, np.ndarray]:
        # cached_property writes straight to __dict__, bypassing the frozen
        # dataclass __setattr__ — the grouping is derived state like the rest
        return group_by_receiver(self.dst, self.n_procs)

    def receiver_groups(self) -> tuple[np.ndarray, np.ndarray]:
        """(order, bounds): message indices grouped by receiving process."""
        return self._receiver_groups

    def queue_steps(self, recv_post_order=None, arrival_order=None,
                    device=None) -> torch.Tensor:
        """Exact per-process receive-queue traversal-step totals (int64
        ``[n_procs]`` on ``device``, ``None`` = CUDA).

        ``recv_post_order[p]`` / ``arrival_order[p]``: permutations of the
        message indices destined to ``p``, giving the order receives are
        posted and envelopes arrive (dicts, or the flat form of
        :func:`repro_torch.comm.primitives.flat_orders`).  Default is array
        order for both (one step per arrival); receivers with a custom
        order pay the exact walk, all of them in one launch of K2 through
        a one-phase :class:`~repro_torch.comm.stack.PhaseStack`.
        """
        from .stack import PhaseStack
        if self.n_msgs == 0:
            return torch.zeros(self.n_procs, dtype=torch.int64,
                               device=resolve_device(device))
        wrap = (lambda o: None if o is None else [o])
        steps = PhaseStack.build([self], device=device).queue_steps_many(
            wrap(recv_post_order), wrap(arrival_order))
        return steps[0, :self.n_procs]

    def random_arrival_flat(self, rng: np.random.Generator
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Random envelope-arrival permutations in the flat ``(slots, lens,
        ids)`` form of :func:`repro_torch.comm.primitives.flat_orders` (the
        paper's Sec.-5 irregular regime).

        One shuffle for the whole phase: iid uniform keys per message from
        ``rng`` (a numpy generator, so the stream is the reference's), one
        lexsort by (receiver, key) — a uniform random permutation within
        every receiver segment.
        """
        z = np.zeros(0, dtype=np.int64)
        if self.n_msgs == 0:
            return z, z.copy(), z.copy()
        keys = rng.random(self.n_msgs)
        perm = np.lexsort((keys, self.dst))       # grouped by receiver,
        dst_sorted = self.dst[perm]               # random within each group
        starts = np.nonzero(np.r_[True, dst_sorted[1:] != dst_sorted[:-1]])[0]
        lens = np.diff(np.r_[starts, dst_sorted.size])
        return dst_sorted[starts], lens, perm

    def random_arrival_order(self, rng: np.random.Generator
                             ) -> dict[int, np.ndarray]:
        """Dict view of :meth:`random_arrival_flat` (receiver ->
        permutation), drawn from the same ``rng`` stream."""
        slots, lens, perm = self.random_arrival_flat(rng)
        return {int(s): ids
                for s, ids in zip(slots, np.split(perm, np.cumsum(lens)[:-1]))}

    # -- link contention ----------------------------------------------------
    def link_contention(self, device=None) -> tuple[float, float]:
        """(hottest contended-link bytes, total network bytes), routed and
        reduced on ``device`` (``None`` = CUDA) through a one-phase
        :class:`~repro_torch.comm.stack.PhaseStack`.

        Only bytes beyond the largest single-source contribution on a link
        count as contention (multiple units funneling into it, as in the
        paper's Fig. 6).
        """
        from .stack import PhaseStack
        max_link, net = PhaseStack.build([self], device=device
                                         ).link_contention_many()
        return float(max_link[0]), float(net[0])
