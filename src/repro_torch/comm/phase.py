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
              loc=None) -> "CommPhase":
        """Bind a message set ``(src, dst, size)`` to ``machine``.

        Computes every derived per-message array (locality, protocol,
        ``is_net``, sender node, torus endpoints, active-senders-per-node)
        once, vectorized.  ``n_procs`` fixes the process count (default: the
        largest endpoint + 1).  ``loc`` overrides the machine's locality
        classification with an explicit class index (scalar or per-message
        array) — how the GPU-aware strategy rewrites mark staged phases
        whose class is a routing decision, not a pair geometry.
        """
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

    # -- receive-queue accounting -------------------------------------------
    @functools.cached_property
    def _receiver_groups(self) -> tuple[np.ndarray, np.ndarray]:
        # cached_property writes straight to __dict__, bypassing the frozen
        # dataclass __setattr__ — the grouping is derived state like the rest
        return group_by_receiver(self.dst, self.n_procs)

    def receiver_groups(self) -> tuple[np.ndarray, np.ndarray]:
        """(order, bounds): message indices grouped by receiving process."""
        return self._receiver_groups

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
