"""PhaseStack: one ragged arena for a whole sweep of CommPhases, priced on a
torch device.

A :class:`PhaseStack` concatenates N bound
:class:`~repro_torch.comm.phase.CommPhase` objects (all bound to the *same*
machine) into flat per-message columns plus ``phase_id`` / ``offsets``, and
evaluates every sweep quantity in one segmented pass:

* per-(phase, process) transport sums over a packed ``phase * proc_span +
  proc`` key — one launch of kernel K1;
* per-(phase, receiver) receive-queue traversal steps — one launch of
  kernel K2 over every custom receiver of every phase;
* link contention — one phase-tagged routing expansion on the device,
  ``torch.unique`` over packed ``(phase, link, source)`` keys, then K1 for
  the per-source bytes and again for each link's sum and maximum together.

Port note: the concatenation, the packed host keys and the receive-order
assembly are host numpy; each per-message column moves to the stack's
device once, on first use (float64 -> float32, int64 -> int32, raising on a
key outside int32), and every pricing pass runs there.  Float aggregates
are float32-allclose to the float64 reference; queue steps are integer work
and bit-equal.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import comm_stack as ks

from . import faults
from .guard import ArenaOverflowError
from .phase import CommPhase
from .primitives import (active_senders_per_node, flat_orders,
                         group_by_receiver, grouped_queue_steps,
                         transport_times)

__all__ = ["PhaseStack", "StackSimArrays", "as_stack", "put_column"]


def as_stack(phases, device=None):
    """The arena for a sweep: an already-built arena (a :class:`PhaseStack`
    or a :class:`~repro_torch.comm.delta.DeltaStack`) passes through (its
    own device rules), anything else is stacked on ``device`` (``None`` =
    CUDA)."""
    from .delta import ARENA_TYPES          # delta imports this module
    if isinstance(phases, ARENA_TYPES):
        return phases
    return PhaseStack.build(phases, device=device)


def put_column(a, what: str, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: float64 as float32, int64 as int32
    (raising :class:`~repro_torch.comm.guard.ArenaOverflowError` when a
    value lies outside int32).  It is the fault site ``stack.device_store``
    on either device: an armed raise fires first, and the shipped column
    passes :func:`~repro_torch.kernels.comm_stack.verified` against the
    cast host array (``parity``: bit-equal, a copy is exact), so a poisoned
    column raises before any caller can cache it."""
    faults.fail_point("stack.device_store")
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        if a.size and (a.max() > 2 ** 31 - 1 or a.min() < -2 ** 31):
            raise ArenaOverflowError(
                f"arena column {what!r} exceeds int32 range; split the "
                "sweep into smaller stacks")
        a = a.astype(np.int32)
    host = torch.from_numpy(np.ascontiguousarray(a))
    return ks.verified("stack.device_store", host.to(device), lambda: host,
                       exact=True)


#: Per-message arrays concatenated into the arena, in CommPhase field order.
_ARENA_FIELDS = ("src", "dst", "size", "loc", "proto", "is_net", "send_node",
                 "torus_src", "torus_dst", "active_ppn")


@dataclasses.dataclass(frozen=True)
class StackSimArrays:
    """Raw per-phase simulator aggregates, as tensors on the stack's device
    (priced by :mod:`repro_torch.net.simulator`)."""

    transport: torch.Tensor          # [N] max over procs of send-side sums
    per_proc: list[torch.Tensor]     # per-phase send-side transport sums
    qsteps: list[torch.Tensor]       # per-phase queue traversal steps
    max_link: torch.Tensor           # [N] hottest contended-link bytes
    net_bytes: torch.Tensor          # [N] total network bytes


@dataclasses.dataclass(frozen=True, eq=False)
class PhaseStack:
    """N CommPhases concatenated into one ragged arena (same machine)."""

    machine: Any                     # shared MachineSpec (duck-typed)
    phases: tuple[CommPhase, ...]
    device: torch.device
    offsets: np.ndarray              # [N+1] message offsets into the arena
    n_procs: np.ndarray              # [N] per-phase process counts
    src: np.ndarray                  # [total] — concatenated CommPhase arrays
    dst: np.ndarray
    size: np.ndarray
    loc: np.ndarray
    proto: np.ndarray
    is_net: np.ndarray
    send_node: np.ndarray
    torus_src: np.ndarray
    torus_dst: np.ndarray
    active_ppn: np.ndarray
    phase_id: np.ndarray             # [total] owning phase of each message

    @classmethod
    def build(cls, phases, device=None) -> "PhaseStack":
        """Concatenate bound phases into one arena priced on ``device``
        (``None`` = CUDA; raises when no CUDA device exists).

        Every phase must be bound to the *same* machine object: the arena
        caches machine-derived arrays, and mixing machines would silently
        price messages with the wrong parameter tables.
        """
        device = resolve_device(device)
        phases = tuple(phases)
        if not phases:
            raise ValueError("a PhaseStack needs at least one phase")
        for ph in phases:
            if not isinstance(ph, CommPhase):
                raise TypeError(f"PhaseStack stacks bound CommPhases, got "
                                f"{type(ph).__name__}")
        machine = phases[0].machine
        if any(ph.machine is not machine for ph in phases):
            raise ValueError(
                "mixed machines: every phase in a PhaseStack must be bound "
                "to the same machine object")
        counts = np.asarray([ph.n_msgs for ph in phases], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        cat = {f: np.concatenate([getattr(ph, f) for ph in phases])
               for f in _ARENA_FIELDS}
        return cls(
            machine=machine, phases=phases, device=device, offsets=offsets,
            n_procs=np.asarray([ph.n_procs for ph in phases], dtype=np.int64),
            phase_id=np.repeat(np.arange(len(phases), dtype=np.int64), counts),
            **cat)

    # -- basic stats --------------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self.phases)

    @property
    def total_msgs(self) -> int:
        return int(self.offsets[-1])

    # cached_property writes straight to __dict__, bypassing the frozen
    # dataclass __setattr__ — all of these are derived state, computed once
    # per stack and reused by every pass over it.
    @functools.cached_property
    def proc_span(self) -> int:
        """Column span of the dense per-(phase, process) layouts."""
        return int(max(self.n_procs.max(initial=0),
                       self.src.max(initial=-1) + 1,
                       self.dst.max(initial=-1) + 1, 1))

    @functools.cached_property
    def _src_key(self) -> np.ndarray:
        """Packed (phase, sender) key of every message (host)."""
        return self.phase_id * self.proc_span + self.src

    @functools.cached_property
    def _dst_key(self) -> np.ndarray:
        """Packed (phase, receiver) key of every message (host)."""
        return self.phase_id * self.proc_span + self.dst

    @functools.cached_property
    def _receiver_groups(self) -> tuple[np.ndarray, np.ndarray]:
        """Stable grouping of messages by packed (phase, receiver) slot."""
        return group_by_receiver(self._dst_key,
                                 self.n_phases * self.proc_span)

    # -- device columns -----------------------------------------------------
    @functools.cached_property
    def _device_store(self) -> dict:
        return {}

    def _put(self, a: np.ndarray, what: str) -> torch.Tensor:
        """A host array on the stack's device (:func:`put_column`)."""
        return put_column(a, what, self.device)

    def _dev(self, name: str) -> torch.Tensor:
        """The named per-message column, moved to the device once."""
        store = self._device_store
        if name not in store:
            store[name] = self._put(getattr(self, name), name)
        return store[name]

    # -- segmented reductions -----------------------------------------------
    def _phase_proc_sums(self, values: torch.Tensor) -> torch.Tensor:
        """Dense [n_phases, proc_span] sums of per-message ``values`` by
        sending (phase, process) — K1's sums."""
        n = self.n_phases * self.proc_span
        sums, _ = ks.segment_reduce(values, self._dev("_src_key"), n)
        return sums.view(self.n_phases, self.proc_span)

    def masked_phase_sums(self, values: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        """Per-phase sums of ``values`` where ``mask`` holds ([n_phases]
        float32), in one segmented K1 pass."""
        picked = torch.where(mask, values, torch.zeros_like(values))
        sums, _ = ks.segment_reduce(picked, self._dev("phase_id"),
                                    self.n_phases)
        return sums

    @functools.cached_property
    def _recv_counts(self) -> torch.Tensor:
        """Dense [n_phases, proc_span] receive counts (int64)."""
        return torch.bincount(
            self._dev("_dst_key").long(),
            minlength=self.n_phases * self.proc_span).view(
            self.n_phases, self.proc_span)

    @functools.cached_property
    def _net_bytes(self) -> torch.Tensor:
        """Per-phase network bytes under the machine's own locality tables."""
        return self.masked_phase_sums(self._dev("size"), self._dev("is_net"))

    # -- transport pricing --------------------------------------------------
    @functools.cached_property
    def _ladder_cache(self) -> dict:
        """Dense transport matrices per (node_aware, use_maxrate) flag pair
        under the machine's own table — the node-aware entry is also the
        simulator's transport pass (identical inputs)."""
        return {}

    def _active_ppn_for(self, params) -> np.ndarray:
        """Cached active-sender counts, or a stacked host recompute when a
        params table reclassifies localities."""
        if params.network_locality == self.machine.params.network_locality:
            return self.active_ppn
        node_span = int(self.send_node.max(initial=-1)) + 1
        return active_senders_per_node(
            self.src, self.phase_id * node_span + self.send_node,
            self.loc >= params.network_locality)

    def _transport(self, p, node_aware: bool,
                   use_maxrate: bool) -> torch.Tensor:
        """Dense [n_phases, proc_span] send-side transport sums for one
        ladder rung, priced on the device (memoized for the machine's own
        table)."""
        own = p is self.machine.params
        flags = (node_aware, use_maxrate)
        if own and flags in self._ladder_cache:
            return self._ladder_cache[flags]
        dev = self.device
        proto = (self._dev("proto") if own
                 else self._put(p.protocol_of(self.size), "proto")).long()
        at, rb, rn = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                      for t in (p.alpha, p.Rb, p.RN))
        if node_aware:
            loc = self._dev("loc").long()
            alpha, Rb, RN = at[loc, proto], rb[loc, proto], rn[loc, proto]
            same_net = (p.network_locality
                        == self.machine.params.network_locality)
            is_net = (self._dev("is_net") if same_net
                      else loc >= p.network_locality)
        else:
            # every message priced with the network class's row
            nl = p.network_locality
            alpha, Rb, RN = at[nl][proto], rb[nl][proto], rn[nl][proto]
            is_net = torch.ones(self.total_msgs, dtype=torch.bool,
                                device=dev)
        size = self._dev("size")
        if use_maxrate:
            ppn = (self._dev("active_ppn") if p.network_locality
                   == self.machine.params.network_locality
                   else self._put(self._active_ppn_for(p), "active_ppn"))
            t_msg = transport_times(size, alpha, Rb, RN, ppn, is_net,
                                    rails=p.n_rails)
        else:
            t_msg = transport_times(size, alpha, Rb, use_maxrate=False)
        dense = self._phase_proc_sums(t_msg)
        if own:
            self._ladder_cache[flags] = dense
        return dense

    # -- model-side aggregates ----------------------------------------------
    def cost_arrays(self, params=None, *, node_aware: bool = True,
                    use_maxrate: bool = True, with_queue: bool = True,
                    with_net_bytes: bool = True):
        """Aggregates behind the model ladder, one segmented pass each.

        Returns ``(transport[N], max_recv[N], net_bytes[N])`` as float32
        tensors on the stack's device: the worst per-process send-side
        transport sum, the worst per-process receive count (0s when
        ``with_queue=False``) and the total network-class bytes (0s when
        ``with_net_bytes=False``) of every phase.  ``params`` substitutes
        another table (a fitted one) for the machine's own;
        ``node_aware`` / ``use_maxrate`` select the ladder rung's transport
        formula.
        """
        N = self.n_phases
        zeros = torch.zeros(N, dtype=torch.float32, device=self.device)
        if self.total_msgs == 0:
            return zeros, zeros.clone(), zeros.clone()
        m = self.machine
        p = params if params is not None else m.params
        transport = self._transport(p, node_aware, use_maxrate).amax(dim=1)
        max_recv = (self._recv_counts.amax(dim=1).to(torch.float32)
                    if with_queue else zeros.clone())
        if not with_net_bytes:
            net_bytes = zeros.clone()
        elif node_aware and p.network_locality == m.params.network_locality:
            net_bytes = self._net_bytes
        elif node_aware:
            net_bytes = self.masked_phase_sums(
                self._dev("size"),
                self._dev("loc") >= p.network_locality)
        else:                                  # every message is network-class
            size = self._dev("size")
            net_bytes = self.masked_phase_sums(
                size, torch.ones_like(size, dtype=torch.bool))
        return transport, max_recv, net_bytes

    # -- receive-queue accounting -------------------------------------------
    def queue_steps_many(self, recv_post_orders=None,
                         arrival_orders=None) -> torch.Tensor:
        """Dense [n_phases, proc_span] exact queue traversal-step totals
        (int64, on the device).

        ``recv_post_orders[i]`` / ``arrival_orders[i]`` are phase ``i``'s
        per-receiver order specs (dicts or flat ``(slots, lens, ids)`` of
        phase-local indices).  All phases' custom receivers run in ONE
        launch of K2.
        """
        P = self.proc_span
        qsteps = grouped_queue_steps(
            self._dst_key, self.n_phases * P,
            recv_post_order=self._flatten_orders(recv_post_orders),
            arrival_order=self._flatten_orders(arrival_orders),
            groups=self._receiver_groups,
            describe=lambda s: f"receiver {s % P} of phase {s // P}",
            device=self.device)
        return qsteps.view(self.n_phases, P)

    def _flatten_orders(self, per_phase):
        """Merge per-phase order specs into one stack-wide flat spec: slots
        become packed ``(phase, receiver)`` keys, ids become arena indices
        (host numpy)."""
        if per_phase is None:
            return None
        P = self.proc_span
        slot_parts, len_parts, id_parts = [], [], []
        for i, d in enumerate(per_phase):
            flat = flat_orders(d)
            if flat is None:
                continue
            slots, lens, ids = flat
            if slots.size and (slots[0] < 0 or slots[-1] >= P):
                keep = (slots >= 0) & (slots < P)   # mirror per-phase filter
                sel = np.repeat(keep, lens)
                slots, lens, ids = slots[keep], lens[keep], ids[sel]
            slot_parts.append(i * P + slots)
            len_parts.append(lens)
            id_parts.append(ids + self.offsets[i])
        if not slot_parts:
            return None
        return (np.concatenate(slot_parts), np.concatenate(len_parts),
                np.concatenate(id_parts))

    # -- link contention ----------------------------------------------------
    def link_contention_many(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(hottest contended-link bytes, total network bytes) per phase,
        float32 tensors on the device.

        One phase-tagged routing expansion: every inter-torus-unit network
        message of every phase is routed dimension-ordered in a single
        :meth:`~repro_torch.core.topology.TorusTopology.route_link_ids`
        call on the device.  Per ``(phase, link)``, bytes beyond the largest
        single-source contribution count as contention.
        """
        return self._link_contention

    @functools.cached_property
    def _link_contention(self) -> tuple[torch.Tensor, torch.Tensor]:
        net_bytes = self._net_bytes
        N = self.n_phases
        out = torch.zeros(N, dtype=torch.float32, device=self.device)
        tsrc_all, tdst_all = self._dev("torus_src"), self._dev("torus_dst")
        sel = self._dev("is_net") & (tsrc_all != tdst_all)
        if not bool(sel.any()):
            return out, net_bytes
        torus = self.machine.torus
        tsrc = tsrc_all[sel].long()
        midx, link = torus.route_link_ids(tsrc, tdst_all[sel])
        if link.numel() == 0:
            return out, net_bytes
        w = self._dev("size")[sel][midx]
        pid = self._dev("phase_id")[sel].long()[midx]
        # span must cover every source id: on torus_over_procs machines a
        # process id can exceed the torus size
        src_span = max(torus.size, int(tsrc.max()) + 1)
        link_span = torus.link_slots
        if N * link_span * src_span >= 2 ** 62:
            raise ValueError(
                "packed (phase, link, source) key would overflow int64; "
                "split the sweep into smaller stacks")
        key = (pid * link_span + link) * src_span + tsrc[midx]
        uk, inv = torch.unique(key, return_inverse=True)
        per_src, _ = ks.segment_reduce(w, inv.to(torch.int32), uk.numel())
        runs, run_of = torch.unique_consecutive(uk // src_span,
                                                return_inverse=True)
        totals, largest = ks.segment_reduce(per_src, run_of.to(torch.int32),
                                            runs.numel())
        # contended bytes are >= 0, so K1's per-phase maximum (0 for a
        # phase with no routed link) is the reference's maximum over zeros
        _, out = ks.segment_reduce(totals - largest,
                                   (runs // link_span).to(torch.int32), N)
        return out, net_bytes

    # -- simulator-side aggregates ------------------------------------------
    def sim_arrays(self, recv_post_orders=None,
                   arrival_orders=None) -> StackSimArrays:
        """Raw simulator aggregates for the whole stack, one pass each.

        ``recv_post_orders[i]`` / ``arrival_orders[i]`` are phase ``i``'s
        receive-order specs (as in :meth:`queue_steps_many`).  Phases with
        zero messages get empty per-process rows.
        """
        dense = self._transport(self.machine.params, True, True)
        qdense = self.queue_steps_many(recv_post_orders, arrival_orders)
        max_link, net_bytes = self.link_contention_many()
        counts = np.diff(self.offsets)
        per_proc = [dense[i, :self.n_procs[i]] if counts[i] else dense[i, :0]
                    for i in range(self.n_phases)]
        qsteps = [qdense[i, :self.n_procs[i]] if counts[i] else qdense[i, :0]
                  for i in range(self.n_phases)]
        return StackSimArrays(transport=dense.amax(dim=1), per_proc=per_proc,
                              qsteps=qsteps, max_link=max_link,
                              net_bytes=net_bytes)
