"""Machine descriptions: process -> device -> node -> torus-node maps.

Blue Waters: 3-D Gemini torus; each Gemini serves 2 XE nodes; each node has
2 sockets x 8 cores = 16 ppn — the torus unit (Gemini) *contains* nodes.

TPU v5e: 2-D ICI torus of chips, one "process" per chip, 4 chips per host —
the torus unit (chip) is *contained in* the node (host).  ``torus_over_procs``
switches between the two nestings.

Heterogeneous nodes (Lockhart et al. 2022): each node holds
``devices_per_node`` GPUs with ``procs_per_device`` ranks each, and an
inter-node pair can take one of two network paths — staged through host
memory and the host NIC (``host_staged``) or GPU-NIC direct
(``device_direct``).

Port note: the maps are numpy on the host; they run once per
``CommPhase.build``, before anything moves to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.params import (CommParams, blue_waters, frontier,
                                     lassen, tpu_v5e)
from repro_torch.core.topology import TorusTopology


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """One machine: parameter tables plus the process/node/torus geometry.

    Attributes
    ----------
    name: preset name (``blue_waters`` / ``tpu_v5e`` / ``lassen`` / ...).
    params: ground-truth :class:`~repro_torch.core.params.CommParams` rate
        table for the simulator (models may substitute a fitted table).
    torus: torus of torus-units (Geminis / chips / nodes).
    nodes_per_torus_node: nodes sharing one torus unit (Blue Waters: 2 per
        Gemini; 1 elsewhere).
    procs_per_node: processes (MPI ranks) per node.
    sockets_per_node: CPU sockets per node (drives the homogeneous-node
        intra-socket locality split; ignored when devices are present).
    link_bw: per-torus-link bandwidth (bytes/s).
    torus_over_procs: TPU nesting — each proc (chip) is its own torus node.
    cross_node_locality: locality class assigned to cross-node pairs — the
        machine's *default network path*.
    devices_per_node: GPU/GCD devices per node (0 = homogeneous CPU node).
    procs_per_device: ranks sharing one device (hetero machines only; must
        satisfy ``procs_per_node == devices_per_node * procs_per_device``).
    """

    name: str
    params: CommParams
    torus: TorusTopology
    nodes_per_torus_node: int
    procs_per_node: int
    sockets_per_node: int
    link_bw: float
    torus_over_procs: bool = False
    cross_node_locality: int = 2
    devices_per_node: int = 0
    procs_per_device: int = 0

    def __post_init__(self):
        if self.devices_per_node:
            if self.procs_per_device <= 0:
                raise ValueError(
                    "a heterogeneous machine needs procs_per_device >= 1")
            if self.procs_per_node != (self.devices_per_node
                                       * self.procs_per_device):
                raise ValueError(
                    f"procs_per_node ({self.procs_per_node}) must equal "
                    f"devices_per_node * procs_per_device "
                    f"({self.devices_per_node} * {self.procs_per_device})")

    @property
    def procs_per_torus_node(self) -> int:
        if self.torus_over_procs:
            return 1
        return self.nodes_per_torus_node * self.procs_per_node

    @property
    def n_procs(self) -> int:
        return self.torus.size * self.procs_per_torus_node

    # -- maps ---------------------------------------------------------------
    def node_of(self, p) -> np.ndarray:
        """Node hosting process ``p`` (vectorized)."""
        return np.asarray(p) // self.procs_per_node

    def socket_of(self, p) -> np.ndarray:
        """Socket of process ``p`` within its node (vectorized)."""
        p = np.asarray(p)
        per_socket = max(1, self.procs_per_node // self.sockets_per_node)
        return (p % self.procs_per_node) // per_socket

    def device_of(self, p) -> np.ndarray:
        """Global device id hosting process ``p`` (hetero machines only)."""
        if not self.devices_per_node:
            raise ValueError(f"{self.name} has no device endpoints")
        return np.asarray(p) // self.procs_per_device

    def torus_node_of(self, p) -> np.ndarray:
        """Torus unit (Gemini / chip / node) hosting process ``p``."""
        if self.torus_over_procs:
            return np.asarray(p)
        return self.node_of(p) // self.nodes_per_torus_node

    def locality(self, a, b) -> np.ndarray:
        """Locality class index per ``(a, b)`` process pair (vectorized).

        Blue Waters: 0 = intra-socket, 1 = intra-node, 2 = inter-node.
        TPU v5e:     0 = intra-host,  1 = intra-pod ICI (cross-host).
        Hetero (Lassen/Frontier-like): 0 = intra-device, 1 = intra-node
        cross-device, and cross-node pairs take the machine's configured
        network path (``cross_node_locality``); the staged classes only
        appear via explicit overrides in the strategy rewrites.
        """
        a, b = np.asarray(a), np.asarray(b)
        same_node = self.node_of(a) == self.node_of(b)
        if self.devices_per_node:
            same_dev = same_node & (self.device_of(a) == self.device_of(b))
            mid = np.where(same_node, 1, self.cross_node_locality)
            return np.where(same_dev, 0, mid).astype(np.int64)
        if self.sockets_per_node > 1:
            same_socket = same_node & (self.socket_of(a) == self.socket_of(b))
            mid = np.where(same_node, 1, self.cross_node_locality)
            return np.where(same_socket, 0, mid).astype(np.int64)
        return np.where(same_node, 0, self.cross_node_locality).astype(np.int64)


def blue_waters_machine(torus_dims: tuple[int, ...] = (4, 4, 4),
                        wrap: bool = False) -> MachineSpec:
    """A ``torus_dims`` partition of Blue Waters' Gemini torus.

    ``wrap=False`` because a job partition inside the full torus does not
    wrap.  Gemini link bandwidth ~9.4 GB/s per direction.
    """
    return MachineSpec(
        name="blue_waters",
        params=blue_waters(),
        torus=TorusTopology(tuple(torus_dims), wrap=wrap),
        nodes_per_torus_node=2,
        procs_per_node=16,
        sockets_per_node=2,
        link_bw=9.4e9,
    )


def tpu_v5e_machine(torus_dims: tuple[int, int] = (16, 16)) -> MachineSpec:
    """One TPU v5e pod: a ``torus_dims`` 2-D ICI torus, 4 chips per host.

    One process per chip; the "node" is the host (4 chips).  Locality 0 =
    intra-host, 1 = intra-pod ICI.
    """
    return MachineSpec(
        name="tpu_v5e",
        params=tpu_v5e(),
        torus=TorusTopology(tuple(torus_dims), wrap=True),
        nodes_per_torus_node=1,
        procs_per_node=4,
        sockets_per_node=1,
        link_bw=50e9,
        torus_over_procs=True,
        cross_node_locality=1,
    )


def lassen_machine(torus_dims: tuple[int, ...] = (2, 2, 2),
                   network_path: str = "device_direct") -> MachineSpec:
    """Lassen-like fat GPU nodes on a ``torus_dims`` node torus.

    4 V100-class devices per node, 2 ranks per device (8 ppn), dual-rail
    host NICs.  ``network_path`` picks the class cross-node pairs are born
    with — ``"device_direct"`` or ``"host_staged"``; the GPU-aware strategy
    rewrites compare the two regardless.
    """
    params = lassen()
    return MachineSpec(
        name="lassen",
        params=params,
        torus=TorusTopology(tuple(torus_dims), wrap=False),
        nodes_per_torus_node=1,
        procs_per_node=8,
        sockets_per_node=2,
        link_bw=12.5e9,
        cross_node_locality=params.class_index(network_path),
        devices_per_node=4,
        procs_per_device=2,
    )


def frontier_machine(torus_dims: tuple[int, ...] = (2, 2, 2),
                     network_path: str = "device_direct") -> MachineSpec:
    """Frontier-like 8-GCD nodes on a ``torus_dims`` node torus.

    8 GCDs per node, 1 rank per GCD (8 ppn), 4 Slingshot NICs per node
    attached GPU-side — the device-direct path is native and fast here.
    ``network_path`` as in :func:`lassen_machine`.
    """
    params = frontier()
    return MachineSpec(
        name="frontier",
        params=params,
        torus=TorusTopology(tuple(torus_dims), wrap=False),
        nodes_per_torus_node=1,
        procs_per_node=8,
        sockets_per_node=1,
        link_bw=25e9,
        cross_node_locality=params.class_index(network_path),
        devices_per_node=8,
        procs_per_device=1,
    )
