"""Host-scale machine presets: the four shipped machines shrunk to 8 ranks.

The stock presets put 8+ ranks on every node, so an 8-rank exchange (the
reference's forced 8-device host mesh, or 8 virtual ranks on one card)
would never cross a node boundary and every strategy would degenerate to
the identity.
These variants keep each preset's *rate tables* (the ground-truth
``CommParams``) and relative geometry — two nodes, device structure where
the original has one — but shrink ``procs_per_node`` to 4 so 8 ranks span
2 nodes and every strategy rewrite produces real gather/inter/scatter
traffic the executors can run end-to-end.
"""
from __future__ import annotations

from repro_torch.core.params import blue_waters, frontier, lassen, tpu_v5e
from repro_torch.core.topology import TorusTopology
from repro_torch.net.machine import MachineSpec

#: Ranks every host-scale preset spans (the reference's forced host-mesh
#: device count).
HOST_PROCS = 8


def blue_waters_8() -> MachineSpec:
    """Blue Waters at host scale: 2 nodes x 4 ranks on a 2-Gemini line,
    2 sockets per node, stock :func:`repro_torch.core.params.blue_waters`
    rates."""
    return MachineSpec(
        name="blue_waters_8",
        params=blue_waters(),
        torus=TorusTopology((2, 1, 1), wrap=False),
        nodes_per_torus_node=1,
        procs_per_node=4,
        sockets_per_node=2,
        link_bw=9.4e9,
    )


def tpu_v5e_8() -> MachineSpec:
    """TPU v5e at host scale: 8 chips (2 hosts x 4 chips) on a wrapped
    4x2 ICI torus, stock :func:`repro_torch.core.params.tpu_v5e` rates."""
    return MachineSpec(
        name="tpu_v5e_8",
        params=tpu_v5e(),
        torus=TorusTopology((4, 2), wrap=True),
        nodes_per_torus_node=1,
        procs_per_node=4,
        sockets_per_node=1,
        link_bw=50e9,
        torus_over_procs=True,
        cross_node_locality=1,
    )


def lassen_8(network_path: str = "device_direct") -> MachineSpec:
    """Lassen at host scale: 2 nodes x (2 devices x 2 ranks), dual-rail
    stock :func:`repro_torch.core.params.lassen` rates; ``network_path`` picks
    the cross-node class exactly as in
    :func:`repro_torch.net.machine.lassen_machine`."""
    params = lassen()
    return MachineSpec(
        name="lassen_8",
        params=params,
        torus=TorusTopology((2, 1, 1), wrap=False),
        nodes_per_torus_node=1,
        procs_per_node=4,
        sockets_per_node=2,
        link_bw=12.5e9,
        cross_node_locality=params.class_index(network_path),
        devices_per_node=2,
        procs_per_device=2,
    )


def frontier_8(network_path: str = "device_direct") -> MachineSpec:
    """Frontier at host scale: 2 nodes x (4 GCDs x 1 rank), stock
    :func:`repro_torch.core.params.frontier` rates; ``network_path`` as in
    :func:`repro_torch.net.machine.frontier_machine`."""
    params = frontier()
    return MachineSpec(
        name="frontier_8",
        params=params,
        torus=TorusTopology((2, 1, 1), wrap=False),
        nodes_per_torus_node=1,
        procs_per_node=4,
        sockets_per_node=1,
        link_bw=25e9,
        cross_node_locality=params.class_index(network_path),
        devices_per_node=4,
        procs_per_device=1,
    )


def host_machines() -> dict[str, MachineSpec]:
    """All four host-scale presets, name -> fresh
    :class:`~repro_torch.net.machine.MachineSpec` instance."""
    return {m.name: m for m in (blue_waters_8(), tpu_v5e_8(),
                                lassen_8(), frontier_8())}
