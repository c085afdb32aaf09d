"""Parameter tables for the node-aware max-rate communication model.

The paper (Bienz/Gropp/Olson, EuroMPI'18) splits the classic postal/max-rate
parameters along two axes:

* **protocol** — short / eager / rendezvous, selected by message size;
* **locality** — intra-socket / intra-node(cross-socket) / inter-node.

and adds two scalar penalties:

* ``gamma`` — receive-queue search cost per queue element (T_q = gamma * n^2)
* ``delta`` — per-byte network-link contention penalty (T_c = delta * ell)

``CommParams`` stores these as dense ``[n_locality, n_protocol]`` tables so the
model functions in :mod:`repro_torch.core.models` can vectorize over messages.

The locality axis is an open *rate table*, not a fixed three-class enum: the
heterogeneous-node presets (Lockhart et al. 2022) extend it with device
classes — intra-device, cross-device (NVLink / Infinity Fabric), host<->device
copy (``h2d``), and two *network paths* per inter-node pair (``host_staged``
vs ``device_direct`` GPU-NIC) — plus a per-node NIC/rail count ``n_rails``
that the max-rate mechanism divides active senders across.  Model code never
hard-codes class indices; it indexes the table by the per-message ``loc``
array and resolves named classes via :meth:`CommParams.class_index`.

Port note: the tables stay numpy float64 on the host (they are tiny); the
stack ships them to its device as float32 when it prices an arena.
:meth:`CommParams.from_arrays` rebuilds a table from plain arrays and
scalars — how another implementation's table, a fitted one included,
carries across without importing that implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

INF = float("inf")

# Protocol indices (message-size regimes).
SHORT, EAGER, REND = 0, 1, 2
PROTOCOL_NAMES = ("short", "eager", "rend")

# Default size thresholds (bytes).  Blue Waters' CrayMPI switches
# eager->rendezvous around 8 KiB; "short" rides in the envelope.
DEFAULT_SHORT_MAX = 512
DEFAULT_EAGER_MAX = 8192


@dataclasses.dataclass(frozen=True)
class CommParams:
    """Locality- and protocol-split postal/max-rate parameters.

    Attributes
    ----------
    locality_names: names of locality classes, ordered "closest" first.
    alpha:  [L, P] per-message latency (seconds).
    Rb:     [L, P] per-process transport rate (bytes/second); beta = 1/Rb.
    RN:     [L, P] node injection-bandwidth cap (bytes/second); ``inf`` where
            injection is not a bottleneck (e.g. intra-node traffic).
    gamma:  queue-search cost per element (seconds).
    delta:  per-byte contention penalty on the hottest link (seconds/byte).
    short_max / eager_max: protocol size thresholds in bytes.
    network_locality: index of the first locality class that traverses the
            network (used by contention/injection logic).
    n_rails: NICs (injection rails) per node.  The max-rate mechanism divides
            a node's active senders across its rails — ``ceil(ppn / n_rails)``
            processes contend per NIC — so a multi-rail node saturates ``RN``
            later than a single-NIC node with the same per-rail cap.
    """

    locality_names: tuple[str, ...]
    alpha: np.ndarray
    Rb: np.ndarray
    RN: np.ndarray
    gamma: float
    delta: float
    short_max: int = DEFAULT_SHORT_MAX
    eager_max: int = DEFAULT_EAGER_MAX
    network_locality: int = 2
    n_rails: int = 1

    @property
    def n_locality(self) -> int:
        return len(self.locality_names)

    def protocol_of(self, size) -> np.ndarray:
        """Vectorized protocol classification by message size (bytes)."""
        size = np.asarray(size)
        return np.where(size <= self.short_max, SHORT,
                        np.where(size <= self.eager_max, EAGER, REND)).astype(np.int32)

    def class_index(self, name: str) -> int:
        """Index of locality class ``name`` in this table's rate rows.

        Strategy rewrites that override a phase's class (staged copies, the
        ``host_staged`` network path) resolve indices through this instead of
        hard-coding table positions; a table without the class raises a
        ``ValueError`` naming the classes it does have.
        """
        try:
            return self.locality_names.index(name)
        except ValueError:
            raise ValueError(
                f"{name!r} is not a locality class of this parameter table; "
                f"available classes: {self.locality_names}") from None

    def has_class(self, name: str) -> bool:
        """Whether ``name`` is a locality class of this rate table."""
        return name in self.locality_names

    def replace(self, **kw) -> "CommParams":
        """A copy of this table with the named fields replaced (``kw`` maps
        field name to new value, as :func:`dataclasses.replace`)."""
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_arrays(cls, d) -> "CommParams":
        """A table from a mapping of field name to array or scalar.

        ``d`` holds every field of this dataclass — e.g.
        ``dataclasses.asdict(params)`` of any table with the same fields,
        a fitted one included.  Rate tables become float64 arrays of shape
        ``[n_locality, n_protocol]``; a shape mismatch raises.
        """
        names = tuple(str(n) for n in d["locality_names"])
        tables = {}
        for f in ("alpha", "Rb", "RN"):
            a = np.array(d[f], dtype=np.float64)
            if a.ndim != 2 or a.shape[0] != len(names):
                raise ValueError(
                    f"{f} must be [n_locality={len(names)}, n_protocol], "
                    f"got shape {a.shape}")
            tables[f] = a
        return cls(locality_names=names, **tables,
                   gamma=float(d["gamma"]), delta=float(d["delta"]),
                   short_max=int(d["short_max"]),
                   eager_max=int(d["eager_max"]),
                   network_locality=int(d["network_locality"]),
                   n_rails=int(d["n_rails"]))


def _tbl(rows: Sequence[Sequence[float]]) -> np.ndarray:
    """rows indexed [protocol][locality] -> array [locality, protocol]."""
    return np.asarray(rows, dtype=np.float64).T


def blue_waters() -> CommParams:
    """Table 1 of the paper: node-aware max-rate parameters on Blue Waters.

    Localities: 0=intra-socket, 1=intra-node (cross socket), 2=inter-node.
    """
    alpha = _tbl([
        # intra-socket, intra-node, inter-node
        [4.4e-07, 8.3e-07, 2.3e-06],   # short
        [5.3e-07, 1.2e-06, 7.0e-06],   # eager
        [1.7e-06, 2.5e-06, 3.0e-06],   # rendezvous
    ])
    Rb = _tbl([
        [2.2e09, 4.8e08, 1.3e09],
        [3.2e09, 9.6e08, 7.5e08],
        [6.2e09, 6.2e09, 2.9e09],
    ])
    RN = _tbl([
        [INF, INF, INF],
        [INF, INF, INF],
        [INF, INF, 6.6e09],            # injection limit only for rendezvous
    ])
    return CommParams(
        locality_names=("intra_socket", "intra_node", "inter_node"),
        alpha=alpha, Rb=Rb, RN=RN,
        gamma=8.4e-09,                  # Eq. (4)
        delta=1.0e-10,                  # Eq. (6)
        network_locality=2,
    )


def tpu_v5e() -> CommParams:
    """TPU v5e adaptation of the node-aware parameter table.

    Localities: 0=intra-host (4 chips/tray), 1=intra-pod (ICI torus),
    2=inter-pod (DCN).  These are *design parameters*, not calibrated
    values: they are set from public specs
    (ICI ~50 GB/s/link, 4 links/chip; DCN ~25 GB/s/host) with latency floors
    typical of XLA transfer launch.  The model only needs internally-consistent
    parameters to rank layouts; absolute accuracy comes from fitting
    ping-pong sweeps on the hardware, exactly as the paper does.
    """
    alpha = _tbl([
        # intra-host, intra-pod(ICI), inter-pod(DCN)
        [8.0e-07, 1.0e-06, 1.0e-05],   # small
        [9.0e-07, 1.5e-06, 2.0e-05],   # medium
        [1.2e-06, 2.0e-06, 5.0e-05],   # large
    ])
    Rb = _tbl([
        [2.0e10, 1.0e10, 1.0e09],
        [4.0e10, 3.0e10, 3.0e09],
        [5.0e10, 4.5e10, 6.25e09],
    ])
    # Injection cap: 4 ICI links/chip x ~45 GB/s effective; DCN per-chip share
    # of a 25 GB/s host NIC.
    RN = _tbl([
        [INF, 1.8e11, 2.5e10],
        [INF, 1.8e11, 2.5e10],
        [INF, 1.8e11, 2.5e10],
    ])
    return CommParams(
        locality_names=("intra_host", "intra_pod", "inter_pod"),
        alpha=alpha, Rb=Rb, RN=RN,
        gamma=1.0e-08,                  # per-outstanding-DMA match/dispatch cost
        delta=5.0e-11,                  # ICI link contention penalty
        short_max=DEFAULT_SHORT_MAX,
        eager_max=DEFAULT_EAGER_MAX,
        network_locality=1,             # ICI already traverses torus links
    )


# -- heterogeneous (GPU) nodes ----------------------------------------------
#
# Locality classes of the heterogeneous presets, "closest" first.  The first
# three never traverse the network; ``h2d`` (host<->device copy) is only ever
# assigned by an explicit class override (a copy is a staging decision, not a
# pair geometry), and the two network classes are the two *paths* an
# inter-node pair can take: staged through host memory and the host NIC, or
# GPU-NIC direct (GPUDirect / NIC-per-GCD).  ``MachineSpec.locality``
# classifies cross-node pairs with the machine's configured default path;
# the GPU-aware strategy rewrites pit the two paths against each other.
HETERO_LOCALITIES = ("intra_device", "cross_device", "h2d",
                     "host_staged", "device_direct")
HETERO_NETWORK_LOCALITY = 3        # host_staged and device_direct are net


def lassen() -> CommParams:
    """Lassen-like fat GPU node: 4 V100-class devices, dual-rail host NICs.

    Design parameters in the spirit of Lockhart et al. 2022, not calibrated
    values (absolute values come from fitting ping-pong sweeps on the
    hardware, exactly as the paper does).
    The load-bearing *shape*: the device-direct path has no copy overhead but
    a low rendezvous rate (early GPUDirect RDMA reads), while the host-staged
    path pays h2d copies yet rides the full dual-rail host NIC bandwidth —
    which is what makes the two GPU-aware strategies cross over as traffic
    grows.
    """
    alpha = _tbl([
        # intra_device, cross_device, h2d,   host_staged, device_direct
        [3.0e-06, 4.0e-06, 6.0e-06, 1.5e-06, 2.5e-06],   # short
        [3.5e-06, 5.0e-06, 6.5e-06, 3.0e-06, 4.5e-06],   # eager
        [5.0e-06, 7.0e-06, 8.0e-06, 5.0e-06, 9.0e-06],   # rendezvous
    ])
    Rb = _tbl([
        [2.0e11, 3.0e10, 1.0e10, 3.0e09, 3.0e09],
        [4.0e11, 3.5e10, 1.1e10, 8.0e09, 5.0e09],
        [6.0e11, 4.0e10, 1.2e10, 1.25e10, 4.5e09],
    ])
    RN = _tbl([
        [INF, INF, INF, INF, INF],
        [INF, INF, INF, INF, INF],
        [INF, INF, INF, 1.25e10, 6.5e09],  # per-rail / per-NIC injection cap
    ])
    return CommParams(
        locality_names=HETERO_LOCALITIES,
        alpha=alpha, Rb=Rb, RN=RN,
        gamma=1.2e-08,                  # GPU-aware MPI match cost
        delta=1.0e-10,
        network_locality=HETERO_NETWORK_LOCALITY,
        n_rails=2,                      # dual-rail IB per node
    )


def frontier() -> CommParams:
    """Frontier-like 8-GCD node: a NIC per GCD pair, device-direct native.

    The mirror image of :func:`lassen`: Slingshot NICs hang off the GPUs, so
    the device-direct path gets the full per-NIC rate across 4 rails, while
    staging through host memory costs an extra copy *and* a slower host send
    path.  Design parameters (see :func:`lassen` on calibration).
    """
    alpha = _tbl([
        # intra_device, cross_device, h2d,   host_staged, device_direct
        [2.5e-06, 3.5e-06, 5.0e-06, 2.0e-06, 1.8e-06],   # short
        [3.0e-06, 4.5e-06, 5.5e-06, 4.0e-06, 2.6e-06],   # eager
        [4.0e-06, 6.0e-06, 7.0e-06, 7.0e-06, 4.0e-06],   # rendezvous
    ])
    Rb = _tbl([
        [3.0e11, 4.0e10, 2.4e10, 3.0e09, 8.0e09],
        [5.0e11, 4.5e10, 2.6e10, 6.0e09, 1.6e10],
        [8.0e11, 5.0e10, 2.8e10, 1.0e10, 2.2e10],
    ])
    RN = _tbl([
        [INF, INF, INF, INF, INF],
        [INF, INF, INF, INF, INF],
        [INF, INF, INF, 1.0e10, 2.5e10],   # per-NIC injection cap
    ])
    return CommParams(
        locality_names=HETERO_LOCALITIES,
        alpha=alpha, Rb=Rb, RN=RN,
        gamma=1.0e-08,
        delta=8.0e-11,
        network_locality=HETERO_NETWORK_LOCALITY,
        n_rails=4,                      # 4 Slingshot NICs per node
    )


# Model parameters of a TPU v5e pod (per chip), the reference's: the
# collective pricing of :mod:`repro_torch.core.decompose` prices XLA
# collectives on that pod with them.  They describe the priced machine, not
# the card the port runs on.
V5E_PEAK_FLOPS_BF16 = 197e12     # FLOP/s
V5E_HBM_BW = 819e9               # bytes/s
V5E_ICI_LINK_BW = 50e9           # bytes/s per link
V5E_ICI_LINKS_PER_CHIP = 4       # 2-D torus: +-x, +-y
V5E_DCN_BW_PER_HOST = 25e9       # bytes/s
V5E_CHIPS_PER_HOST = 4
V5E_HBM_PER_CHIP = 16 * 1024**3  # bytes
