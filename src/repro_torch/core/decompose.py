"""Decompose XLA collectives into point-to-point messages and price them.

This is where the paper's model becomes a first-class framework feature: the
compiled HLO's collectives (parsed by :mod:`repro_torch.core.hlo`) are
lowered to per-chip message lists under canonical algorithms (ring
all-reduce / all-gather / reduce-scatter, pairwise all-to-all, direct
permute), each message is classified by physical locality on the pod
(intra-host / intra-pod ICI / inter-pod DCN), and the phase is priced with
the node-aware max-rate model **plus the paper's queue-search (gamma*n^2)
and contention (delta*ell) terms**.

The naive estimate ``bytes / link_bw`` is reported alongside; the gap between
the two is precisely the paper's thesis (message counts and link sharing
matter, not just bytes).

Messages are kept in compressed form: arrays ``(src, dst, size, mult)`` where
``mult`` counts how many times the (src, dst, size) message repeats across
the algorithm's rounds.

Port note: the geometry, the message sets and the queue and contention
terms are the reference's host numpy, message for message.  The per-chip
sums (bytes, sends, ICI and DCN bytes, transport time) run on a torch
device through kernel K1: :func:`price_step` stacks every op's messages
into one set of device columns keyed by ``op * n_devices + chip``, prices
each message there (float32) and makes one K1 call and one host read for
the whole step.  Those sums are float32-allclose to the reference's
float64 ones.  The pod parameters (``V5E_*``) are the reference's model of
a TPU v5e pod, the machine being priced.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.stack import put_column
from repro_torch.device import resolve_device
from repro_torch.kernels import comm_stack as ks

from .hlo import CollectiveOp
from .params import (CommParams, V5E_ICI_LINK_BW, V5E_ICI_LINKS_PER_CHIP,
                     V5E_DCN_BW_PER_HOST, V5E_CHIPS_PER_HOST)

__all__ = ["PodGeometry", "MessageSet", "decompose_collective",
           "CollectiveCost", "StepCommModel", "price_collective",
           "price_step", "active_senders_per_host"]


@dataclasses.dataclass(frozen=True)
class PodGeometry:
    """Physical layout of the production slice.

    Device ids are laid out pod-major, then row-major over the pod's 2-D ICI
    torus: ``device = pod * chips_per_pod + row * cols + col``.  Hosts are
    groups of ``chips_per_host`` consecutive chips along a row.
    """

    n_pods: int = 1
    rows: int = 16
    cols: int = 16
    chips_per_host: int = V5E_CHIPS_PER_HOST
    torus_ndim: int = 2

    @property
    def chips_per_pod(self) -> int:
        return self.rows * self.cols

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.chips_per_pod

    def pod_of(self, d) -> np.ndarray:
        return np.asarray(d) // self.chips_per_pod

    def host_of(self, d) -> np.ndarray:
        d = np.asarray(d)
        within = d % self.chips_per_pod
        return (self.pod_of(d) * (self.chips_per_pod // self.chips_per_host)
                + within // self.chips_per_host)

    def locality(self, a, b) -> np.ndarray:
        """0 = intra-host, 1 = intra-pod (ICI), 2 = inter-pod (DCN)."""
        a, b = np.asarray(a), np.asarray(b)
        same_pod = self.pod_of(a) == self.pod_of(b)
        same_host = self.host_of(a) == self.host_of(b)
        return np.where(same_host, 0, np.where(same_pod, 1, 2)).astype(np.int64)

    def hop_components(self, a, b) -> tuple[np.ndarray, np.ndarray]:
        """Per-dimension ICI ring distances (dr, dc); 0 for cross-pod pairs."""
        a, b = np.asarray(a), np.asarray(b)
        wa, wb = a % self.chips_per_pod, b % self.chips_per_pod
        ra, ca_ = wa // self.cols, wa % self.cols
        rbb, cb = wb // self.cols, wb % self.cols
        dr = np.abs(ra - rbb)
        dc = np.abs(ca_ - cb)
        dr = np.minimum(dr, self.rows - dr)
        dc = np.minimum(dc, self.cols - dc)
        same = self.pod_of(a) == self.pod_of(b)
        return np.where(same, dr, 0), np.where(same, dc, 0)

    def hops(self, a, b) -> np.ndarray:
        """ICI torus hop count (intra-pod); inter-pod pairs return 0 (DCN)."""
        dr, dc = self.hop_components(a, b)
        return dr + dc

    def transit_hops(self, a, b) -> np.ndarray:
        """Links shared with other nodes' traffic: sum_dim max(d_dim - 1, 0).

        A nearest-neighbor hop uses only the sender's own injection link
        (priced by R_N); each extra hop in a dimension rides through
        intermediate chips whose links carry other flows.
        """
        dr, dc = self.hop_components(a, b)
        return np.maximum(dr - 1, 0) + np.maximum(dc - 1, 0)


@dataclasses.dataclass
class MessageSet:
    """Compressed p2p message set: mult[i] repeats of src->dst of size bytes.

    ``outstanding`` is the maximum number of *simultaneously posted* receives
    per chip and ``waves`` the number of posting waves: a ring algorithm posts
    one receive per round (outstanding=1, waves=rounds) while a pairwise
    all-to-all posts k-1 at once (outstanding=k-1, waves=1).  The TPU
    adaptation of the paper's queue term is ``gamma * outstanding^2 * waves``
    — the quadratic matching cost applies to what is in flight together.
    """

    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    mult: np.ndarray
    rounds: int      # serialized algorithm rounds
    outstanding: int = 1
    waves: int = 1

    @classmethod
    def empty(cls) -> "MessageSet":
        z = np.zeros(0, dtype=np.int64)
        return cls(z, z, np.zeros(0), np.zeros(0), 0, 0, 0)

    @classmethod
    def concat(cls, sets: list["MessageSet"]) -> "MessageSet":
        sets = [s for s in sets if s.src.size]
        if not sets:
            return cls.empty()
        return cls(np.concatenate([s.src for s in sets]),
                   np.concatenate([s.dst for s in sets]),
                   np.concatenate([s.size for s in sets]),
                   np.concatenate([s.mult for s in sets]),
                   max(s.rounds for s in sets),
                   max(s.outstanding for s in sets),
                   max(s.waves for s in sets))


def decompose_collective(op: CollectiveOp) -> MessageSet:
    """Lower one collective execution (all groups) to a compressed message set."""
    if op.kind == "collective-permute":
        pairs = op.source_target_pairs or []
        if not pairs:
            return MessageSet.empty()
        src = np.asarray([p[0] for p in pairs], dtype=np.int64)
        dst = np.asarray([p[1] for p in pairs], dtype=np.int64)
        indeg = int(np.bincount(dst).max())
        return MessageSet(src, dst, np.full(len(pairs), op.result_bytes),
                          np.ones(len(pairs)), 1, outstanding=indeg, waves=1)

    if op.groups is None:
        return MessageSet.empty()

    parts: list[MessageSet] = []
    for group in op.groups:
        k = len(group)
        if k <= 1:
            continue
        g = np.asarray(group, dtype=np.int64)
        ring_dst = np.roll(g, -1)
        if op.kind == "all-reduce":
            # ring reduce-scatter + ring all-gather: 2(k-1) rounds of B/k
            parts.append(MessageSet(g, ring_dst,
                                    np.full(k, op.result_bytes / k),
                                    np.full(k, 2.0 * (k - 1)), 2 * (k - 1),
                                    outstanding=1, waves=2 * (k - 1)))
        elif op.kind == "all-gather":
            # result is the gathered buffer -> shard = result/k; k-1 rounds
            parts.append(MessageSet(g, ring_dst,
                                    np.full(k, op.result_bytes / k),
                                    np.full(k, float(k - 1)), k - 1,
                                    outstanding=1, waves=k - 1))
        elif op.kind == "reduce-scatter":
            # result is the scattered shard; k-1 ring rounds of shard bytes
            parts.append(MessageSet(g, ring_dst,
                                    np.full(k, float(op.result_bytes)),
                                    np.full(k, float(k - 1)), k - 1,
                                    outstanding=1, waves=k - 1))
        elif op.kind in ("all-to-all", "ragged-all-to-all"):
            # pairwise: each device sends B/k to each of k-1 peers
            src = np.repeat(g, k - 1)
            dst = np.concatenate([np.delete(g, i) for i in range(k)])
            parts.append(MessageSet(src, dst,
                                    np.full(k * (k - 1), op.result_bytes / k),
                                    np.ones(k * (k - 1)), k - 1,
                                    outstanding=k - 1, waves=1))
    return MessageSet.concat(parts)


@dataclasses.dataclass
class CollectiveCost:
    kind: str
    count: int
    payload_bytes: float          # per-device payload per execution
    wire_bytes_per_chip: float    # p2p bytes sent by busiest chip, per exec
    n_msgs_per_chip: float        # messages sent by busiest chip, per exec
    naive_time: float             # bytes / link-bw estimate (per exec)
    transport: float              # node-aware max-rate term (per exec)
    queue: float                  # gamma * n^2 (per exec)
    contention: float             # delta * ell (per exec)

    @property
    def model_time(self) -> float:
        return self.transport + self.queue + self.contention


@dataclasses.dataclass
class StepCommModel:
    """Whole-step communication cost: sum over collective executions."""

    per_op: list[CollectiveCost]
    naive_time: float
    transport: float
    queue: float
    contention: float
    model_time: float
    total_wire_bytes: float       # busiest-chip wire bytes, whole step
    total_msgs: float             # busiest-chip message count, whole step

    def as_dict(self) -> dict:
        return {
            "naive_time": self.naive_time, "transport": self.transport,
            "queue": self.queue, "contention": self.contention,
            "model_time": self.model_time,
            "total_wire_bytes": self.total_wire_bytes,
            "total_msgs": self.total_msgs,
            "ops": [dataclasses.asdict(o) for o in self.per_op],
        }


#: The per-chip sums :func:`price_step` makes through K1, in the order of
#: its value columns: sent bytes, sent messages, ICI bytes, DCN bytes and
#: transport seconds.
_SUMS = ("send_bytes", "sends", "per_chip_ici", "per_chip_dcn", "per_chip_t")


def active_senders_per_host(op_of, host, src, is_net) -> np.ndarray:
    """Per message, the number of distinct senders of its op on its host
    among the op's network-class messages (1 for a message that is not
    network-class): the max-rate ``ppn`` of DCN egress.  One ``np.unique``
    over ``(op, host, src)`` keys instead of the reference's loop over
    messages; the same integers (float64)."""
    op_of, host, src = (np.asarray(a, dtype=np.int64)
                        for a in (op_of, host, src))
    is_net = np.asarray(is_net, dtype=bool)
    ppn = np.ones(src.shape)
    if not is_net.any():
        return ppn
    h_span = int(host.max()) + 1
    s_span = int(src.max()) + 1
    hk = op_of[is_net] * h_span + host[is_net]
    pairs = np.unique(hk * s_span + src[is_net])
    counts = np.bincount(pairs // s_span,
                         minlength=(int(op_of.max()) + 1) * h_span)
    ppn[is_net] = counts[hk]
    return ppn


def price_collective(op: CollectiveOp, geom: PodGeometry,
                     params: CommParams, device=None) -> CollectiveCost:
    """Apply the full model ladder to one collective execution, its per-chip
    sums on ``device`` (``None`` = CUDA; raises without one)."""
    return _price_ops([op], geom, params, device)[0]


def _price_ops(ops, geom: PodGeometry, params: CommParams,
               device) -> list[CollectiveCost]:
    """The :class:`CollectiveCost` of each op, every op's messages stacked
    into one set of device columns: one K1 call over five value columns
    keyed by ``(column, op, chip)`` and one host read of each (column, op)
    maximum over the chips."""
    dev = resolve_device(device)
    sets = [decompose_collective(op) for op in ops]
    live = [i for i, ms in enumerate(sets) if ms.src.size]
    out = [CollectiveCost(op.kind, op.count, op.result_bytes, 0.0, 0.0, 0.0,
                          0.0, 0.0, 0.0) for op in ops]
    if not live:
        return out
    n_dev, n_live = geom.n_devices, len(live)
    src = np.concatenate([sets[i].src for i in live])
    dst = np.concatenate([sets[i].dst for i in live])
    size = np.concatenate([sets[i].size for i in live])
    mult = np.concatenate([sets[i].mult for i in live])
    op_of = np.repeat(np.arange(n_live), [sets[i].src.size for i in live])
    for what, ids in (("src", src), ("dst", dst)):
        # the reference's per-chip arrays raise on a chip past the pod; a
        # key past it here would land in the next op's chips
        if ids.min() < 0 or ids.max() >= n_dev:
            raise IndexError(f"collective {what} chip ids span "
                             f"[{ids.min()}, {ids.max()}], outside the "
                             f"pod's {n_dev} devices")
    loc = geom.locality(src, dst)
    is_net = loc >= params.network_locality
    ppn = active_senders_per_host(op_of, geom.host_of(src), src, is_net)

    # --- per-chip sums on the device: one K1 call ---------------------------
    col = {name: put_column(a, name, dev) for name, a in (
        ("key", op_of * n_dev + src), ("size", size), ("mult", mult),
        ("loc", loc), ("proto", params.protocol_of(size)), ("ppn", ppn))}
    lk, pk = col["loc"].long(), col["proto"].long()
    at, rb, rn = (torch.as_tensor(t, dtype=torch.float32, device=dev)[lk, pk]
                  for t in (params.alpha, params.Rb, params.RN))
    d_size, d_ppn = col["size"], col["ppn"]
    t_msg = (at + d_ppn * d_size / torch.minimum(rn, d_ppn * rb)) \
        * col["mult"]
    wbytes = d_size * col["mult"]
    dcn = lk == 2
    zero = torch.zeros_like(wbytes)
    values = torch.cat([wbytes, col["mult"], torch.where(dcn, zero, wbytes),
                        torch.where(dcn, wbytes, zero), t_msg])
    S = n_live * n_dev
    ids = torch.cat([col["key"] + c * S for c in range(len(_SUMS))])
    sums, _ = ks.segment_reduce(values, ids, len(_SUMS) * S)
    peak = dict(zip(_SUMS, sums.view(len(_SUMS), n_live, n_dev).amax(dim=2)
                    .double().cpu().numpy()))

    # --- per-op terms on the host (the reference's float64) ----------------
    wb = size * mult
    ici = loc == 1
    for j, i in enumerate(live):
        op, ms, mine = ops[i], sets[i], op_of == j
        # ring traffic uses one link at a time; all-to-all spreads over links
        links = V5E_ICI_LINKS_PER_CHIP if op.kind in (
            "all-to-all", "ragged-all-to-all") else 1
        naive = float(peak["per_chip_ici"][j]) / (V5E_ICI_LINK_BW * links)
        if (mine & (loc == 2)).any():
            naive += (float(peak["per_chip_dcn"][j]) * geom.chips_per_host
                      / V5E_DCN_BW_PER_HOST)
        # queue-search term (paper Eq. 3, TPU adaptation): gamma * n^2 with
        # n = simultaneously outstanding receives, per wave
        queue = (float(params.gamma) * float(ms.outstanding) ** 2
                 * float(ms.waves))
        # contention term (paper Eqs. 5-7, TPU adaptation): measured transit
        # hops in place of the unknown-partition h^d estimate, ell = 2*h*b
        group_devs = np.unique(np.concatenate([ms.src, ms.dst]))
        sel = mine & ici
        net_bytes = float(wb[sel].sum())
        contention = 0.0
        if net_bytes > 0 and len(group_devs) > 1:
            th = geom.transit_hops(src[sel], dst[sel]).astype(np.float64)
            h_transit = float((th * wb[sel]).sum() / net_bytes)
            b = net_bytes / len(group_devs)
            contention = float(params.delta) * 2.0 * h_transit * b
        out[i] = CollectiveCost(op.kind, op.count, op.result_bytes,
                                float(peak["send_bytes"][j]),
                                float(peak["sends"][j]), naive,
                                float(peak["per_chip_t"][j]), queue,
                                contention)
    return out


def price_step(ops: list[CollectiveOp], geom: PodGeometry,
               params: CommParams, device=None) -> StepCommModel:
    """Whole-step cost of ``ops``: every op priced as
    :func:`price_collective` does, all of them in one K1 call on ``device``
    (``None`` = CUDA; raises without one), summed over executions."""
    per_op = _price_ops(list(ops), geom, params, device)
    naive = sum(c.naive_time * c.count for c in per_op)
    transport = sum(c.transport * c.count for c in per_op)
    queue = sum(c.queue * c.count for c in per_op)
    cont = sum(c.contention * c.count for c in per_op)
    wire = sum(c.wire_bytes_per_chip * c.count for c in per_op)
    msgs = sum(c.n_msgs_per_chip * c.count for c in per_op)
    return StepCommModel(per_op, naive, transport, queue, cont,
                         transport + queue + cont, wire, msgs)
