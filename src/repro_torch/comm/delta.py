"""DeltaStack: incremental re-pricing of a mutated sweep arena, on a device.

A :class:`~repro_torch.comm.stack.PhaseStack` makes one-shot sweeps fast;
this module makes *search* fast.  A local-search move — shift a partition
boundary, re-aggregate one node — changes a few dozen messages, yet
re-pricing the candidate through ``PhaseStack.build`` pays the full
O(total messages) cost again.  ``DeltaStack`` keeps the same arena as a
sequence of per-phase incremental states and supports

    ``delta.apply(removed_idx, added) -> DeltaStack``

whose cost is proportional to the *changed phases*, not the whole sweep:

* **integer bookkeeping stays on the host** and is point-updated:
  per-(phase, sender) network-send counts, per-(phase, node) active-sender
  counts (``np.add.at``), the ``active_ppn`` lookups and the per-receiver
  receive counts with their maximum (a point-updatable max tree,
  :class:`_MaxTree`);
* **float per-message work runs on the stack's device**: the node-aware
  per-message transport times survive the move except at the re-priced
  subset (additions and network messages of nodes whose active-sender
  count changed), which is priced with
  :func:`~repro_torch.comm.primitives.transport_times`; the dirty phase's
  send-side row is replayed with one call of kernel K1 by sender, and its
  network and total bytes with one more (two segments).  Surviving device
  columns move with one scatter each: only the removed indices and the
  additions cross to the device.  The postal / flat-max-rate rows are
  priced lazily, on first query per generation;
* **routing / link contention** stays lazy until the simulator first asks;
  from then on the ``(message, link)`` expansion is kept on the device,
  survivors filtered and only additions routed
  (:meth:`~repro_torch.core.topology.TorusTopology.route_link_ids`), and
  contention is ``torch.unique`` over packed ``(link, source)`` keys, then
  K1 for per-source bytes and again for each link's sum and maximum.

Parity contract (the reference promises bit-identity to a fresh numpy
build; K1's float32 sums on the card vary in the last bits, so the port
cannot): per-message cached fields, the mutated message order and every
integer aggregate (receive counts, default- and custom-order queue steps)
are bit-equal to a fresh build; float aggregates are within rtol 1e-4 /
atol 1e-6 of a fresh :class:`PhaseStack` on the same device.  On the CPU
(plain K1: sequential sums in message order) the transport rows and byte
totals are bit-equal to the fresh stack's; link contention is only
allclose there, because the maintained expansion is not re-sorted into the
fresh dimension-major order.  ``verify=True`` asserts this after every
``apply`` (:meth:`DeltaStack.check`).

Mutated phases are canonical: surviving messages keep their order,
additions append at the end — exactly the phase a caller would rebuild.
Fitted-params overrides and flag pairs outside the ladder's three fall back
to a fresh arena over the current phases (built once per generation and
cached), as in the reference; the machine's own tables take the fast path,
which is what a search loop prices.

Port note: the fingerprints and :func:`message_delta` are host numpy,
copied bit for bit (same hash tag, so a port fingerprint equals the
reference's).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import comm_stack as ks

from .phase import CommPhase
from .primitives import transport_times
from .stack import PhaseStack, StackSimArrays, put_column

__all__ = ["DeltaStack", "ARENA_TYPES", "phase_fingerprint",
           "pattern_fingerprint", "message_delta"]


def phase_fingerprint(src, dst, size, n_procs) -> str:
    """Content-hash of one phase's raw message arrays, as a hex string.

    SHA-256 over a canonical byte stream: a version tag, ``n_procs`` and the
    message count as int64, then the ``src`` / ``dst`` endpoint arrays as
    int64 and the ``size`` array as float64, **in message order**.  The hash
    is deliberately order-sensitive: simulator verdicts depend on message
    order (per-candidate seeded arrival streams), so two phases that differ
    only by a permutation must *not* share a cache entry.
    """
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    size = np.ascontiguousarray(size, dtype=np.float64)
    h = hashlib.sha256()
    h.update(b"repro.phase.v1")
    h.update(np.asarray([int(n_procs), src.size], dtype=np.int64).tobytes())
    h.update(src.tobytes())
    h.update(dst.tobytes())
    h.update(size.tobytes())
    return h.hexdigest()


def pattern_fingerprint(pattern) -> str:
    """Content-hash of a :class:`repro_torch.sparse.partition.CommPattern`,
    as a hex string.

    Delegates to :func:`phase_fingerprint` over ``pattern``'s raw
    ``src`` / ``dst`` / ``size`` arrays and ``n_procs`` — anything with
    those four attributes (a ``CommPattern``, a bound ``CommPhase``) hashes
    identically, so a cache keyed on the unbound pattern hits for its bound
    phase too.
    """
    return phase_fingerprint(pattern.src, pattern.dst, pattern.size,
                             pattern.n_procs)


def message_delta(old, new):
    """The multiset message diff turning pattern ``old`` into pattern ``new``.

    Both ``old`` and ``new`` expose raw ``src`` / ``dst`` / ``size`` arrays
    (``CommPattern`` or bound ``CommPhase``).  Returns
    ``(removed_idx, (src, dst, size))`` suitable for
    :meth:`DeltaStack.apply` on a single-phase arena built from ``old``:
    ``removed_idx`` are message indices into ``old``'s order, the added
    arrays are the messages of ``new`` not covered by ``old``.

    Messages match as exact ``(src, dst, size)`` triples, multiset-style:
    when a triple appears ``a`` times in ``old`` and ``b`` times in ``new``,
    ``min(a, b)`` copies survive.  Removals take the *last* duplicate
    occurrences so the earliest survivors keep their slots, matching the
    canonical mutated order ``DeltaStack.apply`` produces (survivors in
    place, additions appended).  Note the resulting order is that canonical
    order, not ``new``'s own order — fingerprint the applied arena's phase,
    not ``new``, when caching the result.
    """
    os_ = np.asarray(old.src, dtype=np.int64).ravel()
    od = np.asarray(old.dst, dtype=np.int64).ravel()
    oz = np.asarray(old.size, dtype=np.float64).ravel()
    ns = np.asarray(new.src, dtype=np.int64).ravel()
    nd = np.asarray(new.dst, dtype=np.int64).ravel()
    nz = np.asarray(new.size, dtype=np.float64).ravel()
    n_old, n_new = os_.size, ns.size
    rec = np.empty(n_old + n_new, dtype=[("s", np.int64), ("d", np.int64),
                                         ("z", np.float64)])
    rec["s"] = np.concatenate([os_, ns])
    rec["d"] = np.concatenate([od, nd])
    rec["z"] = np.concatenate([oz, nz])
    _, inv = np.unique(rec, return_inverse=True)
    inv = inv.ravel()                      # numpy 2.x keeps input shape
    inv_old, inv_new = inv[:n_old], inv[n_old:]
    n_groups = int(inv.max(initial=-1)) + 1
    c_old = np.bincount(inv_old, minlength=n_groups)
    c_new = np.bincount(inv_new, minlength=n_groups)
    keep = np.minimum(c_old, c_new)

    def _ranks(invs, counts):
        # within-group occurrence rank, stable in original message order
        order = np.argsort(invs, kind="stable")
        starts = np.r_[0, np.cumsum(counts)[:-1]]
        r = np.empty(invs.size, dtype=np.int64)
        r[order] = np.arange(invs.size) - starts[invs[order]]
        return r

    removed = np.nonzero(_ranks(inv_old, c_old) >= keep[inv_old])[0]
    add = _ranks(inv_new, c_new) >= keep[inv_new]
    return removed, (ns[add], nd[add], nz[add])


#: The (node_aware, use_maxrate) flag pairs the model ladder prices.  The
#: ladder's five levels collapse onto these three transport passes (postal /
#: max-rate / node-aware; queue and contention reuse the node-aware pass).
_POSTAL = (False, False)
_MAXRATE = (False, True)
_NODE_AWARE = (True, True)
_FLAGS = (_POSTAL, _MAXRATE, _NODE_AWARE)
RTOL, ATOL = 1e-4, 1e-6


class _MaxTree:
    """Point-updatable maximum over a fixed slot span (host numpy).

    A complete binary tree in one flat array: ``update`` rewrites one leaf
    and climbs to the root, so the per-phase worst receive count survives
    removals — which a plain running max cannot — in O(log slots) instead
    of an O(slots) row rebuild.
    """

    __slots__ = ("n", "tree")

    def __init__(self, values: np.ndarray):
        values = np.asarray(values, dtype=np.int64)
        n = 1
        while n < values.size:
            n *= 2
        self.n = n
        t = np.zeros(2 * n, dtype=np.int64)
        t[n:n + values.size] = values
        size = n
        while size > 1:
            size //= 2
            lvl = t[2 * size:4 * size]
            t[size:2 * size] = np.maximum(lvl[0::2], lvl[1::2])
        self.tree = t

    def update(self, i: int, value: int) -> None:
        i += self.n
        t = self.tree
        t[i] = value
        i //= 2
        while i:
            t[i] = max(t[2 * i], t[2 * i + 1])
            i //= 2

    def update_many(self, idx: np.ndarray, values: np.ndarray) -> None:
        """Batch point updates: rewrite the leaves, then climb all the
        affected chains level by level (one vectorized gather-max per level,
        shared ancestors deduplicated)."""
        t = self.tree
        i = np.asarray(idx, dtype=np.int64) + self.n
        t[i] = values
        i = np.unique(i // 2)
        i = i[i > 0]
        while i.size:
            t[i] = np.maximum(t[2 * i], t[2 * i + 1])
            i = np.unique(i // 2)
            i = i[i > 0]

    def max(self) -> int:
        return int(self.tree[1])

    def copy(self) -> "_MaxTree":
        new = _MaxTree.__new__(_MaxTree)
        new.n = self.n
        new.tree = self.tree.copy()
        return new


class _Pricing:
    """The machine's rate tables on the stack's device (float32, as
    ``PhaseStack._transport`` makes them), shared by every generation."""

    __slots__ = ("params", "device", "alpha", "Rb", "RN")

    def __init__(self, params, device: torch.device):
        self.params = params
        self.device = device
        self.alpha, self.Rb, self.RN = (
            torch.as_tensor(t, dtype=torch.float32, device=device)
            for t in (params.alpha, params.Rb, params.RN))

    def put(self, a, what: str) -> torch.Tensor:
        return put_column(a, what, self.device)

    def price(self, arrays, flags) -> torch.Tensor:
        """Transport times for one flag pair over device columns ``(size,
        loc, proto, is_net, active_ppn)`` — the whole phase or the
        re-priced subset; elementwise, so a subset evaluation equals the
        same positions of a full pass bit for bit."""
        size, loc, proto, is_net, ppn = arrays
        p = self.params
        node_aware, use_maxrate = flags
        if node_aware:
            return transport_times(size, self.alpha[loc, proto],
                                   self.Rb[loc, proto], self.RN[loc, proto],
                                   ppn, is_net, rails=p.n_rails)
        nl = p.network_locality
        alpha, Rb = self.alpha[nl][proto], self.Rb[nl][proto]
        if not use_maxrate:
            return transport_times(size, alpha, Rb, use_maxrate=False)
        # the flat max-rate level treats every message as network-class but
        # keeps the machine-classified active-sender counts (as cost_arrays)
        return transport_times(size, alpha, Rb, self.RN[nl][proto], ppn,
                               torch.ones_like(is_net), rails=p.n_rails)

    def host_arrays(self, ph: CommPhase, idx=None):
        """``(size, loc, proto, is_net, active_ppn)`` of phase ``ph`` (or
        its subset ``idx``) on the device."""
        cols = (ph.size, ph.loc, ph.proto, ph.is_net, ph.active_ppn)
        if idx is not None:
            cols = tuple(c[idx] for c in cols)
        size, loc, proto, is_net, ppn = cols
        return (self.put(size, "size"), self.put(loc, "loc").long(),
                self.put(proto, "proto").long(),
                torch.from_numpy(np.ascontiguousarray(is_net)).to(self.device),
                self.put(ppn, "active_ppn"))


def _byte_sums(size: torch.Tensor, is_net: torch.Tensor):
    """(network bytes, all bytes) of one phase as 0-d device tensors: one
    K1 call over two segments, each summed in message order."""
    n = size.numel()
    values = torch.cat([torch.where(is_net, size, torch.zeros_like(size)),
                        size])
    ids = torch.zeros(2 * n, dtype=torch.int32, device=size.device)
    ids[n:] = 1
    sums, _ = ks.segment_reduce(values, ids, 2)
    return sums[0], sums[1]


class _PhaseState:
    """One phase's incrementally-maintained arrays and cached aggregates.

    Host: the bound phase (canonical message order) and the integer tables
    the increments ride on.  Device: the columns the replays read, the
    node-aware transport times, the send-side row and the byte totals.  The
    routing expansion, link contention and the postal / flat-max-rate rows
    are lazy: priced on first query for a generation and, for the routing
    expansion, maintained incrementally from then on.
    """

    __slots__ = ("phase", "span", "cols", "t_na", "row_na", "recv",
                 "recv_tree", "net_bytes", "total_bytes", "net_sends",
                 "node_active", "proc_nodes", "_exp", "_max_link",
                 "_flag_rows")

    phase: CommPhase          # current bound phase (canonical message order)
    span: int                 # row length: covers n_procs and every src/dst
    cols: dict                # device columns: src (int32), size (float32),
    #                           is_net (bool), torus_src (int32)
    t_na: torch.Tensor        # node-aware per-message transport times
    row_na: torch.Tensor      # node-aware send-side sums per process [span]
    recv: np.ndarray          # per-receiver message counts [span], int64
    recv_tree: _MaxTree       # point-updatable max over ``recv``
    net_bytes: torch.Tensor   # network-class bytes (0-d)
    total_bytes: torch.Tensor  # all bytes (for node_aware=False net bytes)
    net_sends: np.ndarray     # per-sender count of network messages [span]
    node_active: np.ndarray   # per-node count of active senders
    proc_nodes: np.ndarray    # node of each process [span]
    _exp: tuple | None        # (message id, link id) expansion on the device
    _max_link: torch.Tensor | None
    _flag_rows: dict

    def row(self, flags, pricing: _Pricing) -> torch.Tensor:
        """Dense send-side transport sums for one ladder flag pair.

        The node-aware pair rides the incremental path; the postal and flat
        max-rate pairs are pure elementwise functions of the phase arrays,
        so they are priced fresh on first query per generation (one K1
        call) and cached.
        """
        if flags == _NODE_AWARE:
            return self.row_na
        row = self._flag_rows.get(flags)
        if row is None:
            t = pricing.price(pricing.host_arrays(self.phase), flags)
            row, _ = ks.segment_reduce(t, self.cols["src"], self.span)
            self._flag_rows[flags] = row
        return row

    def exp(self, device: torch.device) -> tuple:
        """The (message id, link id) routing expansion on the device.

        Routed fresh on first demand when no ancestor ever materialized it;
        once it exists, :func:`_mutate_state` maintains it incrementally
        (survivors filtered, only additions routed).
        """
        if self._exp is None:
            ph = self.phase
            sel = np.nonzero(ph.is_net & (ph.torus_src != ph.torus_dst))[0]
            self._exp = _route(ph.machine.torus, ph, sel, device)
        return self._exp

    def link_contention(self, device: torch.device) -> torch.Tensor:
        """Hottest contended-link bytes (lazy; simulator-side only), as a
        0-d float32 tensor: ``torch.unique`` over packed (link, source)
        keys, K1 for per-source bytes, K1 for each link's sum and maximum;
        bytes beyond a link's largest single source are contention."""
        if self._max_link is None:
            ph = self.phase
            torus = ph.machine.torus
            exp_msg, exp_link = self.exp(device)
            if exp_link.numel() == 0:
                self._max_link = torch.zeros((), dtype=torch.float32,
                                             device=device)
                return self._max_link
            tsrc = self.cols["torus_src"].long()[exp_msg]
            # any span above every source id packs the same groups; on
            # torus_over_procs machines a process id can exceed the torus
            src_span = max(torus.size, int(ph.torus_src.max()) + 1)
            uk, inv = torch.unique(exp_link * src_span + tsrc,
                                   return_inverse=True)
            per_src, _ = ks.segment_reduce(self.cols["size"][exp_msg],
                                           inv.to(torch.int32), uk.numel())
            runs, run_of = torch.unique_consecutive(uk // src_span,
                                                    return_inverse=True)
            totals, largest = ks.segment_reduce(
                per_src, run_of.to(torch.int32), runs.numel())
            self._max_link = (totals - largest).amax()
        return self._max_link


def _route(torus, ph: CommPhase, idx: np.ndarray, device: torch.device):
    """Route messages ``idx`` of phase ``ph`` (host indices of network
    messages between distinct torus units) on the device: ``(message id,
    link id)`` int64 tensors in the dimension-major order of
    ``route_link_ids``."""
    if idx.size == 0:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z.clone()
    a = torch.from_numpy(ph.torus_src[idx]).to(device)
    b = torch.from_numpy(ph.torus_dst[idx]).to(device)
    midx, link = torus.route_link_ids(a, b)
    return torch.from_numpy(idx).to(device)[midx], link


def _build_state(ph: CommPhase, pricing: _Pricing) -> _PhaseState:
    """Full (non-incremental) state for one bound phase — the generation-0
    cost, paid once per phase like ``PhaseStack.build``."""
    m = ph.machine
    if getattr(ph, "loc_overridden", False):
        raise ValueError(
            "DeltaStack needs machine-classified phases: a phase built with "
            "an explicit loc override (a staged strategy step) cannot be "
            "mutated consistently — apply() would classify additions with "
            "the machine's locality()")
    span = int(max(ph.n_procs, ph.src.max(initial=-1) + 1,
                   ph.dst.max(initial=-1) + 1, 1))
    st = _PhaseState.__new__(_PhaseState)
    st.phase = ph
    st.span = span
    st.proc_nodes = np.asarray(m.node_of(np.arange(span)), dtype=np.int64)
    st.net_sends = np.bincount(ph.src[ph.is_net], minlength=span)
    n_nodes = int(st.proc_nodes.max(initial=-1)) + 1
    st.node_active = np.bincount(st.proc_nodes[st.net_sends > 0],
                                 minlength=n_nodes)
    arrays = pricing.host_arrays(ph)
    st.cols = {"src": pricing.put(ph.src, "src"), "size": arrays[0],
               "is_net": arrays[3],
               "torus_src": pricing.put(ph.torus_src, "torus_src")}
    st.t_na = pricing.price(arrays, _NODE_AWARE)
    st.row_na, _ = ks.segment_reduce(st.t_na, st.cols["src"], span)
    st.recv = np.bincount(ph.dst, minlength=span)
    st.recv_tree = _MaxTree(st.recv)
    st.net_bytes, st.total_bytes = _byte_sums(arrays[0], arrays[3])
    st._exp = None
    st._max_link = None
    st._flag_rows = {}
    return st


def _mutate_state(st: _PhaseState, rm_local: np.ndarray, add: tuple | None,
                  pricing: _Pricing) -> _PhaseState:
    """Apply one phase's delta: drop ``rm_local``, append ``add`` messages.

    The canonical mutated order — survivors in place, additions at the end —
    is what every replayed reduction runs over.  Host work is the
    reference's (per-message fields of the additions, integer point
    updates); on the device the surviving columns move by one scatter each
    (removed rows into a dropped slot), the re-priced subset is priced, and
    the row and byte totals are replayed through K1.
    """
    ph = st.phase
    m = ph.machine
    p = m.params
    P = ph.n_procs
    n_old = ph.n_msgs
    dev = pricing.device

    if add is not None:
        # typed validation (PatternError is a ValueError): rejects length
        # mismatches, NaN/negative sizes and endpoints outside the phase's
        # fixed process count before any cached aggregate is touched
        from .guard import validate_messages
        validate_messages(np.asarray(add[0]).ravel(),
                          np.asarray(add[1]).ravel(),
                          np.asarray(add[2]).ravel(), n_procs=P,
                          where="DeltaStack.apply(added)")
        src_a = np.asarray(add[0], dtype=np.int64).ravel()
        dst_a = np.asarray(add[1], dtype=np.int64).ravel()
        size_a = np.asarray(add[2], dtype=np.float64).ravel()
    else:
        src_a = dst_a = np.zeros(0, dtype=np.int64)
        size_a = np.zeros(0)
    na = src_a.size

    keep = np.ones(n_old, dtype=bool)
    keep[rm_local] = False
    nkeep = n_old - rm_local.size
    n_new = nkeep + na

    # machine-derived fields: computed for the additions only
    loc_a = np.asarray(m.locality(src_a, dst_a), dtype=np.int64)
    proto_a = p.protocol_of(size_a)
    is_net_a = loc_a >= p.network_locality
    send_node_a = np.asarray(m.node_of(src_a), dtype=np.int64)
    tsrc_a = np.asarray(m.torus_node_of(src_a), dtype=np.int64)
    tdst_a = np.asarray(m.torus_node_of(dst_a), dtype=np.int64)

    cat = lambda old, new: np.concatenate([old[keep], new])  # noqa: E731
    src = cat(ph.src, src_a)
    dst = cat(ph.dst, dst_a)
    size = cat(ph.size, size_a)
    loc = cat(ph.loc, loc_a)
    proto = cat(ph.proto, proto_a)
    is_net = cat(ph.is_net, is_net_a)
    send_node = cat(ph.send_node, send_node_a)
    torus_src = cat(ph.torus_src, tsrc_a)
    torus_dst = cat(ph.torus_dst, tdst_a)

    out = _PhaseState.__new__(_PhaseState)
    out.span = st.span
    out.proc_nodes = st.proc_nodes

    # -- active-sender tables: integer point updates --------------------------
    rm_net_src = ph.src[rm_local][ph.is_net[rm_local]]
    net_sends = st.net_sends.copy()
    np.subtract.at(net_sends, rm_net_src, 1)
    np.add.at(net_sends, src_a[is_net_a], 1)
    touched = np.unique(np.concatenate([rm_net_src, src_a[is_net_a]]))
    was = st.net_sends[touched] > 0
    now = net_sends[touched] > 0
    node_active = st.node_active
    if (was != now).any():
        node_active = node_active.copy()
        np.add.at(node_active, st.proc_nodes[touched[now & ~was]], 1)
        np.subtract.at(node_active, st.proc_nodes[touched[was & ~now]], 1)
    changed_nodes = np.nonzero(node_active != st.node_active)[0]
    out.net_sends = net_sends
    out.node_active = node_active

    # -- active_ppn: lookup for additions + nodes whose count changed ---------
    active_ppn = np.concatenate([ph.active_ppn[keep], np.zeros(na)])
    active_ppn[nkeep:] = np.where(is_net_a, node_active[send_node_a], 1.0)
    if changed_nodes.size:
        nc = np.zeros(node_active.size, dtype=bool)
        nc[changed_nodes] = True
        aff = np.nonzero(is_net[:nkeep] & nc[send_node[:nkeep]])[0]
        active_ppn[aff] = node_active[send_node[aff]]
    else:
        aff = np.zeros(0, dtype=np.int64)

    out.phase = CommPhase(
        machine=m, src=src, dst=dst, size=size, n_procs=P, loc=loc,
        proto=proto, is_net=is_net, send_node=send_node,
        torus_src=torus_src, torus_dst=torus_dst, active_ppn=active_ppn)

    # -- device columns: survivors scattered to their new slots (removed
    #    rows land in one dropped slot), additions copied in after them -----
    keep_t = torch.ones(n_old, dtype=torch.bool, device=dev)
    keep_t[torch.from_numpy(rm_local).to(dev)] = False
    pos = torch.cumsum(keep_t, 0) - 1                # old local -> new local
    dest = torch.where(keep_t, pos, torch.full_like(pos, n_new))

    def carry(col: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        buf = col.new_empty(n_new + 1)
        buf.scatter_(0, dest, col)
        buf[nkeep:n_new] = new
        return buf[:n_new]

    put = pricing.put
    out.cols = {
        "src": carry(st.cols["src"], put(src_a, "src")),
        "size": carry(st.cols["size"], put(size_a, "size")),
        "is_net": carry(st.cols["is_net"],
                        torch.from_numpy(is_net_a).to(dev)),
        "torus_src": carry(st.cols["torus_src"], put(tsrc_a, "torus_src"))}

    # -- node-aware transport times: re-price only what a fresh build would
    #    price differently (additions + ppn-affected network messages) --------
    ppn_idx = np.concatenate([aff, np.arange(nkeep, n_new)])
    t_na = carry(st.t_na, torch.zeros(na, dtype=torch.float32, device=dev))
    if ppn_idx.size:
        t_na[torch.from_numpy(ppn_idx).to(dev)] = pricing.price(
            pricing.host_arrays(out.phase, ppn_idx), _NODE_AWARE)
    out.t_na = t_na
    out.row_na, _ = ks.segment_reduce(t_na, out.cols["src"], st.span)
    out._flag_rows = {}

    # -- receive counts: point updates + max-tree maintenance -----------------
    recv = st.recv.copy()
    np.subtract.at(recv, ph.dst[rm_local], 1)
    np.add.at(recv, dst_a, 1)
    tree = st.recv_tree.copy()
    touched_dst = np.unique(np.concatenate([ph.dst[rm_local], dst_a]))
    tree.update_many(touched_dst, recv[touched_dst])
    out.recv = recv
    out.recv_tree = tree

    # -- byte totals: replayed over the mutated phase (one K1 call) -----------
    out.net_bytes, out.total_bytes = _byte_sums(out.cols["size"],
                                                out.cols["is_net"])

    # -- routing: once materialized, filter surviving expansion rows and
    #    route additions only; contention itself stays lazy.  The rows are
    #    not re-sorted into dimension-major order: contention groups them by
    #    torch.unique, which only K1's float sums could tell apart ---------
    if st._exp is None:
        out._exp = None                  # never queried: stay lazy
    else:
        old_msg, old_link = st._exp
        keep_exp = keep_t[old_msg]
        exp_msg, exp_link = pos[old_msg[keep_exp]], old_link[keep_exp]
        sel_a = nkeep + np.nonzero(is_net_a & (tsrc_a != tdst_a))[0]
        add_msg, add_link = _route(m.torus, out.phase, sel_a, dev)
        out._exp = (torch.cat([exp_msg, add_msg]),
                    torch.cat([exp_link, add_link]))
    out._max_link = None
    return out


class DeltaStack:
    """A sweep arena that prices *mutations* at O(changed) cost, on a device.

    Construction (:meth:`from_phases`) pays the same one-time cost as
    ``PhaseStack.build``; every subsequent :meth:`apply` touches only the
    phases named by the delta.  ``apply`` is functional: it returns a new
    ``DeltaStack`` sharing every clean phase's state with its parent, so a
    rejected local-search candidate is discarded by dropping the object —
    no undo log.  The query surface mirrors
    :class:`~repro_torch.comm.stack.PhaseStack` (``cost_arrays`` /
    ``sim_arrays`` / ``phases`` / ``n_procs`` / ``device``), and the
    batched entry points accept either.
    """

    def __init__(self, machine, states: tuple, device: torch.device,
                 pricing: _Pricing | None, verify: bool = False):
        self.machine = machine
        self.device = device
        self._states = states
        self._pricing = pricing
        self.verify = bool(verify)
        self.phases = tuple(st.phase for st in states)
        counts = np.asarray([ph.n_msgs for ph in self.phases], dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_procs = np.asarray([ph.n_procs for ph in self.phases],
                                  dtype=np.int64)
        self._fresh_cache = None

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_phases(cls, phases, *, device=None,
                    verify: bool = False) -> "DeltaStack":
        """Bind a sweep ``phases`` (bound ``CommPhase``s, priced on
        ``device``, ``None`` = CUDA; or a ``PhaseStack``, which keeps its
        own device) as a delta arena.  Same-machine validation matches
        ``PhaseStack.build``; ``verify=True`` checks the parity contract
        after construction and every ``apply``."""
        if isinstance(phases, PhaseStack):
            device, phases = phases.device, phases.phases
        else:
            device = resolve_device(device)
        phases = tuple(phases)
        for ph in phases:
            if not isinstance(ph, CommPhase):
                raise TypeError(
                    f"DeltaStack wraps bound CommPhases, got {type(ph).__name__}")
        machine = phases[0].machine if phases else None
        for ph in phases:
            if ph.machine is not machine:
                raise ValueError(
                    "mixed machines: every phase in a DeltaStack must be "
                    "bound to the same machine object (rebind with "
                    "CommPhase.build / CommPattern.bind first)")
        pricing = (_Pricing(machine.params, device) if machine is not None
                   else None)
        out = cls(machine, tuple(_build_state(ph, pricing) for ph in phases),
                  device, pricing, verify=verify)
        if verify:
            out.check()
        return out

    # -- basic stats ----------------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self._states)

    @property
    def total_msgs(self) -> int:
        return int(self.offsets[-1]) if self.offsets.size else 0

    def __len__(self) -> int:
        return self.n_phases

    def __iter__(self):
        return iter(self.phases)

    def fingerprint(self) -> str:
        """Content-hash of the arena's current phases, as a hex string:
        SHA-256 over the per-phase :func:`phase_fingerprint` digests in
        phase order, so a ``DeltaStack`` and a fresh arena over the same
        phases (same message order) hash identically, and any ``apply``
        changes the fingerprint."""
        h = hashlib.sha256()
        h.update(b"repro.delta.v1")
        for ph in self.phases:
            h.update(bytes.fromhex(
                phase_fingerprint(ph.src, ph.dst, ph.size, ph.n_procs)))
        return h.hexdigest()

    # -- mutation -------------------------------------------------------------
    def apply(self, removed_idx=None, added=None, *,
              verify: bool | None = None) -> "DeltaStack":
        """One delta step: drop messages, append messages, re-price.

        Parameters
        ----------
        removed_idx : arena indices (into the current concatenated message
            order, ``offsets[p] + local``) of messages to remove.  Must be
            unique and in range.
        added : ``{phase_index: (src, dst, size)}`` mapping (or a sequence
            with one entry — possibly None — per phase).  Added endpoints
            must lie inside the phase's fixed process count.
        verify : override the stack's debug flag for this step.

        Returns a new ``DeltaStack`` on the same device; phases outside the
        delta share state with ``self``.  An empty delta returns an
        equal-valued stack.  The only reads of the device here are K1's
        range checks (two calls a dirty phase) and, once the simulator has
        materialized a routing expansion, the routing of the survivors and
        additions.
        """
        verify = self.verify if verify is None else bool(verify)
        rm = (np.zeros(0, dtype=np.int64) if removed_idx is None
              else np.asarray(removed_idx, dtype=np.int64).ravel())
        if rm.size:
            uniq = np.unique(rm)
            if uniq.size != rm.size:
                raise ValueError("removed_idx contains duplicate indices")
            rm = uniq
            if rm[0] < 0 or rm[-1] >= self.total_msgs:
                raise ValueError(
                    f"removed_idx out of range for an arena of "
                    f"{self.total_msgs} messages")
        if added is None:
            added = {}
        elif not isinstance(added, dict):
            added = {i: a for i, a in enumerate(added) if a is not None}
        added = {int(k): v for k, v in added.items()}
        for k in added:
            if not 0 <= k < self.n_phases:
                raise ValueError(
                    f"added phase index {k} out of range for "
                    f"{self.n_phases} phases")
        pid = np.searchsorted(self.offsets, rm, side="right") - 1
        local = rm - self.offsets[pid]
        dirty = sorted(set(pid.tolist()) | {int(k) for k, v in added.items()
                                            if np.asarray(v[0]).size})
        states = list(self._states)
        for i in dirty:
            states[i] = _mutate_state(self._states[i], local[pid == i],
                                      added.get(i), self._pricing)
        out = DeltaStack(self.machine, tuple(states), self.device,
                         self._pricing, verify=verify)
        if verify:
            out.check()
        return out

    # -- fallback arena -------------------------------------------------------
    def _fresh(self) -> PhaseStack:
        """A fresh ``PhaseStack`` over the current phases on the same device
        — the delegate for fitted-params overrides and flag pairs outside
        the ladder's three, and what :meth:`check` compares against.  Built
        once per generation."""
        if self._fresh_cache is None:
            self._fresh_cache = PhaseStack.build(self.phases,
                                                 device=self.device)
        return self._fresh_cache

    def _stacked(self, values) -> torch.Tensor:
        """Per-phase 0-d device tensors as one float32 ``[n_phases]``."""
        return torch.stack(list(values)).to(torch.float32)

    # -- model-side aggregates ------------------------------------------------
    def cost_arrays(self, params=None, *, node_aware: bool = True,
                    use_maxrate: bool = True, with_queue: bool = True,
                    with_net_bytes: bool = True):
        """Per-phase ``(transport, max_recv, net_bytes)`` float32 tensors on
        the stack's device from the delta caches — the contract (and the
        arguments) of :meth:`PhaseStack.cost_arrays`.

        The fast path serves the machine's own parameter tables; a
        fitted-params override or a flag pair outside the ladder's three
        delegates to a fresh arena over the current phases (built once per
        generation), so results stay correct either way.
        """
        N = self.n_phases
        zeros = torch.zeros(N, dtype=torch.float32, device=self.device)
        if N == 0 or self.total_msgs == 0:
            return zeros, zeros.clone(), zeros.clone()
        m = self.machine
        p = params if params is not None else m.params
        flags = (node_aware, use_maxrate)
        if p is not m.params or flags not in _FLAGS:
            return self._fresh().cost_arrays(
                params, node_aware=node_aware, use_maxrate=use_maxrate,
                with_queue=with_queue, with_net_bytes=with_net_bytes)
        transport = self._stacked(st.row(flags, self._pricing).amax()
                                  for st in self._states)
        max_recv = (torch.tensor([st.recv_tree.max() for st in self._states],
                                 dtype=torch.float32, device=self.device)
                    if with_queue else zeros.clone())
        if not with_net_bytes:
            net_bytes = zeros.clone()
        elif node_aware:
            net_bytes = self._stacked(st.net_bytes for st in self._states)
        else:                       # every message priced as network-class
            net_bytes = self._stacked(st.total_bytes for st in self._states)
        return transport, max_recv, net_bytes

    # -- simulator-side aggregates --------------------------------------------
    def sim_arrays(self, recv_post_orders=None,
                   arrival_orders=None) -> StackSimArrays:
        """Raw simulator aggregates — the contract (and the
        ``recv_post_orders`` / ``arrival_orders`` arguments) of
        :meth:`PhaseStack.sim_arrays`, as tensors on the stack's device.
        Transport and link contention come from the delta caches;
        default-order queue steps are the maintained receive counts, custom
        orders pay the exact walk (kernel K2) through
        :meth:`CommPhase.queue_steps`, one call per phase.
        """
        dev = self.device
        if self.n_phases == 0:
            z = torch.zeros(0, dtype=torch.float32, device=dev)
            return StackSimArrays(z, [], [], z.clone(), z.clone())
        empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
        empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
        per_proc, qsteps = [], []
        default_orders = recv_post_orders is None and arrival_orders is None
        for i, st in enumerate(self._states):
            ph = st.phase
            if ph.n_msgs == 0:
                per_proc.append(empty_f)
                qsteps.append(empty_i)
                continue
            per_proc.append(st.row_na[:ph.n_procs])
            if default_orders:
                qsteps.append(torch.tensor(st.recv[:ph.n_procs],
                                           dtype=torch.int64, device=dev))
            else:
                qsteps.append(ph.queue_steps(
                    recv_post_orders[i] if recv_post_orders else None,
                    arrival_orders[i] if arrival_orders else None,
                    device=dev))
        return StackSimArrays(
            transport=self._stacked(st.row_na.amax() for st in self._states),
            per_proc=per_proc, qsteps=qsteps,
            max_link=self._stacked(st.link_contention(dev)
                                   for st in self._states),
            net_bytes=self._stacked(st.net_bytes for st in self._states))

    # -- the debug contract ---------------------------------------------------
    def check(self) -> None:
        """Assert the parity contract against a freshly built arena on the
        same device.

        The mutated phases' cached per-message fields must equal
        ``CommPhase.build`` from their raw arrays; every ladder flag pair's
        ``cost_arrays`` and the default-order ``sim_arrays`` must match the
        fresh stack's: receive counts and queue steps bit-equal, transport
        and byte totals bit-equal on the CPU and within rtol 1e-4 / atol
        1e-6 on the card, link contention within that bound on both.
        Raises ``AssertionError`` on the first divergence.
        """
        for i, ph in enumerate(self.phases):
            rb = CommPhase.build(ph.machine, ph.src, ph.dst, ph.size,
                                 n_procs=ph.n_procs)
            for f in ("loc", "proto", "is_net", "send_node", "torus_src",
                      "torus_dst", "active_ppn"):
                assert np.array_equal(getattr(ph, f), getattr(rb, f)), \
                    f"phase {i}: cached {f} drifted from a fresh build"
        if self.n_phases == 0:
            return
        fresh = PhaseStack.build(self.phases, device=self.device)
        exact = self.device.type == "cpu"

        def same(g, w, what, floats=True, bits=exact):
            if floats and not bits:
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                           msg=f"{what} drifted from a "
                                           "fresh build")
            else:
                assert torch.equal(g, w), f"{what} drifted from a fresh build"

        for flags in _FLAGS:
            got = self.cost_arrays(node_aware=flags[0], use_maxrate=flags[1])
            want = fresh.cost_arrays(node_aware=flags[0],
                                     use_maxrate=flags[1])
            for g, w, name in zip(got, want,
                                  ("transport", "max_recv", "net_bytes")):
                same(g, w, f"cost_arrays{flags} {name}",
                     floats=name != "max_recv")
        got = self.sim_arrays()
        want = fresh.sim_arrays()
        same(got.transport, want.transport, "sim transport")
        same(got.net_bytes, want.net_bytes, "sim net_bytes")
        same(got.max_link, want.max_link, "link contention", bits=False)
        for g, w in zip(got.per_proc, want.per_proc):
            same(g, w, "per-proc transport")
        for g, w in zip(got.qsteps, want.qsteps):
            same(g, w, "queue steps", floats=False)
        self._fresh_cache = fresh


#: The arena types the batched entry points price straight from cached
#: aggregates (both expose the cost_arrays / sim_arrays query surface).
ARENA_TYPES = (PhaseStack, DeltaStack)
