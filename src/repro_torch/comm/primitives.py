"""Primitives shared by the model ladder and the event simulator.

Both sides of the paper's model/measurement gap need the same per-phase
quantities: how many processes on each node actively inject into the
network, the max-rate transport time of each message, and how many
receive-queue slots each envelope walks.

Port note: the host-side pieces stay numpy — active-sender counts at
``CommPhase.build``, the aggregation idioms the strategy rewrites are built
from (:func:`sum_by_pairs`, :func:`segmented_arange`), and the assembly and
validation of receive orders (:func:`flat_orders`, :func:`_assemble_orders`).
:func:`transport_times` runs on device tensors, and
:func:`grouped_queue_steps` hands the assembled walk to kernel K2
(:func:`repro_torch.kernels.comm_stack.queue_walk`) on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import comm_stack as ks
# the plain version of K2 under the reference's name: all receivers'
# Fenwick walks advanced in lock-step rounds, in torch ops
from repro_torch.kernels.comm_stack import (  # noqa: F401
    queue_walk_plain as batched_queue_traversal_steps)


# -- active senders per node -------------------------------------------------

def active_senders_per_node(src, node, is_net) -> np.ndarray:
    """Per-message count of actively-communicating processes on the sender's node.

    ``src[i]`` / ``node[i]`` / ``is_net[i]`` are message ``i``'s sending
    process, that process's node, and whether the message is network-class.
    A process is *active* on its node if it sends at least one network-class
    message; every network message then contends with its node's active-sender
    count for injection bandwidth (the max-rate mechanism).  Non-network
    messages get 1.
    """
    src = np.asarray(src, dtype=np.int64)
    node = np.asarray(node, dtype=np.int64)
    is_net = np.asarray(is_net, dtype=bool)
    ppn = np.ones(src.shape, dtype=np.float64)
    if src.size == 0 or not is_net.any():
        return ppn
    nd, sp = node[is_net], src[is_net]
    span = np.int64(sp.max()) + 1
    pair_node = np.unique(nd * span + sp) // span     # distinct (node, sender)
    nodes_u, senders = np.unique(pair_node, return_counts=True)
    ppn[is_net] = senders[np.searchsorted(nodes_u, nd)]
    return ppn


# -- max-rate message pricing ------------------------------------------------

def transport_times(size: torch.Tensor, alpha: torch.Tensor,
                    Rb: torch.Tensor, RN: torch.Tensor | None = None,
                    ppn: torch.Tensor | None = None,
                    is_net: torch.Tensor | None = None,
                    use_maxrate: bool = True, rails: int = 1) -> torch.Tensor:
    """Per-message transport time under the (node-aware) max-rate model.

    All arguments are tensors on one device: ``size`` bytes per message,
    the already-indexed per-message parameters ``alpha`` / ``Rb`` / ``RN``,
    ``ppn`` the active senders on each sender's node and ``is_net`` the
    network-class mask.  Only network-class messages contend for the node
    injection cap ``RN``; with ``use_maxrate=False`` the cap is ignored
    (pure postal model, ``RN`` / ``ppn`` / ``is_net`` unused).  ``rails``
    is the node's NIC count: ``ceil(ppn / rails)`` processes contend per
    NIC and ``RN`` is the per-rail cap.
    """
    if not use_maxrate:
        return alpha + size / Rb
    eff = ppn if rails == 1 else torch.ceil(ppn / rails)
    eff = torch.where(is_net, eff.clamp_min(1.0), torch.ones_like(eff))
    rate = torch.minimum(RN, eff * Rb)
    return alpha + eff * size / rate


def sum_by_pairs(a, b, w) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate weights ``w`` over distinct ``(a, b)`` pairs (host numpy).

    Returns ``(ua, ub, sums)`` sorted by ``(a, b)``; ``sums[i]`` is the total
    weight of pair ``(ua[i], ub[i])``.  The strategy rewrites build every
    gather/inter/scatter message set with it.  ``a`` and ``b`` must be
    non-negative integers.
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    if a.size == 0:
        return a, b, w
    span = np.int64(b.max()) + 1
    uk, inv = np.unique(a * span + b, return_inverse=True)
    sums = np.bincount(inv, weights=w)
    return (uk // span).astype(np.int64), (uk % span).astype(np.int64), sums


def segmented_arange(counts) -> np.ndarray:
    """``[0..counts[0]), [0..counts[1]), ...`` concatenated (host numpy) —
    the rank of each expanded element within its segment."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total) - np.repeat(offsets, counts)


def group_by_receiver(dst, n_procs: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable grouping of message indices by destination process ``dst``.

    Returns ``(order, bounds)``: ``order[bounds[p]:bounds[p+1]]`` are the
    indices of messages destined to process ``p`` (of ``n_procs``), in
    posting (array) order.
    """
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    bounds = np.searchsorted(dst[order], np.arange(n_procs + 1))
    return order, bounds


# -- grouped receive-queue accounting ---------------------------------------

def flat_orders(orders):
    """Normalize a per-slot order spec to flat ``(slots, lens, ids)`` form.

    ``orders`` is either already flat — ``slots`` strictly increasing,
    ``ids`` the concatenated per-slot permutations of global message indices
    in slot order, ``lens`` their lengths — or a dict mapping each slot to
    its permutation.  Returns None when there is nothing custom.
    """
    if orders is None:
        return None
    if isinstance(orders, tuple):
        slots, lens, ids = orders
        slots = np.asarray(slots, dtype=np.int64)
        if slots.size == 0:
            return None
        return (slots, np.asarray(lens, dtype=np.int64),
                np.asarray(ids, dtype=np.int64))
    if not orders:
        return None
    pairs = sorted((int(s), np.asarray(v, dtype=np.int64))
                   for s, v in orders.items())
    return (np.asarray([s for s, _ in pairs], dtype=np.int64),
            np.asarray([v.size for _, v in pairs], dtype=np.int64),
            np.concatenate([v for _, v in pairs]))


def _assemble_orders(flat, slots, counts, cbounds, local, group,
                     describe) -> np.ndarray:
    """Region-local permutation array for every custom slot, in slot order.

    ``flat`` is a normalized :func:`flat_orders` spec (or None); slots it
    does not cover — and covered slots outside the custom set ``slots`` —
    default to array order.  Assembly and validation (length, destination,
    permutation) are single vectorized passes.
    """
    out = segmented_arange(counts)                    # default: array order
    if flat is None:
        return out
    pslots, lens, ids_cat = flat
    keep = np.isin(pslots, slots, assume_unique=True)
    if not keep.all():
        sel = np.repeat(keep, lens)
        pslots, lens, ids_cat = pslots[keep], lens[keep], ids_cat[sel]
    if pslots.size == 0:
        return out
    rank = np.searchsorted(slots, pslots)             # position among customs
    bad = np.nonzero(lens != counts[rank])[0]
    if bad.size:
        raise ValueError(
            f"order for {describe(int(pslots[bad[0]]))} must be a "
            f"permutation of the {int(counts[rank[bad[0]]])} message "
            f"indices destined to it")
    slot_rep = np.repeat(pslots, lens)
    rank_rep = np.repeat(rank, lens)
    pos = cbounds[rank_rep] + segmented_arange(lens)
    ok = group[ids_cat] == slot_rep           # ids destined to another slot?
    if not ok.all():
        bad = int(np.argmax(~ok))
        raise ValueError(
            f"order for {describe(int(slot_rep[bad]))} must be a "
            f"permutation of the message indices destined to it")
    vals = local[ids_cat]                     # in [0, counts[slot]) given ok
    hits = np.bincount(cbounds[rank_rep] + vals, minlength=int(cbounds[-1]))
    if hits.max(initial=0) > 1:
        bad = int(np.argmax(hits[cbounds[rank_rep] + vals] > 1))
        raise ValueError(
            f"order for {describe(int(slot_rep[bad]))} must be a "
            f"permutation of the message indices destined to it")
    out[pos] = vals
    return out


def grouped_queue_steps(group, n_slots, recv_post_order=None,
                        arrival_order=None, groups=None, describe=None,
                        device=None) -> torch.Tensor:
    """Exact receive-queue traversal-step totals for ``n_slots`` receiver
    slots, as an int64 tensor on ``device`` (``None`` means CUDA; the host
    runs only with ``device="cpu"``).

    ``group[i]`` (host numpy) is the receiver slot of message ``i`` (a
    process id, or a packed ``(phase, process)`` key for a stacked sweep).
    The order specs — ``recv_post_order`` (posting order) and
    ``arrival_order`` (envelope-arrival order) — give each custom slot a
    permutation of the global indices of its messages, as a dict or in the
    flat :func:`flat_orders` form; other slots use array order (one step per
    arrival).  The custom permutations are assembled and validated on the
    host; all custom slots then pay the exact Fenwick walk in one call of
    :func:`repro_torch.kernels.comm_stack.queue_walk` on ``device``.
    ``groups`` optionally supplies a precomputed ``(order, bounds)`` stable
    grouping; ``describe`` renders a slot id in error messages.
    """
    device = resolve_device(device)
    group = np.asarray(group, dtype=np.int64)
    if describe is None:
        describe = "receiver {}".format
    if groups is not None:
        order, bounds = groups
    else:
        order, bounds = group_by_receiver(group, n_slots)
    counts = np.diff(bounds)
    qsteps = torch.as_tensor(counts, dtype=torch.int64).to(device)
    if group.size == 0:
        return qsteps
    post = flat_orders(recv_post_order)
    arr = flat_orders(arrival_order)
    if post is None and arr is None:
        return qsteps
    cand = (post[0] if arr is None else
            arr[0] if post is None else np.union1d(post[0], arr[0]))
    cand = cand[(cand >= 0) & (cand < n_slots)]
    slots = cand[counts[cand] > 0]                    # silent slots excluded
    if slots.size == 0:
        return qsteps
    # local index of every message within its slot's group
    local = np.empty(group.size, dtype=np.int64)
    local[order] = np.arange(group.size) - np.repeat(bounds[:-1], counts)
    ccounts = counts[slots]
    cbounds = np.concatenate([[0], np.cumsum(ccounts)])
    posted = _assemble_orders(post, slots, ccounts, cbounds, local, group,
                              describe)
    arrive = _assemble_orders(arr, slots, ccounts, cbounds, local, group,
                              describe)
    steps = ks.queue_walk(*(torch.from_numpy(a).to(device)
                            for a in (posted, arrive, cbounds)))
    # per-slot totals: differences of the running sum at region ends
    run = torch.cumsum(steps, 0)
    ends = torch.from_numpy(cbounds[1:] - 1).to(device)
    tot = run[ends]
    tot[1:] -= tot[:-1].clone()
    qsteps[torch.from_numpy(slots).to(device)] = tot
    return qsteps


# -- receive-queue walk oracle -----------------------------------------------

class _Fenwick:
    """Binary indexed tree over n slots holding 0/1 'still unmatched' flags."""

    def __init__(self, n: int):
        self.n = n
        idx = np.arange(n + 1, dtype=np.int64)
        self.t = idx & -idx          # prefix tree of all-ones
        self.t[0] = 0

    def _add(self, i: int, v: int) -> None:
        while i <= self.n:
            self.t[i] += v
            i += i & -i

    def prefix(self, i: int) -> int:
        s = 0
        while i > 0:
            s += self.t[i]
            i -= i & -i
        return int(s)

    def remove(self, i: int) -> None:
        self._add(i, -1)


def queue_traversal_steps(posted_order, arrival_order) -> np.ndarray:
    """Exact queue-walk lengths for one receiving process (scalar reference).

    ``posted_order[k]`` = message id posted k-th; ``arrival_order[j]`` =
    message id of the j-th arriving envelope.  Returns steps per arrival: the
    1-based position of the match in the still-unmatched posted queue.  The
    test oracle for both versions of K2.
    """
    posted_order = np.asarray(posted_order)
    n = len(posted_order)
    pos = np.empty(n, dtype=np.int64)
    pos[posted_order] = np.arange(n)
    fen = _Fenwick(n)
    steps = np.empty(n, dtype=np.int64)
    for j, mid in enumerate(np.asarray(arrival_order)):
        p = int(pos[mid]) + 1               # 1-based slot
        steps[j] = fen.prefix(p)            # unmatched entries at/before slot
        fen.remove(p)
    return steps
