"""The collectives the port's parallel programs are written against: one
mesh axis as a ``torch.distributed`` process group, its index, the
static permutation and the reductions (the port's stand-in for what the
reference takes from ``_jax_compat`` and ``jax.lax``).

Every function runs on whatever group the caller opened: NCCL with one
card a rank, gloo in host processes, or the threaded group of
:func:`repro_torch.launch.mesh.run_ranks`, whose ranks are threads of one
process and whose collectives are copies between their tensors (on the
card, copies on the device).  ``mesh=None`` means the default group.

:func:`ppermute` is one ``all_to_all_single`` with per-peer split sizes,
non-zero only towards the rank's destination and from its source: the one
point-to-point primitive all three groups run.  The threaded group has no
``send``/``recv``, so ``batch_isend_irecv`` cannot run there; NCCL lowers
the exchange to grouped ``ncclSend``/``ncclRecv`` and skips the peers
whose split is zero, so each rank still sends one message a round.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def axis_group(mesh=None, axis: str | None = None):
    """The process group of ``mesh``'s axis ``axis`` (a
    :class:`~torch.distributed.device_mesh.DeviceMesh`; ``axis`` may be
    None on a 1-D mesh), or the default group when ``mesh`` is None."""
    if mesh is None:
        return dist.group.WORLD
    return mesh.get_group(axis) if axis is not None else mesh.get_group()


def axis_size(group=None) -> int:
    """Ranks in ``group`` (None = the default group)."""
    return dist.get_world_size(group)


def axis_index(group=None) -> int:
    """This rank's index in ``group`` (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


def ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """``jax.lax.ppermute``: rank ``s`` of ``group`` sends ``x`` to ``d``
    for each ``(s, d)`` of ``perm``; a rank no pair sends to gets zeros.

    One ``all_to_all_single`` over ``x``'s leading dim, whose split sizes
    are ``x.shape[0]`` towards the rank's destination and from its source
    and 0 elsewhere.  Raises ``ValueError`` when a rank sends or receives
    twice."""
    n, me = axis_size(group), axis_index(group)
    srcs = [int(s) for s, _ in perm]
    dsts = [int(d) for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"{perm} is not a permutation: a rank sends or "
                         "receives twice")
    rows = x.shape[0]
    send, recv = [0] * n, [0] * n
    for s, d in zip(srcs, dsts):
        if s == me:
            send[d] = rows
        if d == me:
            recv[s] = rows
    x = x.contiguous()
    out = torch.zeros_like(x)
    # the buffers' leading dims must equal the splits' sums
    dist.all_to_all_single(out if any(recv) else out[:0],
                           x if any(send) else x[:0], recv, send,
                           group=group)
    return out


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.all_to_all`` with split and concat axis 0, untiled:
    ``x``'s leading dim (the group's size) is dealt out, chunk ``j`` to
    rank ``j``, and the result's chunk ``j`` came from rank ``j``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _reduced(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.psum``: ``x`` summed over ``group``, on every rank."""
    return _reduced(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.pmax``: the elementwise maximum over ``group``."""
    return _reduced(x, dist.ReduceOp.MAX, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order ``[n, *x.shape]``, on
    every rank."""
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def rank_rows(t: torch.Tensor, index: int, n: int) -> torch.Tensor:
    """Rank ``index``'s part of ``t`` split on its leading dim over ``n``
    ranks: the local shard of a DTensor (placed ``Shard(0)`` on that
    axis), else the ``index``-th of ``n`` equal row blocks of the whole
    tensor.  Raises ``ValueError`` when ``n`` does not divide the rows."""
    if isinstance(t, DTensor):
        return t.to_local()
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} ranks")
    k = t.shape[0] // n
    return t[index * k:(index + 1) * k]
