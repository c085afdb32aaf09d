"""Expert parallelism with explicit all-to-all (counterpart of
``repro.parallel.ep_a2a``).

The baseline MoE (:mod:`repro_torch.nn.moe`) builds one global [E, C, d]
capacity buffer; laid out over the model axis, its scatter and gather
around the expert-sharded products become all-gathers whose message
pattern the paper's queue-search term punishes (many strided transfers).
This module is the classic alternative: each rank of the expert axis
routes its tokens into its own buffer and two ``all_to_all_single``
exchanges move the slots to their experts' ranks and back — each rank
sends exactly one message per peer per direction, the minimal-message-
count schedule the paper's model favors (:mod:`repro_torch.workloads.moe`
prices it).

Semantics match ``moe_ffn`` with per-rank capacity (tokens over a rank's
capacity are dropped).  ``x`` is replicated over the axis, as in the
reference, so every rank routes every token and each rank's experts
compute the same slots once for each of the M ranks.
"""
from __future__ import annotations

import torch

from repro_torch.nn import moe as nn_moe
from repro_torch.nn.config import ArchConfig

from .collectives import (all_to_all, axis_group, axis_index, axis_size,
                          rank_rows)


def _local_dispatch(xf: torch.Tensor, logits: torch.Tensor, cfg: ArchConfig,
                    E_total: int, C: int):
    """Route local tokens ``xf`` [T, d] by ``logits`` [T, E] into a
    per-expert capacity buffer [E_total, C, d]: the router's top-k
    (:func:`repro_torch.nn.moe.top_k`), then the stably sorted assignments
    gathered into each expert's first ``C`` slots
    (:func:`repro_torch.nn.moe.dispatch`).  Returns (buffer, the
    :class:`~repro_torch.nn.moe.Dispatch` plan of one group)."""
    _, gates, idx = nn_moe.top_k(logits, cfg.n_experts_active)
    buf, plan = nn_moe.dispatch(xf[None], idx[None], gates[None], C, E_total)
    return buf[0], plan


def moe_ffn_ep(x: torch.Tensor, p: dict, cfg: ArchConfig, mesh=None,
               axis_name: str = "model") -> torch.Tensor:
    """MoE layer with explicit expert-parallel all-to-all, called on every
    rank of ``mesh``'s axis ``axis_name`` (the default group when ``mesh``
    is None).

    x: [B, S, d], the same on every rank.  The expert weights ``w1``,
    ``w3``, ``w2`` are split on their leading E dim over the axis: whole
    tensors (the rank takes its rows) or DTensors placed ``Shard(0)`` (the
    rank takes its local shard).  Returns [B, S, d] on every rank.
    """
    group = axis_group(mesh, axis_name)
    M, r = axis_size(group), axis_index(group)
    E = cfg.n_experts
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} ranks")
    E_l = E // M
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    logits = xf.float() @ p["router"].float()
    # the reference's capacity, not rounded to 8 as nn.moe.capacity is
    # (workloads.moe.a2a_capacity prices the same formula)
    C = max(8, int(T * cfg.n_experts_active * cfg.capacity_factor // E) + 1)
    buf, plan = _local_dispatch(xf, logits, cfg, E, C)
    # [E, C, d] = [M, E_l, C, d] -> a2a: chunk j now holds rank j's slots
    # for MY experts -> [E_l, M * C, d]
    buf = all_to_all(buf, group)
    buf = buf.reshape(M, E_l, C, d).transpose(0, 1).reshape(E_l, M * C, d)
    out = nn_moe.experts(buf[None], {k: rank_rows(p[k], r, M)
                                     for k in ("w1", "w3", "w2")})[0]
    # reverse a2a: [E_l, M * C, d] -> [M, E_l, C, d] -> [E, C, d]
    out = all_to_all(out.reshape(E_l, M, C, d).transpose(0, 1), group)
    y = nn_moe.combine(out.reshape(1, E, C, d), plan, T)
    return y.reshape(B, S, d)
