"""Mixture-of-experts layer: top-k router and capacity-buffer dispatch
(counterpart of ``repro.nn.moe``).

Dispatch is sort-based, as in the reference: the (token, expert)
assignments are sorted by expert with a stable sort, each expert's first
``C`` of them gathered into an ``[E, C, d]`` capacity buffer, the experts'
SwiGLU run as batched products, and each kept assignment's output gathered
back, weighted by its gate and added to its token in the activations'
dtype.  Assignments past an expert's capacity are dropped, as in
GShard/Switch.  Every step is plain torch, as it is plain jnp in the
reference, which has no Pallas kernel here; the expert products are
``torch.bmm``.

The reference routes D data shards at once (``_dp_groups``) and pins
layouts with sharding constraints (``_constrain``, ``_constrain_moe_buf``).
All three are the identity without a parallel context, which the port does
not have yet (ROADMAP queue item 13), so the port routes one group (D = 1)
and has none of them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import mlp

#: Tokens routed at once: more than this many, in a whole multiple of it,
#: are routed in chunks of this size, each with its own capacity.
MOE_CHUNK_TOKENS = 16384


def moe_param_shapes(cfg: ArchConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    shapes = {
        "router": (d, e),
        "w1": (e, d, f),    # gate
        "w3": (e, d, f),    # up
        "w2": (e, f, d),    # down
    }
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * f
        shapes.update({"shared_w1": (d, sf), "shared_w3": (d, sf),
                       "shared_w2": (sf, d)})
    return shapes


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots an expert has for ``n_tokens`` tokens: ``T K cf / E`` plus
    one, rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.n_experts_active * cfg.capacity_factor
            // cfg.n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig):
    """x: [b, s, d] -> ([b, s, d], aux_loss).

    More than ``MOE_CHUNK_TOKENS`` tokens, in a whole multiple of it, are
    routed one chunk after another, each chunk with its own capacity, and
    the aux loss is the chunks' mean, as in the reference.
    """
    b, s, d = x.shape
    T = b * s
    xf = x.reshape(T, d)
    if T > MOE_CHUNK_TOKENS and T % MOE_CHUNK_TOKENS == 0:
        sub = T // MOE_CHUNK_TOKENS
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for xc in xf.split(MOE_CHUNK_TOKENS):
            yc, a = _moe_tokens(xc, p, cfg)
            aux = aux + a / sub
            ys.append(yc)
        return torch.cat(ys).reshape(b, s, d), aux
    y, aux = _moe_tokens(xf, p, cfg)
    return y.reshape(b, s, d), aux


class Dispatch(NamedTuple):
    """Where each (token, expert) assignment goes, in expert-sorted order:
    ``order`` the stable sort of the flat ``[T * K]`` expert ids,
    ``tok`` each sorted assignment's token, ``slot`` its flat ``[E * C]``
    buffer slot (clipped), ``keep`` whether it fits the expert's capacity,
    ``counts`` the assignments of each expert."""
    order: torch.Tensor
    tok: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """Top-k routing of tokens ``xf`` [T, d] in float32: returns (gates
    [T, K] renormalised to sum 1, expert ids [T, K], aux loss).

    The experts are ranked by a stable descending sort of the softmax, so
    ties go to the lower expert id, as ``jax.lax.top_k`` breaks them.  The
    aux loss is Switch's ``E * sum_e mean(probs_e) * count_e / (T K)``.
    """
    E, K = cfg.n_experts, cfg.n_experts_active
    T = xf.shape[0]
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    ranked, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = ranked[:, :K], ids[:, :K]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    hits = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * K, device=xf.device))
    aux = E * torch.sum(probs.mean(dim=0) * (hits / (T * K)))
    return gates, idx, aux


def dispatch(xf: torch.Tensor, idx: torch.Tensor, C: int, E: int):
    """Gather tokens ``xf`` [T, d] into the ``[E, C, d]`` capacity buffer
    by their expert ids ``idx`` [T, K]: slot (e, c) holds the c-th
    assignment of expert e in the stably sorted list, zeros past its count.
    Returns (buffer, :class:`Dispatch`).  No device-to-host read."""
    T, K = idx.shape
    d = xf.shape[1]
    eflat = idx.reshape(-1)
    order = torch.argsort(eflat, stable=True)
    e_sorted = eflat[order]
    tok = order // K
    counts = torch.zeros(E, dtype=torch.long, device=xf.device).scatter_add_(
        0, eflat, torch.ones_like(eflat))
    offsets = counts.cumsum(0) - counts
    rank = torch.arange(T * K, device=xf.device) - offsets[e_sorted]
    keep = rank < C
    gidx = offsets[:, None] + torch.arange(C, device=xf.device)[None, :]
    in_use = gidx < (offsets + counts.clamp(max=C))[:, None]
    gclip = gidx.clamp(0, T * K - 1).reshape(-1)
    buf = torch.where(in_use.reshape(-1, 1), xf[tok[gclip]], 0)
    slot = (e_sorted * C + rank).clamp(0, E * C - 1)
    return buf.reshape(E, C, d), Dispatch(order, tok, slot, keep, counts)


def experts(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: [E, C, d] -> [E, C, d], the
    gate's silu in float32, as in the reference."""
    gate = torch.bmm(buf, p["w1"])
    up = torch.bmm(buf, p["w3"])
    h = F.silu(gate.float()).to(buf.dtype) * up
    return torch.bmm(h, p["w2"])


def combine(out_buf: torch.Tensor, gates: torch.Tensor, plan: Dispatch,
            T: int) -> torch.Tensor:
    """Each kept assignment's expert output times its gate, added to its
    token in the activations' dtype: [E, C, d] -> [T, d]."""
    E, C, d = out_buf.shape
    dtype = out_buf.dtype
    gathered = out_buf.reshape(E * C, d)[plan.slot]
    g_sorted = gates.reshape(-1)[plan.order].to(dtype)
    contrib = torch.where(plan.keep[:, None], gathered * g_sorted[:, None], 0)
    return torch.zeros(T, d, dtype=dtype, device=out_buf.device).index_add_(
        0, plan.tok, contrib)


def _moe_tokens(xf: torch.Tensor, p: dict, cfg: ArchConfig):
    """Routed (and shared) experts on one group of tokens [T, d]."""
    T = xf.shape[0]
    gates, idx, aux = route(xf, p["router"], cfg)
    buf, plan = dispatch(xf, idx, capacity(T, cfg), cfg.n_experts)
    y = combine(experts(buf, p), gates, plan, T)
    if cfg.n_shared_experts:
        y = y + mlp(xf, {"w1": p["shared_w1"], "w3": p["shared_w3"],
                         "w2": p["shared_w2"]}, "swiglu")
    return y, aux
