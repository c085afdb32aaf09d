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
einsums over the buffer.

An expert layer may hold a share of the router's experts (expert
parallelism's local half: ``cfg.n_experts`` experts from
``cfg.expert_first`` on, of ``cfg.n_router_experts``): it routes over all
of them, its capacity buffer holds its own experts only, and assignments
to experts held elsewhere go to no slot; the shared experts run whole.
The exchange that would bring other ranks' tokens is
:mod:`repro_torch.parallel.ep_a2a`'s.

The tokens are routed in D groups at once, as the reference routes them:
one group a data shard under a parallel context
(:mod:`repro_torch.parallel.context`, ``_dp_groups``), else D = 1.  Each
group sorts its own assignments along an unsharded dim and gets its own
capacity from its own token count, so the results depend on D.
``_constrain`` and ``_constrain_moe_buf`` pin the groups and the ``[D, E,
C, d]`` capacity buffer to the data axes, the experts to the model axis
(expert parallelism); with no context they are the identity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.parallel import context as pctx

from .config import ArchConfig
from .layers import mlp

#: Tokens routed at once: more than this many, in a whole multiple of it,
#: are routed in chunks of this size, each with its own capacity.
MOE_CHUNK_TOKENS = 16384


def moe_param_shapes(cfg: ArchConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    shapes = {
        "router": (d, cfg.n_router_experts),
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
    """Slots an expert has for ``n_tokens`` tokens: ``T K cf / E`` (``E``
    the router's experts) plus one, rounded up to a multiple of 8, at
    least 8."""
    c = int(n_tokens * cfg.n_experts_active * cfg.capacity_factor
            // cfg.n_router_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


def _dp_groups(b: int) -> tuple[int, object]:
    """Number of data shards D dividing the batch, and the dp spec (or
    None); (1, None) with no parallel context.

    Routing and dispatch are batched over data shards so every gather and
    scatter carries a leading D dim laid out over the dp axes."""
    ctx = pctx.current()
    if ctx is None:
        return 1, None
    sizes = pctx.axis_sizes(ctx.mesh)
    spec = pctx.dp_spec(sizes, ctx.dp_axes, b)
    if spec is None:
        return 1, None
    axes = spec if isinstance(spec, tuple) else (spec,)
    D = 1
    for a in axes:
        D *= sizes[a]
    return D, spec


def _constrain(t, parts):
    """``t`` laid out by ``parts`` under a parallel context (a DTensor
    redistributed); else ``t``."""
    return pctx.constrain(t, parts)


def _constrain_moe_buf(buf, dp_spec):
    """Pin the capacity buffer [D, E, C, d] to (dp, model-on-E) so the
    expert products run expert-parallel."""
    ctx = pctx.current()
    if ctx is None:
        return buf
    E = buf.shape[1]
    tp = pctx.axis_sizes(ctx.mesh)[ctx.model_axis]
    e_ax = ctx.model_axis if E % tp == 0 else None
    return pctx.constrain(buf, (dp_spec, e_ax, None, None))


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig):
    """x: [b, s, d] -> ([b, s, d], aux_loss).

    The tokens route in D groups (``_dp_groups``: one a data shard under a
    parallel context, else D = 1), each group on its own.  More than
    ``MOE_CHUNK_TOKENS`` tokens a group, in a whole multiple of it, are
    routed one chunk after another, each chunk with its own capacity, and
    the aux loss is the chunks' mean, as in the reference.
    """
    b, s, d = x.shape
    D, dp_spec = _dp_groups(b)
    T = (b * s) // D                                  # tokens per group
    x = _constrain(x, (dp_spec, None, None))
    if T > MOE_CHUNK_TOKENS and T % MOE_CHUNK_TOKENS == 0:
        sub = T // MOE_CHUNK_TOKENS
        xr = pctx.reshape_rows(x, (D, sub, MOE_CHUNK_TOKENS, d))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for j in range(sub):
            yc, a = _moe_groups(xr[:, j], p, cfg, dp_spec)
            aux = aux + a / sub
            ys.append(_constrain(yc, (dp_spec, None, None)))
        y = pctx.reshape_rows(torch.stack(ys, dim=1), (b, s, d))
    else:
        y, aux = _moe_groups(pctx.reshape_rows(x, (D, T, d)), p, cfg,
                             dp_spec)
        y = pctx.reshape_rows(y, (b, s, d))
    if cfg.n_shared_experts and pctx.is_dtensor(x):
        with obs.span("repro_torch.moe.shared"):
            y = y + _shared(x, p)
    return y, aux


class Dispatch(NamedTuple):
    """Where each (token, expert) assignment of each group goes, in
    expert-sorted order, every field [D, T * K] but ``counts`` [D, E]:
    ``order`` the stable sort of the group's flat expert ids, ``tok``
    each sorted assignment's token, ``slot`` its flat ``[E * C]`` buffer
    slot (clipped), ``keep`` whether it fits the expert's capacity,
    ``gates`` its gate, ``counts`` the assignments of each expert."""
    order: torch.Tensor
    tok: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    counts: torch.Tensor


def top_k(logits: torch.Tensor, K: int):
    """The router's choice from its logits [..., E]: (the softmax in
    float32 [..., E], the top ``K`` gates renormalised to sum 1 [..., K],
    their expert ids [..., K]).

    The experts are ranked by a stable descending sort of the softmax, so
    ties go to the lower expert id, as ``jax.lax.top_k`` breaks them."""
    probs = torch.softmax(logits.float(), dim=-1)
    ranked, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = ranked[..., :K], ids[..., :K]
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def route(xf: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """Top-k routing of token groups ``xf`` [D, T, d] in float32
    (:func:`top_k`) over the router's ``E`` experts: returns (gates [D,
    T, K] renormalised to sum 1, expert ids [D, T, K], the router
    probabilities summed over every token [E], the assignments of each
    expert over every group [E])."""
    E, K = cfg.n_router_experts, cfg.n_experts_active
    probs, gates, idx = top_k(xf.float() @ router.float(), K)
    experts_ = torch.arange(E, device=xf.device)
    hits = (idx.reshape(-1)[:, None] == experts_).sum(0).float()
    return gates, idx, probs.sum(dim=(0, 1)), hits


def aux_loss(prob_sum, hits, n_tokens: int, cfg: ArchConfig):
    """Switch's load-balance loss ``E * sum_e mean(probs_e) * count_e /
    (T K)`` over ``n_tokens`` tokens, from :func:`route`'s sums."""
    E, K = cfg.n_router_experts, cfg.n_experts_active
    return E * torch.sum(prob_sum / n_tokens * (hits / (n_tokens * K)))


def dispatch(xf: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
             C: int, E: int, first: int = 0):
    """Gather token groups ``xf`` [D, T, d] into the ``[D, E, C, d]``
    capacity buffer by their expert ids ``idx`` [D, T, K]: slot (e, c) of
    a group holds the c-th assignment of expert e in the group's stably
    sorted list (a sort along the group's own dim), zeros past its count.
    The buffer's experts are the router's ``first`` to ``first + E - 1``:
    an assignment to any other expert (held elsewhere) takes no slot
    (``keep`` false; it sorts after every held one).
    Returns (buffer, :class:`Dispatch`).  No device-to-host read."""
    D, T, K = idx.shape
    d = xf.shape[-1]
    eflat = idx.reshape(D, T * K) - first
    eflat = torch.where((eflat >= 0) & (eflat < E), eflat, E)
    order = torch.argsort(eflat, dim=-1, stable=True)
    e_sorted = torch.gather(eflat, 1, order)
    tok = order // K
    experts_ = torch.arange(E, device=xf.device)
    counts = (eflat[..., None] == experts_).sum(1)             # [D, E]
    offsets = counts.cumsum(-1) - counts
    ends = F.pad(offsets, (0, 1), value=T * K)           # E: past the end
    rank = (torch.arange(T * K, device=xf.device)[None, :]
            - torch.gather(ends, 1, e_sorted))
    keep = (rank < C) & (e_sorted < E)
    gidx = offsets[:, :, None] + torch.arange(C, device=xf.device)
    in_use = gidx < (offsets + counts.clamp(max=C))[:, :, None]
    gclip = gidx.clamp(0, T * K - 1).reshape(D, E * C)
    xs = torch.gather(xf, 1, tok[..., None].expand(D, T * K, d))
    buf = torch.gather(xs, 1, gclip[..., None].expand(D, E * C, d))
    buf = torch.where(in_use.reshape(D, E * C)[..., None], buf, 0)
    slot = (e_sorted * C + rank).clamp(0, E * C - 1)
    g_sorted = torch.gather(gates.reshape(D, T * K), 1, order)
    return buf.reshape(D, E, C, d), Dispatch(order, tok, slot, keep,
                                             g_sorted, counts)


def combine(out_buf: torch.Tensor, plan: Dispatch, T: int) -> torch.Tensor:
    """Each kept assignment's expert output [D, E, C, d] gathered back,
    times its gate, added to its token in the activations' dtype: [D, T,
    d]."""
    D, E, C, d = out_buf.shape
    TK = plan.slot.shape[1]
    dtype = out_buf.dtype
    gathered = torch.gather(out_buf.reshape(D, E * C, d), 1,
                            plan.slot[..., None].expand(D, TK, d))
    contrib = torch.where(plan.keep[..., None],
                          gathered * plan.gates[..., None].to(dtype), 0)
    y = torch.zeros(D, T, d, dtype=dtype, device=out_buf.device)
    return y.scatter_add(1, plan.tok[..., None].expand(D, TK, d), contrib)


def _route_and_dispatch(xf, router, cfg: ArchConfig, C: int):
    """:func:`route` then :func:`dispatch` into the buffer of the experts
    this layer holds: (buffer, the plan's fields, the probability sum, the
    hits)."""
    with obs.span("repro_torch.moe.route"):
        gates, idx, prob_sum, hits = route(xf, router, cfg)
    with obs.span("repro_torch.moe.dispatch"):
        buf, plan = dispatch(xf, idx, gates, C, cfg.n_experts,
                             cfg.expert_first)
    return (buf, *plan, prob_sum, hits)


def _moe_groups(xf: torch.Tensor, p: dict, cfg: ArchConfig, dp_spec):
    """Routed (and shared) experts for [D, T, d] token groups: top-k
    routing, a stable sort of each group's assignments by expert along its
    own (unsharded) dim, gathers into the [D, E, C, d] capacity buffer
    (``C`` from ``T``), the experts' SwiGLU, and a gather-combine back,
    the reference's ``_moe_groups`` op for op.  DTensor groups route and
    combine rank by rank (``local_map``), the buffer's experts split over
    the model axis for the expert products and gathered back for the
    combine; their shared experts run in :func:`moe_ffn`.

    While recording (:mod:`repro_torch.obs`) plain groups count the
    assignments routed (``moe.assignments``, D T K), those to experts held
    here (``moe.local``, on the device),
    the buffer's rows (``moe.slots``, D E C, E the experts held) and the
    assignments that found a slot (``moe.kept``, on the device); DTensor
    groups count nothing."""
    D, T, d = xf.shape
    C = capacity(T, cfg)
    if pctx.is_dtensor(xf):
        return _moe_groups_laid_out(xf, p, cfg, dp_spec, C)
    buf, *plan, prob_sum, hits = _route_and_dispatch(xf, p["router"], cfg, C)
    if obs.on():
        counts = Dispatch(*plan).counts
        obs.count("moe.assignments", D * T * cfg.n_experts_active)
        obs.count("moe.local", counts.sum())
        obs.count("moe.slots", D * cfg.n_experts * C)
        obs.count("moe.kept", counts.clamp(max=C).sum())
    aux = aux_loss(prob_sum, hits, D * T, cfg)
    with obs.span("repro_torch.moe.experts"):
        out_buf = experts(_constrain_moe_buf(buf, dp_spec), p)
    with obs.span("repro_torch.moe.combine"):
        y = combine(out_buf, Dispatch(*plan), T)
    if cfg.n_shared_experts:
        with obs.span("repro_torch.moe.shared"):
            y = y + _shared(xf, p)
    return y, aux


def _shared(x, p: dict):
    """The shared experts' SwiGLU on tokens [..., d]."""
    return mlp(x, {"w1": p["shared_w1"], "w3": p["shared_w3"],
                   "w2": p["shared_w2"]}, "swiglu")


def _moe_groups_laid_out(xf, p: dict, cfg: ArchConfig, dp_spec, C: int):
    """:func:`_moe_groups`' routed experts on DTensor groups [D, T, d]
    (laid out over the data axes, whole over the model axis)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    D, T, d = xf.shape
    mesh = xf.device_mesh
    x_pl = tuple(xf.placements)
    rep = tuple(Replicate() for _ in x_pl)
    summed = tuple(Partial() if p != Replicate() else p for p in x_pl)
    split = tuple(p != Replicate() for p in x_pl)
    n_plan = len(Dispatch._fields)
    route_ = local_map(
        lambda x, r: _route_and_dispatch(x, r, cfg, C),
        out_placements=(x_pl,) * (1 + n_plan) + (summed, summed),
        in_placements=(x_pl, rep),
        in_grad_placements=pctx.grad_placements((x_pl, rep), split),
        device_mesh=mesh, redistribute_inputs=True)
    buf, *plan, prob_sum, hits = route_(xf, p["router"])
    aux = aux_loss(prob_sum, hits, D * T, cfg)
    with obs.span("repro_torch.moe.experts"):
        out_buf = experts(_constrain_moe_buf(buf, dp_spec), p)
    combine_ = local_map(lambda b, *a: combine(b, Dispatch(*a), T),
                         out_placements=(x_pl,),
                         in_placements=(x_pl,) * (1 + n_plan),
                         device_mesh=mesh, redistribute_inputs=True)
    with obs.span("repro_torch.moe.combine"):
        return combine_(out_buf, *plan), aux


def experts(buf, p: dict):
    """Every expert's SwiGLU on the [D, E, C, d] buffer, the gate's silu
    in float32, as in the reference.  On DTensors each rank runs its own
    experts on its own groups (``local_map``): the weights whole over the
    data axes (an FSDP layout gathered), split over the model axis as the
    buffer's experts are."""
    def run(buf, w1, w3, w2):
        gate = torch.einsum("gecd,edf->gecf", buf, w1)
        up = torch.einsum("gecd,edf->gecf", buf, w3)
        h = F.silu(gate.float()).to(buf.dtype) * up
        return torch.einsum("gecf,efd->gecd", h, w2)

    ws = (p["w1"], p["w3"], p["w2"])
    if not pctx.is_dtensor(buf):
        return run(buf, *ws)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    b_pl = tuple(buf.placements)
    w_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in b_pl)
    in_pl = (b_pl, w_pl, w_pl, w_pl)
    split = tuple(p != Replicate() for p in b_pl)
    mapped = local_map(run, out_placements=(b_pl,), in_placements=in_pl,
                       in_grad_placements=pctx.grad_placements(in_pl, split),
                       device_mesh=buf.device_mesh, redistribute_inputs=True)
    return mapped(buf, *ws)
