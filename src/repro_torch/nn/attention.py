"""Grouped-query attention: full (prefill), cached decode and cross-attention
(counterpart of ``repro.nn.attention``).

Full self-attention runs through K4, :func:`repro_torch.kernels.ops.mha_flash`,
for every sequence length, causal or not: the hand-written kernel on the
card, its plain version on CPU tensors.  One-token decode against the cache
(bf16, or int8 with per-(position, kv head) scales under ``cfg.kv_quant``)
and whisper's cross-attention, whose queries and keys differ in length,
stay plain torch, as they stay plain jnp in the reference: no TPU kernel
covers them.  RoPE is M-RoPE under ``cfg.m_rope`` (qwen2-vl).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.parallel.context import (head_local, is_dtensor,
                                          item_local, merge_dims, model_size,
                                          split_dim)

from .config import ArchConfig
from .layers import apply_m_rope, apply_rope, rmsnorm

NEG_INF = -1e30


def _project_qkv(x, p, cfg: ArchConfig):
    """q, k and v [B, S, heads, D]; under ``cfg.attention_multiplier`` q
    is scaled by it times sqrt(D), so that K4's and decode's 1 / sqrt(D)
    leaves the softmax scale the multiplier (one rounding of q more)."""
    B, S = x.shape[:2]
    hd = cfg.head_dim
    q = split_dim(x @ p["wq"], (B, S, cfg.n_heads, hd))
    k = split_dim(x @ p["wk"], (B, S, cfg.n_kv_heads, hd))
    v = split_dim(x @ p["wv"], (B, S, cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.attention_multiplier:
        q = q * (cfg.attention_multiplier * hd ** 0.5)
    return q, k, v


def _rope_qk(q, k, positions, cfg: ArchConfig):
    rope = apply_m_rope if cfg.m_rope else apply_rope
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta))


def quantize_kv(t: torch.Tensor):
    """int8 cache entries of k or v ``t`` [..., KH, D]: returns (int8
    values, float32 scales [..., KH]), a scale of max|t| / 127 over the
    head dim (at least 1e-8), values rounded half to even and clipped to
    +-127, as the reference's decode quantises."""
    tf = t.float()
    s = (tf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(tf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _flash(q, k, v, causal: bool):
    """K4 on q, k, v; DTensors through :func:`_heads_local`."""
    def run(q, k, v):
        B, S, H, D = q.shape
        with obs.span("repro_torch.attn_core", B=B, S=S, H=H, KH=k.shape[2],
                      D=D, causal=bool(causal)):
            return ops.mha_flash(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal)

    return _heads_local(run, q, k, v) if is_dtensor(q) else run(q, k, v)


def _heads_local(core, q, k, v):
    """``core`` on DTensors q [B, Sq, H, D] and k/v [B, Sk, KH, D] rank by
    rank, each rank on its heads where the model axis splits them
    (:func:`head_local`).  Where the query heads split and the kv heads do
    not (fewer kv heads than ranks), each kv head is repeated for its
    share of ranks first, which leaves every query head reading its own kv
    head.  Where the heads do not split, each (row, kv head) item of a
    data shard goes to one model rank in turn (:func:`item_local`), so
    that no rank attends what another does."""
    H, KH = q.shape[2], k.shape[2]
    tp = model_size(q)
    if H % tp == 0 and KH % tp and tp % KH == 0:
        g = tp // KH
        B, S, _, D = k.shape
        k, v = (t[:, :, :, None, :].expand(B, S, KH, g, D)
                .reshape(B, S, KH * g, D) for t in (k, v))
        KH = KH * g
    if H % tp == 0 and KH % tp == 0:
        return head_local(core, (q, k, v), (2, 2, 2), (2,))
    return item_local(lambda r, n, q, k, v: _items(core, r, n, q, k, v),
                      (q, k, v), (True, True, True), 1)


def _items(core, rank: int, ranks: int, q, k, v):
    """``core`` on this rank's (row, kv head) items, ``rank``, ``rank +
    ranks``, ...: batched as rows of one kv head and its query heads, the
    output zero but for them."""
    b, sq, H, D = q.shape
    KH = k.shape[2]
    items = torch.arange(rank, max(rank, b * KH), ranks, device=q.device)
    rows, heads = items // KH, items % KH
    out = q.new_zeros(b, sq, KH, H // KH, D)
    if len(items):
        out[rows, :, heads] = core(
            q.reshape(b, sq, KH, H // KH, D)[rows, :, heads],
            k[rows, :, heads][:, :, None], v[rows, :, heads][:, :, None])
    return out.reshape(b, sq, H, D)


def attention(x, p, cfg: ArchConfig, positions, causal: bool = True):
    """Full self-attention (prefill): returns (out [B, S, d], (k, v)), with
    ``k`` after RoPE, as the decode cache holds it.  ``positions`` is
    [B, S], or [B, S, 3] under M-RoPE."""
    with obs.span("repro_torch.attention"):
        q, k, v = _project_qkv(x, p, cfg)
        if cfg.rope_theta:
            q, k = _rope_qk(q, k, positions, cfg)
        out = merge_dims(_flash(q, k, v, causal), 2)
        return out @ p["wo"], (k, v)


def decode_attention(x, p, cfg: ArchConfig, cache_k, cache_v, pos: int,
                     k_scale=None, v_scale=None):
    """One-token decode against the KV cache.

    x: [B, 1, d]; cache_k/v: [B, S_max, KH, D]; pos: the current position.
    Under ``cfg.kv_quant`` the cache is int8 and ``k_scale``/``v_scale``
    [B, S_max, KH] hold its float32 scales (:func:`quantize_kv`).  Writes
    this token's entries into the cache (and scales) at ``pos`` in place
    (the reference returns updated copies; the port saves the copy of the
    whole cache every layer and step) and returns (out [B, 1, d], cache_k,
    cache_v[, k_scale, v_scale]).  The arithmetic follows the reference's
    dtypes: scores in the promoted dtype of q and the keys, then float32
    for the softmax, weights cast to the values' dtype.  The int8 cache
    reads its keys as float32 and its values as bf16, whatever the
    model's dtype.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.rope_theta:
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=x.device)
        if cfg.m_rope:
            positions = positions[..., None].expand(B, 1, 3)
        q, k = _rope_qk(q, k, positions, cfg)
    scales = (k_scale, v_scale) if cfg.kv_quant else ()
    if is_dtensor(cache_k):
        out = _decode_laid_out(q, k, v, cache_k, cache_v, k_scale, v_scale,
                               pos, cfg, x.dtype)
    else:
        out = _decode_core(q, k, v, cache_k, cache_v, k_scale, v_scale, pos,
                           cfg, x.dtype)
    return (out @ p["wo"], cache_k, cache_v) + scales


def _decode_core(q, k, v, ck, cv, ks, vs, pos: int, cfg: ArchConfig, dtype,
                 mode=None, rank: int = 0, reduce=None, gather=None):
    """The token's cache write and its attention: q [B, 1, H, D], k/v [B,
    1, KH, D] against the cache ``ck``/``cv`` [B, S, KH, D] (and under
    ``cfg.kv_quant`` the scales ``ks``/``vs`` [B, S_max, KH]); returns
    out [B, 1, H * D] in ``dtype``.  With a ``mode`` the cache is rank
    ``rank``'s shard, split over the model axis by kv heads (``"heads"``),
    head dim (``"dim"``: partial scores summed by ``reduce``, the output
    joined by ``gather``) or sequence (``"seq"``: the softmax's max and
    sum and the output summed by ``reduce``); the scales are whole
    along the sequence."""
    B, S = ck.shape[:2]
    D = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    s0 = rank * S if mode == "seq" else 0
    d0, dl = (rank * ck.shape[3], ck.shape[3]) if mode == "dim" else (0, D)
    if mode == "heads":
        h0, hl = rank * ck.shape[2], ck.shape[2]
        q = q[:, :, h0 * rep:(h0 + hl) * rep]
        k, v = k[:, :, h0:h0 + hl], v[:, :, h0:h0 + hl]
    at = pos - s0
    if cfg.kv_quant:
        (kq, kss), (vq, vss) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
        ks[:, pos], vs[:, pos] = kss, vss
        if 0 <= at < S:
            ck[:, at] = kq[..., d0:d0 + dl]
            cv[:, at] = vq[..., d0:d0 + dl]
        kl, vl = ks[:, s0:s0 + S], vs[:, s0:s0 + S]
        k_eff = ck.float() * kl[..., None]
        v_eff = (cv.float() * vl[..., None]).bfloat16()
    else:
        if 0 <= at < S:
            ck[:, at] = k[:, 0, :, d0:d0 + dl].to(ck.dtype)
            cv[:, at] = v[:, 0, :, d0:d0 + dl].to(cv.dtype)
        k_eff, v_eff = ck, cv
    qg = q[..., d0:d0 + dl].reshape(B, 1, ck.shape[2], rep, dl)
    dt = torch.promote_types(qg.dtype, k_eff.dtype)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.to(dt),
                          k_eff.to(dt)).float()
    if mode == "dim":
        scores = reduce(scores, "sum")
    scores = scores / D ** 0.5
    valid = torch.arange(s0, s0 + S, device=ck.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    if mode == "seq":
        m = reduce(scores.amax(-1, keepdim=True), "max")
        e = torch.exp(scores - m)
        w = (e / reduce(e.sum(-1, keepdim=True), "sum")).to(v_eff.dtype)
        # the partial outputs add in float32, rounded once after
        out = reduce(torch.einsum("bhrqk,bkhd->bqhrd", w.float(),
                                  v_eff.float()), "sum").to(v_eff.dtype)
    else:
        w = torch.softmax(scores, dim=-1).to(v_eff.dtype)
        out = torch.einsum("bhrqk,bkhd->bqhrd", w, v_eff)
    if mode == "dim":
        out = gather(out)
    return out.reshape(B, 1, -1).to(dtype)


def _decode_laid_out(q, k, v, cache_k, cache_v, k_scale, v_scale, pos: int,
                     cfg: ArchConfig, dtype):
    """:func:`_decode_core` on a cache of DTensors laid out by
    ``cache_pspecs``, rank by rank (``local_map``): each rank writes its
    part of the token's entries into its cache shard and attends with it,
    the model axis splitting the kv heads (each rank its heads), the head
    dim (partial scores summed over the axis, the output gathered) or the
    sequence (flash-decoding).  Returns out [B, 1, H * D], split by heads
    over the model axis in the first case, else whole."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = cache_k.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    pl = tuple(cache_k.placements)
    mode = None
    if mi is not None and isinstance(pl[mi], Shard):
        mode = {2: "heads", 3: "dim", 1: "seq"}[pl[mi].dim]
    rank = mesh.get_local_rank(mi) if mode else 0
    group = (mesh, mi)
    tok_pl = tuple(Shard(0) if i != mi and p == Shard(0) else Replicate()
                   for i, p in enumerate(pl))
    out_pl = tuple(Shard(2) if i == mi and mode == "heads" else p
                   for i, p in enumerate(tok_pl))

    def waited(t):
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) \
            else t

    def reduce(t, op):
        return waited(funcol.all_reduce(t, op, group))

    def gather(t):
        join = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
        return waited(join(t.contiguous(), t.ndim - 1, group))

    def core(q, k, v, ck, cv, ks, vs):
        return _decode_core(q, k, v, ck, cv, ks, vs, pos, cfg, dtype, mode,
                            rank, reduce, gather)

    scale_pl = tuple(k_scale.placements) if cfg.kv_quant else None
    ks, vs = (k_scale, v_scale) if cfg.kv_quant else (None, None)
    mapped = local_map(core, out_placements=(out_pl,),
                       in_placements=(tok_pl, tok_pl, tok_pl, pl, pl,
                                      scale_pl, scale_pl),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(q, k, v, cache_k, cache_v, ks, vs)


def cross_attention(x, p, cfg: ArchConfig, enc_out):
    """Decoder cross-attention onto the encoder's output (whisper): x
    [B, Sq, d] against enc_out [B, Sk, d], no mask and no RoPE, plain torch
    with the reference's dtypes (scores in the inputs' dtype, the softmax
    in float32, weights cast back)."""
    B, Sq, _ = x.shape
    Sk = enc_out.shape[1]
    KH, D = cfg.n_kv_heads, cfg.head_dim
    q = split_dim(x @ p["wq"], (B, Sq, cfg.n_heads, D))
    k = split_dim(enc_out @ p["wk"], (B, Sk, KH, D))
    v = split_dim(enc_out @ p["wv"], (B, Sk, KH, D))

    def core(q, k, v):
        b, sq, h, _ = q.shape
        qg = q.reshape(b, sq, k.shape[2], h // k.shape[2], D)
        scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() / D ** 0.5
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhrqk,bkhd->bqhrd", w, v).reshape(b, sq, h, D)

    out = _heads_local(core, q, k, v) if is_dtensor(q) else core(q, k, v)
    return merge_dims(out, 2) @ p["wo"]
