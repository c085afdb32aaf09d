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

from repro_torch.kernels import ops

from .config import ArchConfig
from .layers import apply_m_rope, apply_rope, rmsnorm

NEG_INF = -1e30


def _project_qkv(x, p, cfg: ArchConfig):
    B, S = x.shape[:2]
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
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


def attention(x, p, cfg: ArchConfig, positions, causal: bool = True):
    """Full self-attention (prefill): returns (out [B, S, d], (k, v)), with
    ``k`` after RoPE, as the decode cache holds it.  ``positions`` is
    [B, S], or [B, S, 3] under M-RoPE."""
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.rope_theta:
        q, k = _rope_qk(q, k, positions, cfg)
    out = ops.mha_flash(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
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
    scales = ()
    if cfg.kv_quant:
        (kq, ks), (vq, vs) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
        cache_k[:, pos], k_scale[:, pos] = kq, ks
        cache_v[:, pos], v_scale[:, pos] = vq, vs
        k_eff = cache_k.float() * k_scale[..., None]
        v_eff = (cache_v.float() * v_scale[..., None]).bfloat16()
        scales = (k_scale, v_scale)
    else:
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        k_eff, v_eff = cache_k, cache_v

    S = cache_k.shape[1]
    KH, D = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // KH
    qg = q.reshape(B, 1, KH, rep, D)
    dt = torch.promote_types(qg.dtype, k_eff.dtype)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.to(dt),
                          k_eff.to(dt)).float()
    scores = scores / D ** 0.5
    valid = torch.arange(S, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_eff.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v_eff).reshape(
        B, 1, cfg.n_heads * D).to(x.dtype)
    return (out @ p["wo"], cache_k, cache_v) + scales


def cross_attention(x, p, cfg: ArchConfig, enc_out):
    """Decoder cross-attention onto the encoder's output (whisper): x
    [B, Sq, d] against enc_out [B, Sk, d], no mask and no RoPE, plain torch
    with the reference's dtypes (scores in the inputs' dtype, the softmax
    in float32, weights cast back)."""
    B, Sq, _ = x.shape
    Sk = enc_out.shape[1]
    KH, D = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // KH
    qg = (x @ p["wq"]).reshape(B, Sq, KH, rep, D)
    k = (enc_out @ p["wk"]).reshape(B, Sk, KH, D)
    v = (enc_out @ p["wv"]).reshape(B, Sk, KH, D)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() / D ** 0.5
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v).reshape(B, Sq, -1)
    return out @ p["wo"]
