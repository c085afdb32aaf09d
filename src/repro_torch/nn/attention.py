"""Grouped-query attention: full (prefill) and cached decode (counterpart of
``repro.nn.attention``).

Full attention runs through K4, :func:`repro_torch.kernels.ops.mha_flash`,
for every sequence length: the hand-written kernel on the card, its plain
version on CPU tensors.  One-token decode against the cache stays plain
torch, as it stays plain jnp in the reference: no TPU kernel covers it.
Not ported yet: ``cfg.kv_quant`` (the int8 cache), ``cross_attention``
(whisper) and ``cfg.m_rope`` (qwen2-vl); each raises
``NotImplementedError`` naming ROADMAP queue item 5.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .config import ArchConfig
from .layers import apply_rope, rmsnorm

NEG_INF = -1e30
_WAITS = "waits for the rest of ROADMAP queue item 5 (nn/)"


def _not_ported(cfg: ArchConfig) -> None:
    if cfg.kv_quant:
        raise NotImplementedError(f"the int8 KV cache (kv_quant) {_WAITS}")
    if cfg.m_rope:
        raise NotImplementedError(f"M-RoPE (m_rope) {_WAITS}")


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
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def attention(x, p, cfg: ArchConfig, positions, causal: bool = True):
    """Full self-attention (prefill): returns (out [B, S, d], (k, v)), with
    ``k`` after RoPE, as the decode cache holds it."""
    _not_ported(cfg)
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.rope_theta:
        q, k = _rope_qk(q, k, positions, cfg)
    out = ops.mha_flash(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def decode_attention(x, p, cfg: ArchConfig, cache_k, cache_v, pos: int):
    """One-token decode against a bf16 (or float32) KV cache.

    x: [B, 1, d]; cache_k/v: [B, S_max, KH, D]; pos: the current position.
    Writes this token's k and v into the cache at ``pos`` in place (the
    reference returns updated copies; the port saves the copy of the whole
    cache every layer and step) and returns (out [B, 1, d], cache_k,
    cache_v).  The arithmetic follows the reference's dtypes: scores in
    the promoted dtype of q and the cache, then float32 for the softmax,
    weights cast to the cache's dtype.
    """
    _not_ported(cfg)
    B = x.shape[0]
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.rope_theta:
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=x.device)
        q, k = _rope_qk(q, k, positions, cfg)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)

    S = cache_k.shape[1]
    KH, D = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // KH
    qg = q.reshape(B, 1, KH, rep, D)
    dt = torch.promote_types(qg.dtype, cache_k.dtype)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.to(dt),
                          cache_k.to(dt)).float()
    scores = scores / D ** 0.5
    valid = torch.arange(S, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, cache_v).reshape(
        B, 1, cfg.n_heads * D).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v


def cross_attention(x, p, cfg: ArchConfig, enc_out):
    """Decoder cross-attention (whisper): not ported yet."""
    raise NotImplementedError(f"cross_attention {_WAITS}")
