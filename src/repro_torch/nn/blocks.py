"""Decoder blocks for the attn, ssm and hybrid block kinds (counterpart of
``repro.nn.blocks``).

Each block is a function ``(x, layer_params, cfg, ...) -> x`` over one
layer's parameters; the model loops over its layers in Python.  The moe
block kind and the whisper blocks (``encoder_block``, ``cross_block``) are
not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .attention import attention, decode_attention
from .config import ArchConfig
from .layers import mlp, norm
from .ssm import ssm_decode, ssm_mixer

_WAITS = "waits for the rest of ROADMAP queue item 5 (nn/)"


def _norm(x, p, cfg):
    return norm(x, p, cfg.norm_type, cfg.norm_eps)


def _check_kind(cfg: ArchConfig) -> str:
    if cfg.cross_attention:
        raise NotImplementedError(f"cross-attention blocks {_WAITS}")
    kind = cfg.block_kind
    if kind == "moe":
        raise NotImplementedError(f"MoE blocks {_WAITS}")
    return kind


# ----------------------------------------------------------- full-seq -------
def block_forward(x, lp, cfg: ArchConfig, positions, causal: bool = True,
                  collect_cache: bool = False):
    """One decoder block, full sequence (prefill).

    Returns (x, aux_loss, cache_el): ``cache_el`` is a dict of decode-cache
    elements ({"k","v"} and/or {"conv","ssd"}) when ``collect_cache``.
    """
    kind = _check_kind(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache_el: dict = {}

    if kind == "ssm":
        res = ssm_mixer(_norm(x, lp["ln1"], cfg), lp["ssm"], cfg,
                        return_state=collect_cache)
        if collect_cache:
            y, (conv_st, ssd_st) = res
            cache_el.update(conv=conv_st, ssd=ssd_st)
        else:
            y = res
        x = x + y
    elif kind == "hybrid":
        xn = _norm(x, lp["ln1"], cfg)
        a_out, kv = attention(xn, lp["attn"], cfg, positions, causal=causal)
        res = ssm_mixer(xn, lp["ssm"], cfg, return_state=collect_cache)
        if collect_cache:
            s_out, (conv_st, ssd_st) = res
            cache_el.update(k=kv[0], v=kv[1], conv=conv_st, ssd=ssd_st)
        else:
            s_out = res
        x = x + 0.5 * (a_out + s_out)
    else:
        a_out, kv = attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              positions, causal=causal)
        if collect_cache:
            cache_el.update(k=kv[0], v=kv[1])
        x = x + a_out

    if cfg.d_ff:
        x = x + mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg.mlp_type)
    return x, aux, cache_el


def encoder_block(x, lp, cfg: ArchConfig, positions):
    """Bidirectional encoder block (whisper): not ported yet."""
    raise NotImplementedError(f"encoder blocks {_WAITS}")


def cross_block(x, lp, cfg: ArchConfig, positions, enc_out):
    """Decoder block with cross-attention (whisper): not ported yet."""
    raise NotImplementedError(f"cross-attention blocks {_WAITS}")


# -------------------------------------------------------------- decode ------
def block_decode(x, lp, cfg: ArchConfig, cache_l: dict, pos: int):
    """One-token decode through one block.  Returns (x, new_cache_l): the
    k and v entries are ``cache_l``'s own tensors, written in place at
    ``pos``; conv and ssd are new tensors."""
    kind = _check_kind(cfg)
    new_cache = dict(cache_l)

    def _dec_attn(xn):
        a_out, nk, nv = decode_attention(xn, lp["attn"], cfg, cache_l["k"],
                                         cache_l["v"], pos)
        new_cache.update(k=nk, v=nv)
        return a_out

    if kind == "ssm":
        y, new_conv, new_ssd = ssm_decode(_norm(x, lp["ln1"], cfg), lp["ssm"],
                                          cfg, cache_l["conv"], cache_l["ssd"])
        x = x + y
        new_cache.update(conv=new_conv, ssd=new_ssd)
    elif kind == "hybrid":
        xn = _norm(x, lp["ln1"], cfg)
        a_out = _dec_attn(xn)
        s_out, new_conv, new_ssd = ssm_decode(xn, lp["ssm"], cfg,
                                              cache_l["conv"], cache_l["ssd"])
        x = x + 0.5 * (a_out + s_out)
        new_cache.update(conv=new_conv, ssd=new_ssd)
    else:
        x = x + _dec_attn(_norm(x, lp["ln1"], cfg))

    if cfg.d_ff:
        x = x + mlp(_norm(x, lp["ln2"], cfg), lp["mlp"], cfg.mlp_type)
    return x, new_cache
