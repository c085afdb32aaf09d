"""Decoder and encoder blocks for the attn, moe, ssm and hybrid block kinds
and whisper's encoder and cross-attention decoder (counterpart of
``repro.nn.blocks``).

Each block is a function ``(x, layer_params, cfg, ...) -> x`` over one
layer's parameters; the model loops over its layers in Python, passing
each layer's block kind where ``cfg.layer_types`` mixes them.  The
feed-forward half is the MoE layer wherever the config has experts (after
an SSM mixer too), else the MLP.  Each residual branch of a decoder
block is scaled by ``cfg.residual_multiplier`` where it is not 1.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.parallel.context import gather_model, reduce_output as _out

from .attention import attention, cross_attention, decode_attention
from .config import ArchConfig
from .layers import mlp, norm
from .moe import moe_ffn
from .ssm import ssm_decode, ssm_mixer


def _norm(x, p, cfg):
    """The normed input of a mixer, whole over the model axis under a
    layout (``gather_model``)."""
    return gather_model(norm(x, p, cfg.norm_type, cfg.norm_eps))


def _scaled(y, cfg: ArchConfig):
    """``y`` times ``cfg.residual_multiplier`` where that is not 1."""
    return y if cfg.residual_multiplier == 1.0 \
        else y * cfg.residual_multiplier


def _branch(y, cfg: ArchConfig):
    """A residual branch's output reduced back (``_out``), scaled."""
    return _scaled(_out(y), cfg)


def _ffn(x, lp, cfg: ArchConfig):
    """The block's feed-forward half: (x, aux loss of its MoE layer or
    None)."""
    if cfg.is_moe:
        xn = _norm(x, lp["ln2"], cfg)
        with obs.span("repro_torch.moe"):
            m_out, aux = moe_ffn(xn, lp["moe"], cfg)
        return x + _branch(m_out, cfg), aux
    if cfg.d_ff:
        x = x + _branch(_mlp(_norm(x, lp["ln2"], cfg), lp, cfg), cfg)
    return x, None


def _mlp(xn, lp, cfg: ArchConfig):
    """The block's dense MLP on its normed input."""
    with obs.span("repro_torch.mlp"):
        return mlp(xn, lp["mlp"], cfg.mlp_type)


def _ssm(xn, lp, cfg: ArchConfig, collect_cache: bool):
    """The block's Mamba2 mixer on its normed input (with its decode
    states when ``collect_cache``)."""
    with obs.span("repro_torch.ssm"):
        return ssm_mixer(xn, lp["ssm"], cfg, return_state=collect_cache)


def _kind(cfg: ArchConfig) -> str:
    """The config's one block kind; a stack that mixes kinds has none."""
    if cfg.layer_types:
        raise ValueError(f"{cfg.name} mixes its layers' mixers: pass each "
                         "layer's kind (cfg.layer_kinds)")
    return cfg.block_kind


# ----------------------------------------------------------- full-seq -------
def block_forward(x, lp, cfg: ArchConfig, positions, causal: bool = True,
                  collect_cache: bool = False, kind: str | None = None):
    """One decoder block of block kind ``kind`` (``cfg.block_kind`` when
    None), full sequence (prefill).

    Returns (x, aux_loss, cache_el): ``cache_el`` is a dict of decode-cache
    elements ({"k","v"} and/or {"conv","ssd"}) when ``collect_cache``.
    """
    kind = kind or _kind(cfg)
    cache_el: dict = {}

    if kind == "ssm":
        # the mixer lays out its own input (``ssm._in_proj``)
        res = _ssm(norm(x, lp["ln1"], cfg.norm_type, cfg.norm_eps), lp,
                   cfg, collect_cache)
        if collect_cache:
            y, (conv_st, ssd_st) = res
            cache_el.update(conv=conv_st, ssd=ssd_st)
        else:
            y = res
        x = x + _branch(y, cfg)
    elif kind == "hybrid":
        xn = _norm(x, lp["ln1"], cfg)
        a_out, kv = attention(xn, lp["attn"], cfg, positions, causal=causal)
        res = _ssm(xn, lp, cfg, collect_cache)
        if collect_cache:
            s_out, (conv_st, ssd_st) = res
            cache_el.update(k=kv[0], v=kv[1], conv=conv_st, ssd=ssd_st)
        else:
            s_out = res
        x = x + _scaled(0.5 * (_out(a_out) + _out(s_out)), cfg)
    else:
        a_out, kv = attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                              positions, causal=causal)
        if collect_cache:
            cache_el.update(k=kv[0], v=kv[1])
        x = x + _branch(a_out, cfg)

    x, aux = _ffn(x, lp, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache_el


def encoder_block(x, lp, cfg: ArchConfig, positions):
    """Bidirectional encoder block (whisper): attention through K4 with no
    mask, then the MLP."""
    a_out, _ = attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                         positions, causal=False)
    x = x + _out(a_out)
    return x + _out(_mlp(_norm(x, lp["ln2"], cfg), lp, cfg))


def cross_block(x, lp, cfg: ArchConfig, positions, enc_out):
    """Decoder block with cross-attention (whisper): causal
    self-attention through K4, cross-attention onto ``enc_out``, the MLP.
    Returns (x, (k, v)) of the self-attention."""
    a_out, kv = attention(_norm(x, lp["ln1"], cfg), lp["attn"], cfg,
                          positions, causal=True)
    x = x + _out(a_out)
    x = x + _out(cross_attention(_norm(x, lp["ln3"], cfg), lp["xattn"], cfg,
                                 enc_out))
    x = x + _out(_mlp(_norm(x, lp["ln2"], cfg), lp, cfg))
    return x, kv


# -------------------------------------------------------------- decode ------
def block_decode(x, lp, cfg: ArchConfig, cache_l: dict, pos: int,
                 kind: str | None = None):
    """One-token decode through one block of block kind ``kind``
    (``cfg.block_kind`` when None).  Returns (x, new_cache_l): the k and v
    entries (and under ``cfg.kv_quant`` their scales) are ``cache_l``'s
    own tensors, written in place at ``pos``; conv and ssd are new
    tensors; ``enc_out`` passes through unchanged."""
    kind = kind or _kind(cfg)
    new_cache = dict(cache_l)

    def _dec_attn(xn):
        res = decode_attention(xn, lp["attn"], cfg, cache_l["k"],
                               cache_l["v"], pos,
                               k_scale=cache_l.get("k_scale"),
                               v_scale=cache_l.get("v_scale"))
        new_cache.update(k=res[1], v=res[2])
        if cfg.kv_quant:
            new_cache.update(k_scale=res[3], v_scale=res[4])
        return res[0]

    if kind == "ssm":
        y, new_conv, new_ssd = ssm_decode(_norm(x, lp["ln1"], cfg), lp["ssm"],
                                          cfg, cache_l["conv"], cache_l["ssd"])
        x = x + _branch(y, cfg)
        new_cache.update(conv=new_conv, ssd=new_ssd)
    elif kind == "hybrid":
        xn = _norm(x, lp["ln1"], cfg)
        a_out = _dec_attn(xn)
        s_out, new_conv, new_ssd = ssm_decode(xn, lp["ssm"], cfg,
                                              cache_l["conv"], cache_l["ssd"])
        x = x + _scaled(0.5 * (_out(a_out) + _out(s_out)), cfg)
        new_cache.update(conv=new_conv, ssd=new_ssd)
    else:
        x = x + _branch(_dec_attn(_norm(x, lp["ln1"], cfg)), cfg)

    if cfg.cross_attention:
        x = x + _out(cross_attention(_norm(x, lp["ln3"], cfg), lp["xattn"],
                                     cfg, cache_l["enc_out"]))
    x, _ = _ffn(x, lp, cfg)
    return x, new_cache
