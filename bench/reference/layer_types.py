"""The plain float32 forward of a stack whose layers differ in their mixer:
granite-4.0-h (``GraniteMoeHybridForCausalLM`` of transformers'
``modeling_granitemoehybrid.py``).

Written from those layer equations, in plain PyTorch and float32 with TF32
off (:func:`~reference.model.strict_fp32`), importing nothing of the
program; the Mamba2 mixer, SwiGLU, RMSNorm, the causal attention and the
float8 control come from :mod:`reference.model`.  ``c`` is a configuration
keyed as the program's ``ArchConfig`` (plus ``moe_chunk_tokens``):

- the embedding times ``embedding_multiplier``;
- layer ``i``: ``x + r mixer(n(x))``, then ``x + r (moe(n(x)) +
  shared(n(x)))``, ``r`` the ``residual_multiplier``; the mixer is the
  Mamba2 mixer or grouped-query attention with no positional encoding, as
  ``layer_types[i]`` names;
- the logits of the final norm's output over ``logits_scaling``, the
  embedding tied.

Departures from the published code, each as the program makes it:

- the expert layer holds experts ``expert_first`` to ``expert_first +
  n_experts - 1`` of a router over ``router_experts`` (a chip's share
  under expert parallelism): the router chooses among all, the experts
  held elsewhere add nothing, and the shared expert runs whole;
- each expert keeps the first ``C`` of its assignments in (token, rank)
  order and drops the rest, ``C = floor(T K cf / router_experts) + 1``
  rounded up to a multiple of 8, for a routing group of ``T`` tokens (the
  published layer drops none);
- the top ``K`` experts by a stable descending sort of the softmax over
  every expert, their gates renormalised (the published softmax over the
  top ``K`` logits: the same gates; ties broken to the lower id);
- the SSD scan in chunks of ``ssm_chunk`` (128) positions, not the
  published 256 (the scan's result does not depend on it);
- q scaled by ``attention_multiplier * sqrt(D)`` before attention's
  ``1 / sqrt(D)`` (the published scales the scores by the multiplier).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import (causal_attention, embedding, layer_weights, mamba2, mm,
                    rmsnorm, strict_fp32, swiglu)


def attention(xn, w: dict, c: dict, quant=None):
    """NoPE grouped-query attention: (output [B, S, d], k, v [B, S, KH,
    D])."""
    B, S, _ = xn.shape
    H, KH, D = c["n_heads"], c["n_kv_heads"], c["d_head"]
    q = mm(xn, w["attn.wq"], quant).reshape(B, S, H, D) \
        * (c["attention_multiplier"] * math.sqrt(D))
    k = mm(xn, w["attn.wk"], quant).reshape(B, S, KH, D)
    v = mm(xn, w["attn.wv"], quant).reshape(B, S, KH, D)
    o = causal_attention(q, k, v, quant).reshape(B, S, H * D)
    return mm(o, w["attn.wo"], quant), k, v


def capacity(tokens: int, c: dict) -> int:
    """An expert's slots for ``tokens`` tokens: ``T K cf / E`` (``E`` the
    router's experts) plus one, rounded up to a multiple of 8, at least
    8."""
    router = c.get("router_experts") or c["n_experts"]
    slots = int(tokens * c["n_experts_active"] * c["capacity_factor"]
                // router) + 1
    return max(8, -(-slots // 8) * 8)


def top_ids(probs, K: int):
    """The ``K`` experts of each token by a stable descending sort of the
    router's probabilities [T, E]: [T, K]."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K]


def moe(x, w: dict, c: dict, quant=None, pick=None):
    """The experts held here and the shared expert on one routing group
    x [T, d]; ``pick``, where given, chooses each token's experts [T, K]
    as ``pick(probs, K)`` from the router's probabilities [T, E] in place
    of their top ``K`` (:func:`top_ids`), the gates still the router's
    probabilities of them renormalised."""
    T = x.shape[0]
    E, K = c["n_experts"], c["n_experts_active"]
    router = c.get("router_experts") or E
    first = c.get("expert_first", 0)
    C = capacity(T, c)
    probs = torch.softmax(mm(x, w["moe.router"], quant), dim=-1)
    ids = top_ids(probs, K) if pick is None else pick(probs, K)
    picked = probs.gather(-1, ids)
    gates = picked / picked.sum(-1, keepdim=True)
    flat = ids.reshape(-1)
    hot = F.one_hot(flat, router)
    rank = (hot.cumsum(0) * hot).sum(-1) - 1      # among its expert's
    keep = rank < C
    g = gates.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(E):
        sel = torch.nonzero((flat == first + e) & keep).squeeze(-1)
        tok = sel // K
        out = swiglu(x[tok], w["moe.w1"][e], w["moe.w3"][e], w["moe.w2"][e],
                     quant)
        y = y.index_add(0, tok, out * g[sel, None])
    return y + swiglu(x, w["moe.shared_w1"], w["moe.shared_w3"],
                      w["moe.shared_w2"], quant)


def moe_tokens(x, w: dict, c: dict, quant=None, pick=None):
    """The expert layer on x [B, S, d]: the B * S tokens one routing
    group, or groups of ``moe_chunk_tokens`` where there are more in a
    whole multiple of it (``pick`` as :func:`moe` takes it)."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    chunk = c.get("moe_chunk_tokens", B * S)
    if B * S > chunk and (B * S) % chunk == 0:
        out = torch.cat([moe(part, w, c, quant, pick)
                         for part in flat.split(chunk)])
    else:
        out = moe(flat, w, c, quant, pick)
    return out.reshape(B, S, d)


def layer(x, w: dict, c: dict, kind: str, quant=None, pick=None):
    """Decoder layer of mixer ``kind`` ("mamba" or "attention"): (x, its
    cache elements {k, v} or {conv, ssd})."""
    eps, r = c["norm_eps"], c["residual_multiplier"]
    xn = rmsnorm(x, w["ln1.scale"], eps)
    if kind == "mamba":
        y, conv, ssd = mamba2(xn, w, c, quant)
        el = {"conv": conv, "ssd": ssd}
    else:
        y, k, v = attention(xn, w, c, quant)
        el = {"k": k, "v": v}
    x = x + r * y
    return x + r * moe_tokens(rmsnorm(x, w["ln2.scale"], eps), w, c,
                              quant, pick), el


def _run(weights: dict, c: dict, tokens_rows, quant=None, picks=None):
    """Every prompt batch of ``tokens_rows`` ((tokens [B, S], row)) through
    the stack, a layer at a time (its weights upcast once), batch ``j``'s
    experts chosen by ``picks[j]`` where given: the final norm's output
    [B, S, d] of each, and row ``row``'s cache elements of each, stacked
    over the layers that have them."""
    picks = picks or [None] * len(tokens_rows)
    eps = c["norm_eps"]
    xs = [embedding(weights, t, quant) * c["embedding_multiplier"]
          for t, _ in tokens_rows]
    caches = [{} for _ in tokens_rows]
    for i, kind in enumerate(c["layer_types"]):
        w = layer_weights(weights, f"layers.{i}.")
        for j, (_, row) in enumerate(tokens_rows):
            xs[j], el = layer(xs[j], w, c, kind, quant, picks[j])
            for key, val in el.items():
                caches[j].setdefault(key, []).append(val[row].clone())
        del w
    scale = weights["final_norm.scale"].float()
    return ([rmsnorm(x, scale, eps) for x in xs],
            [{k: torch.stack(v) for k, v in cache.items()}
             for cache in caches])


def _logits(weights: dict, c: dict, h, quant=None):
    return mm(h, weights["embed"].float().T, quant) / c["logits_scaling"]


@torch.no_grad()
def forward(weights: dict, c: dict, steps, quant: str | None = None,
            picks=None):
    """For each step ``(tokens [B, S], row)``: (the logits of every
    prompt's last position [B, V], float32; row ``row``'s cache: ``k`` and
    ``v`` [attention layers, S, KH, D], ``conv`` [Mamba2 layers, K-1, C]
    and ``ssd`` [Mamba2 layers, h, n, p]), as
    :func:`reference.prefill.forward` gives them.  ``picks``, one a step
    where given, choose the experts of each of the step's routing groups
    in turn (:func:`moe`)."""
    with strict_fp32():
        hs, caches = _run(weights, c, steps, quant, picks)
        return [(_logits(weights, c, h[:, -1], quant), cache)
                for h, cache in zip(hs, caches)]


@torch.no_grad()
def all_logits(weights: dict, c: dict, tokens) -> torch.Tensor:
    """The logits of every position of ``tokens`` [B, S]: [B, S, V],
    float32 (what a prefill and then decode steps through the cache must
    give)."""
    with strict_fp32():
        (h,), _ = _run(weights, c, [(tokens, 0)])
        return _logits(weights, c, h)
