"""The reference's prefill: last-position logits and one row's cache."""
from __future__ import annotations

import torch

from .model import (embedding, layer, layer_weights, mm, rmsnorm, stack,
                    strict_fp32)


@torch.no_grad()
def forward(weights: dict, c: dict, steps, quant: str | None = None):
    """For each step ``(tokens [B, S], row)``: (the logits of every
    prompt's last position [B, V], float32; row ``row``'s cache: ``k`` and
    ``v`` [layers, S, KH, D] after RoPE, and for an SSM mixer ``conv``
    [layers, K-1, C] and ``ssd`` [layers, h, n, p]).  The layers run one
    at a time over every step, each layer's weights upcast once."""
    with strict_fp32():
        eps = c.get("norm_eps", 1e-6)
        xs = [embedding(weights, t, quant) for t, _ in steps]
        caches = [{} for _ in steps]
        for prefix, kind in stack(c):
            w = layer_weights(weights, prefix)
            for i, (_, row) in enumerate(steps):
                xs[i], el = layer(xs[i], w, c, kind, quant)
                for key, val in el.items():
                    caches[i].setdefault(key, []).append(val[row].clone())
            del w
        head = weights["embed"].T if c.get("tie_embeddings") \
            else weights["lm_head"]
        head = head.float()
        scale = weights["final_norm.scale"].float()
        out = []
        for x, cache in zip(xs, caches):
            logits = mm(rmsnorm(x[:, -1], scale, eps), head, quant)
            out.append((logits, {k: torch.stack(v) for k, v in cache.items()}))
        return out
