"""Model FLOPs of a prefill step of a stack whose layers differ in their
mixer (granite-4.0-h), from its configuration's ``arch_config`` object.

A token's forward costs two FLOPs for each weight of the matrix products
it goes through: in each Mamba2 layer the input and output projections and
the depthwise convolution's taps, in each attention layer its four
projections, in every layer the router, the shared expert, and the routed
experts it is expected to reach among those held here (``K`` times the
share of the router's experts held: 10 x 36 / 72 = 5 of 72); plus causal
attention at ``4 D`` a query-key pair a head over the attention layers,
and the last position's unembedding.  Norms, the SSD scan, the routing's
sorts and elementwise work are not counted.
"""
from __future__ import annotations

from .model import _attn, _ssm
from .ops import causal_pairs


def _expert_layer(c: dict) -> float:
    """Weights of one expert layer a token goes through: the router, the
    shared expert and the expected routed experts held here."""
    d, f = c["d_model"], c["moe_d_ff"]
    router = c.get("router_experts") or c["n_experts"]
    routed = c["n_experts_active"] * c["n_experts"] / router
    return d * router + (c["n_shared_experts"] + routed) * 3 * d * f


def layer_matmul_params(c: dict) -> float:
    """Weights of the matrix products one token goes through, summed over
    the layers (the embedding and unembedding excluded)."""
    types = c["layer_types"]
    mixers = sum(_ssm(c) if t == "mamba" else _attn(c) for t in types)
    return mixers + len(types) * _expert_layer(c)


def attention_flops(c: dict, B: int, S: int) -> int:
    n_attn = sum(t == "attention" for t in c["layer_types"])
    return n_attn * B * c["n_heads"] * causal_pairs(S) * 4 * c["d_head"]


def prefill_flops(c: dict, B: int, S: int) -> float:
    """FLOPs of prefilling ``B`` prompts of ``S`` tokens: every token
    through the layers, the logits of the last position only."""
    return (2 * B * S * layer_matmul_params(c) + attention_flops(c, B, S)
            + 2 * B * c["d_model"] * c["vocab_size"])
