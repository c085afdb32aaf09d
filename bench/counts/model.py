"""Model FLOPs of a step, from a configuration file's numbers.

A token's forward costs two FLOPs for each weight of the layers' matrix
products that it uses (the routed experts it is sent to, not the others;
the depthwise convolution's taps count as such weights), plus causal
attention at ``4 D`` a query-key pair a head, plus the unembedding where
logits are made.  Norms, RoPE, the SSD scan and elementwise work are not
counted.
"""
from __future__ import annotations

from .ops import causal_pairs


def _attn(c: dict) -> int:
    d, hd = c["d_model"], c["d_head"] or c["d_model"] // c["n_heads"]
    return 2 * d * c["n_heads"] * hd + 2 * d * c["n_kv_heads"] * hd


def _ssm(c: dict) -> int:
    d = c["d_model"]
    di = c.get("ssm_expand", 2) * d
    n = c["ssm_state"]
    h = di // c.get("ssm_head_dim", 64)
    conv = c.get("ssm_conv_kernel", 4) * (di + 2 * n)
    return d * (2 * di + 2 * n + h) + conv + di * d


def _mlp(c: dict, ff: int) -> int:
    return (3 if c.get("mlp_type", "swiglu") == "swiglu" else 2) \
        * c["d_model"] * ff


def _moe(c: dict) -> int:
    d, f = c["d_model"], c["moe_d_ff"]
    active = c["n_experts_active"] + c.get("n_shared_experts", 0)
    return d * c["n_experts"] + active * 3 * d * f


def layer_matmul_params(c: dict) -> int:
    """Weights of the matrix products one token goes through, summed over
    the layers (embedding and unembedding excluded)."""
    family = c["family"]
    dense = c.get("first_dense_layers", 0)
    rest = c["n_layers"] - dense
    per = 0
    if family in ("hybrid", "ssm"):
        per += _ssm(c)
    if family != "ssm":
        per += _attn(c)
    per += _moe(c) if c.get("n_experts", 0) else \
        (_mlp(c, c["d_ff"]) if c.get("d_ff") else 0)
    return rest * per + dense * (_attn(c) + _mlp(c, c["d_ff"]))


def attn_layers(c: dict) -> int:
    return 0 if c["family"] == "ssm" else c["n_layers"]


def attention_flops(c: dict, B: int, S: int) -> int:
    hd = c["d_head"] or c["d_model"] // c["n_heads"]
    return attn_layers(c) * B * c["n_heads"] * causal_pairs(S) * 4 * hd


def prefill_flops(c: dict, B: int, S: int) -> int:
    """FLOPs of prefilling ``B`` prompts of ``S`` tokens: every token
    through the layers, the logits of the last position only."""
    return (2 * B * S * layer_matmul_params(c) + attention_flops(c, B, S)
            + 2 * B * c["d_model"] * c["vocab_size"])


def train_flops(c: dict, B: int, S: int) -> int:
    """FLOPs of a training step on ``B`` rows of ``S`` tokens: three times
    the forward's (logits at every position); recomputation not
    counted."""
    fwd = (2 * B * S * layer_matmul_params(c) + attention_flops(c, B, S)
           + 2 * B * S * c["d_model"] * c["vocab_size"])
    return 3 * fwd
