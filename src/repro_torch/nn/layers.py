"""Shared neural layers: norms, RoPE, MLPs (counterpart of ``repro.nn.layers``).

Params are dicts of tensors; every function is pure.  Compute runs in the
weights' dtype with the reference's float32 upcasts for norms, RoPE and the
MLP activation.  ``apply_m_rope`` (qwen2-vl) is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def norm(x, p: dict, kind: str, eps: float):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


# --------------------------------------------------------------- RoPE -------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.cache
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once (a
    copy from pageable host memory on every call would stall the host
    until the device drains)."""
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)
                            ).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: [..., S, H, D]; positions: broadcastable to
    [..., S]."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)
    ang = positions[..., None].float() * freqs                  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                          # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP -------
def mlp(x: torch.Tensor, p: dict, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        gate = x @ p["w1"]
        up = x @ p["w3"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:  # gelu
        h = F.gelu((x @ p["w1"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w2"]
