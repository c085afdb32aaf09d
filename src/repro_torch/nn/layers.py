"""Shared neural layers: norms, RoPE, MLPs (counterpart of ``repro.nn.layers``).

Params are dicts of tensors; every function is pure.  Compute runs in the
weights' dtype with the reference's float32 upcasts for norms, RoPE and the
MLP activation.
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
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x [..., S, H, D] by angles [..., S, D/2]."""
    cos = torch.cos(ang)[..., None, :]                          # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.cache
def _m_rope_sections_on(half: int, sections: tuple,
                        device: torch.device) -> torch.Tensor:
    """For each of the ``half`` frequency slots, the position component
    (0 t, 1 h, 2 w) it takes, on ``device``: section sizes
    ``floor(half * w / sum(w))`` with the remainder added to section 0."""
    w = np.asarray(sections, dtype=np.float64)
    sizes = np.floor(half * w / w.sum()).astype(int)
    sizes[0] += half - sizes.sum()
    return torch.from_numpy(np.repeat(np.arange(3), sizes)).to(device)


def apply_m_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections=(2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head dim's frequency slots split into (t, h, w)
    sections by the relative weights ``sections``.

    x: [..., S, H, D]; positions: [..., S, 3] (temporal, height, width ids;
    text tokens use (t, t, t)).
    """
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)
    slot = _m_rope_sections_on(d // 2, tuple(sections), x.device)
    pos = positions.float().index_select(-1, slot)              # [..., S, D/2]
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------- MLP -------
def mlp(x: torch.Tensor, p: dict, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        gate = x @ p["w1"]
        up = x @ p["w3"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:  # gelu
        h = F.gelu((x @ p["w1"]).float(), approximate="tanh").to(x.dtype)
    return h @ p["w2"]
