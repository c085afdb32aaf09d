"""Operations and bytes of the ops that per-layer rooflines read."""
from __future__ import annotations

from .peaks import PEAKS


def causal_pairs(S: int, causal: bool = True) -> int:
    """Query-key pairs a (row, head) attends: the triangle with its
    diagonal when causal."""
    return S * (S + 1) // 2 if causal else S * S


def attention_fwd(B: int, S: int, H: int, KH: int, D: int,
                  causal: bool = True, elt: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of grouped-query attention's forward: two products
    of ``2 D`` a pair a head; q, k and v read once and o written once,
    ``elt`` bytes an element."""
    flops = B * H * causal_pairs(S, causal) * 4 * D
    moved = (2 * B * S * H * D + 2 * B * S * KH * D) * elt
    return flops, moved


def attention_bwd(B: int, S: int, H: int, KH: int, D: int,
                  causal: bool = True, elt: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of its backward: four products (dV, dP, dQ, dK),
    twice the forward's (recomputing the scores is not needed work); q, k,
    v, o and dO read and dq, dk, dv written once."""
    flops = 2 * attention_fwd(B, S, H, KH, D, causal, elt)[0]
    moved = (4 * B * S * H * D + 4 * B * S * KH * D) * elt
    return flops, moved


def ssd_intra(G1: int, h: int, q: int, n: int, p: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the SSD intra-chunk step over ``G1`` (batch,
    chunk) pairs of ``h`` heads, chunk ``q``, state ``n``, head dim ``p``,
    float32: the lower triangle of ``C B^T`` once a (batch, chunk), then
    for each head its decayed scores times ``dt x`` (the triangle) and the
    chunk state ``B^T (decay * dt x)``, each product counted once; ``dt
    x``, ``cumA``, ``y`` and ``S_c`` once a head, B and C once a (batch,
    chunk), 4 bytes an element."""
    G = G1 * h
    tri = q * (q + 1) // 2
    flops = G1 * tri * 2 * n + G * (tri * 2 * p + 2 * q * n * p)
    moved = 4 * (2 * G * q * p + G * q + 2 * G1 * q * n + G * n * p)
    return flops, moved


def least_seconds(flops: float, moved: float, rate: str = "bf16") -> float:
    """The least time the card takes: the larger of the operations at the
    ``rate`` peak and the bytes at the HBM peak."""
    return max(flops / PEAKS[rate], moved / PEAKS["hbm"])
