"""Public entry points of the port's kernels, the counterpart of
``repro.kernels.ops``: flash attention (K4), the SSD intra-chunk step (K5)
and the block-ELL SpMV (K3), plus the shape-checked ``mha_flash``.

``flash_attention`` and ``ssd_intra_chunk`` here are K4 and K5 under
autograd (``flash_attention.FlashAttention`` and ``ssd.SsdIntraChunk``):
the kernel's launch forward and a torch-op backward, so the training step
runs the same launches as serving; under ``torch.no_grad`` each is the
plain wrapper's one launch.
"""
from __future__ import annotations

from .flash_attention import flash_attention_autograd as flash_attention
from .spmv_ell import csr_to_block_ell, spmv_block_ell
from .ssd import ssd_intra_chunk_autograd as ssd_intra_chunk

__all__ = ["flash_attention", "ssd_intra_chunk", "spmv_block_ell",
           "csr_to_block_ell", "mha_flash"]


def mha_flash(q, k, v, causal: bool = True):
    """Shape-checked flash attention entry point: ``q`` ``[B, S, H, D]``,
    ``k``/``v`` ``[B, S, KH, D]`` of one shape, ``H`` a multiple of ``KH``
    (the reference's checks, raised as ``ValueError``); dtypes, head dims
    and contiguity are checked by :func:`flash_attention`, which it calls.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [B, S, heads, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[1] != k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share batch and sequence")
    if q.shape[3] != k.shape[3]:
        raise ValueError(f"q and k head dims differ: {q.shape[3]} vs "
                         f"{k.shape[3]}")
    if q.shape[2] % k.shape[2]:
        raise ValueError("H must be a multiple of KH")
    return flash_attention(q, k, v, causal=causal)
