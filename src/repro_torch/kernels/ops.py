"""Public entry points of the port's kernels, the counterpart of
``repro.kernels.ops``.

Only the block-ELL SpMV (K3) is ported so far.  ``flash_attention`` (K4),
``ssd_intra_chunk`` (K5) and ``mha_flash`` come with the port of the
``nn/`` layers, whose slice is the first to run them.
"""
from __future__ import annotations

from .spmv_ell import csr_to_block_ell, spmv_block_ell

__all__ = ["spmv_block_ell", "csr_to_block_ell"]
