"""K3, the block-ELL SpMV of the AMG V-cycle, its plain version and the
host-side conversion into its layout.

A matrix in block-ELL form groups its rows into block rows of ``bs`` rows;
each block row holds up to ``max_bpr`` dense ``bs x bs`` blocks and their
block-column ids, padded with zero blocks at block column 0.

:func:`csr_to_block_ell`
    A :class:`~repro_torch.sparse.csr.CSR` matrix into ``(blocks, cols,
    max_bpr)``, bit-equal to the reference's conversion, in vectorised
    numpy (no loop over blocks or entries), then moved to the device.
:func:`spmv_block_ell`
    ``y = A @ x``.  It checks device, dtype, shape, contiguity and the range
    of ``cols`` and raises on anything else.  On CUDA tensors it launches
    K3 (``csrc/spmv_ell.cu``, one thread per output row) and adds one to
    :data:`LAUNCHES`; on CPU tensors it is :func:`spmv_block_ell_plain` —
    there is no fallback.
:func:`spmv_block_ell_plain`
    Gather, then an einsum in float32: the reference's oracle
    ``spmv_block_ell_ref``.

Counterpart of ``repro.kernels.spmv_ell``.  The kernel is built at first
use by :mod:`repro_torch.kernels.build`; nothing is compiled at import.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import resolve_device

from .build import kernel, launch

#: Kernel launches since the count was last reset.
LAUNCHES = {"spmv_block_ell": 0}

_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set the launch count to 0."""
    LAUNCHES["spmv_block_ell"] = 0


# -- host-side conversion ------------------------------------------------------

def csr_to_block_ell(csr, bs: int = 8, device=None):
    """Convert a CSR matrix to padded block-ELL tensors on ``device``.

    Returns ``(blocks, cols, max_bpr)``: float32 ``[nbr, max_bpr, bs, bs]``
    and int32 ``[nbr, max_bpr]`` with ``nbr = ceil(n_rows / bs)``.  Slots of
    a block row hold its nonzero blocks in ascending block-column order;
    padding slots point at block column 0 and hold zeros; ``max_bpr`` is the
    most blocks of any block row (0 for an all-zero matrix).  ``device=None``
    means CUDA.
    """
    dev = resolve_device(device)
    bs = int(bs)
    if bs < 1:
        raise ValueError(f"bs must be at least 1, got {bs}")
    n, m = csr.shape
    nbr, ncb = -(-n // bs), -(-m // bs)
    indices = np.asarray(csr.indices, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
    uniq, inv = np.unique((rows // bs) * ncb + indices // bs,
                          return_inverse=True)
    ub, uc = uniq // ncb, uniq % ncb
    counts = np.bincount(ub, minlength=nbr)
    max_bpr = int(counts.max()) if counts.size else 1
    slot = np.arange(uniq.size) - (np.cumsum(counts) - counts)[ub]
    blocks = np.zeros((nbr, max_bpr, bs, bs), dtype=np.float32)
    cols = np.zeros((nbr, max_bpr), dtype=np.int32)
    cols[ub, slot] = uc
    blocks[rows // bs, slot[inv], rows % bs, indices % bs] = csr.data
    return (torch.from_numpy(blocks).to(dev), torch.from_numpy(cols).to(dev),
            max_bpr)


# -- K3 ------------------------------------------------------------------------

def _check(blocks, cols, x) -> torch.device:
    """Raise unless ``(blocks, cols, x)`` is a block-ELL SpMV the kernel
    takes; returns their device."""
    for t, what in ((blocks, "blocks"), (cols, "cols"), (x, "x")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what} lies on unsupported device {t.device}")
    for t, what in ((blocks, "blocks"), (x, "x")):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{what} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be torch.int32, got {cols.dtype}")
    if (blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]
            or blocks.shape[2] < 1):
        raise ValueError(f"blocks must be [nbr, max_bpr, bs, bs], got shape "
                         f"{tuple(blocks.shape)}")
    nbr, max_bpr, bs, _ = blocks.shape
    if tuple(cols.shape) != (nbr, max_bpr):
        raise ValueError(f"cols must have shape {(nbr, max_bpr)}, got "
                         f"{tuple(cols.shape)}")
    if x.dim() != 1 or x.numel() % bs:
        raise ValueError(f"x must be 1-D with a multiple of bs={bs} entries, "
                         f"got shape {tuple(x.shape)}")
    dev = blocks.device
    if cols.device != dev or x.device != dev:
        raise ValueError(f"inputs on different devices: {blocks.device}, "
                         f"{cols.device} and {x.device}")
    if cols.numel():
        lo, hi = torch.stack(torch.aminmax(cols)).tolist()
        ncb = x.numel() // bs
        if lo < 0 or hi >= ncb:
            raise ValueError(f"block-column ids must lie in [0, {ncb}), got "
                             f"[{lo}, {hi}]")
    return dev


def spmv_block_ell_plain(blocks: torch.Tensor, cols: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: gather the x block of every slot, then one
    einsum in float32; the result in ``x``'s dtype."""
    nbr, _, bs, _ = blocks.shape
    gathered = x.reshape(-1, bs)[cols.long()]           # [nbr, max_bpr, bs]
    y = torch.einsum("rsij,rsj->ri", blocks.float(), gathered.float())
    return y.reshape(nbr * bs).to(x.dtype)


def spmv_block_ell(blocks: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` with ``A`` in block-ELL form.

    ``blocks`` ``[nbr, max_bpr, bs, bs]`` and ``x`` ``[ncb * bs]`` are
    float32 or bfloat16, ``cols`` ``[nbr, max_bpr]`` int32 in ``[0, ncb)``;
    returns ``y`` ``[nbr * bs]`` in ``x``'s dtype, summed in float32
    (``max_bpr == 0`` gives zeros).  On CUDA tensors this is one launch of
    K3, which sums each row slot by slot and is float32-allclose to the
    plain version, not bit-equal; on CPU tensors it is
    :func:`spmv_block_ell_plain`.
    """
    if _check(blocks, cols, x).type == "cpu":
        return spmv_block_ell_plain(blocks, cols, x)
    return _spmv_block_ell_cuda(blocks, cols, x)


def _spmv_block_ell_cuda(blocks: torch.Tensor, cols: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """K3's launch on checked CUDA inputs (the output allocated here)."""
    nbr, max_bpr, bs, _ = blocks.shape
    y = torch.empty(nbr * bs, dtype=x.dtype, device=x.device)
    if y.numel():
        launch(kernel("spmv_ell", "spmv_block_ell", _ARGTYPES), x.device,
               blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
               y.numel(), max_bpr, bs, int(blocks.dtype == torch.bfloat16),
               int(x.dtype == torch.bfloat16))
        LAUNCHES["spmv_block_ell"] += 1
    return y
