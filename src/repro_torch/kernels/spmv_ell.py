"""K3, the block-ELL SpMV of the AMG V-cycle, its plain version and the
host-side conversion into its layout.

A matrix in block-ELL form groups its rows into block rows of ``bs`` rows;
each block row holds up to ``max_bpr`` dense ``bs x bs`` blocks and their
block-column ids, padded with zero blocks at block column 0.

:func:`csr_to_block_ell`
    A :class:`~repro_torch.sparse.csr.CSR` matrix into ``(blocks, cols,
    max_bpr)``, bit-equal to the reference's conversion, in vectorised
    numpy (no loop over blocks or entries), then moved to the device.  It
    range-checks the column ids on the host, before the copy, and records
    that check on the device tensor ``cols`` (:func:`checked_bound`).
:func:`spmv_block_ell`
    ``y = A @ x``.  It checks device, dtype, shape, contiguity and the range
    of ``cols`` and raises on anything else.  The range check reads the
    record of an earlier check while ``cols`` is unchanged since it
    (``cols._version``), and otherwise runs ``aminmax`` on ``cols``, which
    waits for the device.  On CUDA tensors it launches K3
    (``csrc/spmv_ell.cu``, each output row summed by :func:`lanes_for`
    threads) and adds one to :data:`LAUNCHES`; on CPU tensors it is
    :func:`spmv_block_ell_plain` — there is no fallback.
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
#: Range checks of ``cols`` that ran ``aminmax`` (a device sync on CUDA).
RANGE_CHECKS = {"spmv_block_ell": 0}

_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int)
_DTYPES = (torch.float32, torch.bfloat16)
#: Most threads a row (``kMaxLanes`` in ``csrc/spmv_ell.cu``).
K3_MAX_LANES = 32
#: Threads K3 aims to have in flight: 132 SMs x 384.
K3_FILL_THREADS = 132 * 384
#: Slots a block row from which a warp takes whole block rows.
K3_LONG_ROW = 16


def reset_launches() -> None:
    """Set the launch count to 0."""
    LAUNCHES["spmv_block_ell"] = 0


def lanes_for(n_rows: int, bs: int, max_bpr: int) -> int:
    """Threads K3 gives each output row: the least power of two that puts
    ``K3_FILL_THREADS`` threads on the card; at least the largest power of
    two up to ``32 // bs`` (a warp then reads whole blocks of consecutive
    slots) when a block row has ``K3_LONG_ROW`` slots or more; no more
    than the slots of a block row need (the next power of two above
    ``max_bpr``) or ``K3_MAX_LANES``.  Fitted to the device times of every
    lane count on the V-cycle's operators (``tools/k3_check.py``)."""
    lanes = 1
    while max_bpr >= K3_LONG_ROW and 2 * lanes * bs <= 32:
        lanes *= 2
    while (lanes < K3_MAX_LANES and lanes < max_bpr
           and n_rows * lanes < K3_FILL_THREADS):
        lanes *= 2
    return lanes


def checked_bound(cols: torch.Tensor) -> int | None:
    """One past the largest block-column id of ``cols`` as an earlier range
    check found it (ids were >= 0), or ``None`` when ``cols`` has no such
    record or was changed in place since (its ``_version`` moved)."""
    rec = getattr(cols, "_k3_checked", None)
    if rec is None or rec[0] != cols._version:
        return None
    return rec[1]


def _record(cols: torch.Tensor, bound: int, layout=None) -> torch.Tensor:
    """Record a range check on ``cols``; ``layout``, when given, is the
    token :func:`padding_at_end` matches against its ``blocks``."""
    cols._k3_checked = (cols._version, int(bound), layout)
    return cols


def _mark_layout(blocks: torch.Tensor, cols: torch.Tensor, bound: int):
    """Mark ``(blocks, cols)`` as one pair in :func:`csr_to_block_ell`'s
    layout, as made: a shared token on both, with their versions."""
    token = object()
    blocks._k3_layout = (blocks._version, token)
    return blocks, _record(cols, bound, token)


def padding_at_end(blocks: torch.Tensor, cols: torch.Tensor) -> bool:
    """Whether ``(blocks, cols)`` is unchanged since
    :func:`csr_to_block_ell` made it as one pair (or :func:`move_ell`
    moved such a pair): then each block row's real blocks fill its first
    slots in ascending block-column order and every later slot is padding
    (block column 0, a zero block), so a slot ``s >= 1`` with block column
    0 and every slot after it add nothing, and K3 stops there."""
    rb = getattr(blocks, "_k3_layout", None)
    rc = getattr(cols, "_k3_checked", None)
    return (rb is not None and rc is not None and rc[2] is not None
            and rb[1] is rc[2] and rb[0] == blocks._version
            and rc[0] == cols._version)


def move_ell(blocks: torch.Tensor, cols: torch.Tensor, device):
    """``(blocks, cols)`` on ``device``, with ``cols`` range-checked once
    there (:func:`check_cols`); a pair that :func:`padding_at_end` accepts
    stays marked as one."""
    canonical = padding_at_end(blocks, cols)
    blocks, cols = blocks.to(device), check_cols(cols.to(device))
    if canonical:
        return _mark_layout(blocks, cols, checked_bound(cols))
    return blocks, cols


def check_cols(cols: torch.Tensor) -> torch.Tensor:
    """Range-check ``cols`` once (``aminmax``, a device sync on CUDA),
    raise on a negative id, and record the check so that
    :func:`spmv_block_ell` skips it while ``cols`` stays unchanged."""
    bound = 0
    if cols.numel():
        lo, hi = torch.stack(torch.aminmax(cols)).tolist()
        RANGE_CHECKS["spmv_block_ell"] += 1
        if lo < 0:
            raise ValueError(f"block-column ids must be >= 0, got {lo}")
        bound = hi + 1
    return _record(cols, bound)


# -- host-side conversion ------------------------------------------------------

def csr_to_block_ell(csr, bs: int = 8, device=None):
    """Convert a CSR matrix to padded block-ELL tensors on ``device``.

    Returns ``(blocks, cols, max_bpr)``: float32 ``[nbr, max_bpr, bs, bs]``
    and int32 ``[nbr, max_bpr]`` with ``nbr = ceil(n_rows / bs)``.  Slots of
    a block row hold its nonzero blocks in ascending block-column order;
    padding slots point at block column 0 and hold zeros; ``max_bpr`` is the
    most blocks of any block row (0 for an all-zero matrix).  ``device=None``
    means CUDA.  Raises when a column id of ``csr`` lies outside ``[0,
    n_cols)``, whose block-column id would fall outside ``[0, ncb)``; the
    check runs in numpy and is recorded on ``cols`` (:func:`checked_bound`).
    """
    dev = resolve_device(device)
    bs = int(bs)
    if bs < 1:
        raise ValueError(f"bs must be at least 1, got {bs}")
    n, m = csr.shape
    nbr, ncb = -(-n // bs), -(-m // bs)
    indices = np.asarray(csr.indices, dtype=np.int64)
    if indices.size and (indices.min() < 0 or indices.max() >= m):
        lo, hi = int(indices.min()), int(indices.max())
        raise ValueError(f"block-column ids must lie in [0, {ncb}), got "
                         f"[{lo // bs}, {hi // bs}] (column ids [{lo}, {hi}] "
                         f"of a {n} x {m} matrix)")
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
    bound = int(cols.max()) + 1 if cols.size else 0
    return (*_mark_layout(torch.from_numpy(blocks).to(dev),
                          torch.from_numpy(cols).to(dev), bound), max_bpr)


# -- K3 ------------------------------------------------------------------------

def _well_formed(blocks, cols, x) -> bool:
    """Every check of :func:`_explain` but the range of ``cols``, as one
    expression: the V-cycle's small SpMVs pay for the wrapper's host
    time."""
    T = torch.Tensor
    if not (isinstance(blocks, T) and isinstance(cols, T)
            and isinstance(x, T)):
        return False
    shape = blocks.shape
    return (len(shape) == 4 and shape[2] == shape[3] and shape[2] >= 1
            and cols.shape == shape[:2] and x.dim() == 1
            and x.numel() % shape[2] == 0 and blocks.dtype in _DTYPES
            and x.dtype in _DTYPES and cols.dtype == torch.int32
            and blocks.is_contiguous() and cols.is_contiguous()
            and x.is_contiguous() and (blocks.is_cuda or blocks.is_cpu)
            and blocks.is_cuda == cols.is_cuda == x.is_cuda
            and blocks.is_cpu == cols.is_cpu == x.is_cpu
            and blocks.get_device() == cols.get_device() == x.get_device())


def _explain(blocks, cols, x) -> None:
    """Raise the error that says why :func:`_well_formed` refused the
    inputs."""
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
    raise ValueError(f"inputs on different devices: {blocks.device}, "
                     f"{cols.device} and {x.device}")


def _check(blocks, cols, x) -> torch.device:
    """Raise unless ``(blocks, cols, x)`` is a block-ELL SpMV the kernel
    takes; returns their device.  The range of ``cols`` is read from its
    check record when that is current (no device sync), else checked with
    ``aminmax``."""
    if not _well_formed(blocks, cols, x):
        _explain(blocks, cols, x)
    ncb = x.numel() // blocks.shape[2]
    bound = checked_bound(cols)
    if bound is not None:
        if bound > ncb:
            raise ValueError(f"block-column ids must lie in [0, {ncb}), got "
                             f"ids up to {bound - 1}")
    elif cols.numel():
        lo, hi = torch.stack(torch.aminmax(cols)).tolist()
        RANGE_CHECKS["spmv_block_ell"] += 1
        if lo < 0 or hi >= ncb:
            raise ValueError(f"block-column ids must lie in [0, {ncb}), got "
                             f"[{lo}, {hi}]")
    return blocks.device


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
    K3, whose :func:`lanes_for` threads a row each sum every lanes-th slot
    before a shuffle tree adds them, float32-allclose to the plain version,
    not bit-equal; on CPU tensors it is :func:`spmv_block_ell_plain`.  No
    device sync when ``cols`` carries a current range-check record
    (:func:`csr_to_block_ell`, :func:`check_cols`).
    """
    if _check(blocks, cols, x).type == "cpu":
        return spmv_block_ell_plain(blocks, cols, x)
    return _spmv_block_ell_cuda(blocks, cols, x)


def _spmv_block_ell_cuda(blocks: torch.Tensor, cols: torch.Tensor,
                         x: torch.Tensor,
                         lanes: int | None = None) -> torch.Tensor:
    """K3's launch on checked CUDA inputs (the output allocated here), with
    ``lanes`` threads a row (``None``: :func:`lanes_for`'s pick; a forced
    power of two up to ``K3_MAX_LANES`` serves the measurements)."""
    nbr, max_bpr, bs, _ = blocks.shape
    if lanes is None:
        lanes = lanes_for(nbr * bs, bs, max_bpr)
    skip = padding_at_end(blocks, cols)
    if not (1 <= lanes <= K3_MAX_LANES and lanes & (lanes - 1) == 0):
        raise ValueError(f"lanes must be a power of two in [1, "
                         f"{K3_MAX_LANES}], got {lanes}")
    y = torch.empty(nbr * bs, dtype=x.dtype, device=x.device)
    if y.numel():
        launch(kernel("spmv_ell", "spmv_block_ell", _ARGTYPES), x.device,
               blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
               y.numel(), max_bpr, bs, int(blocks.dtype == torch.bfloat16),
               int(x.dtype == torch.bfloat16), lanes, int(skip))
        LAUNCHES["spmv_block_ell"] += 1
    return y
