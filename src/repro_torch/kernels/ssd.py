"""K5, the Mamba2 SSD intra-chunk step, and its plain version.

For each program g (one batch row, chunk and head) of a chunked SSD scan::

    scores[i,j] = (C_i . B_j) * exp(cumA_i - cumA_j)   for i >= j, else 0
    y[i]        = sum_j scores[i,j] * dtx[j]                  [q, p]
    S_c         = sum_j exp(cumA_last - cumA_j) B_j dtx_j^T   [n, p]

:func:`ssd_intra_chunk`
    Checks shapes, dtypes, devices and shared-memory size from the tensors'
    metadata alone (no device-to-host read) and raises on anything else.
    On CUDA tensors it launches K5 (``csrc/ssd.cu``) and adds one to both
    counts of :data:`LAUNCHES`; on CPU tensors it is
    :func:`ssd_intra_chunk_plain` — there is no fallback.  K5 is one
    kernel: a block takes one (batch, chunk) and a group of its heads that
    share B and C, forms the lower triangle of ``C B^T`` once for the group
    and, head by head, the decayed scores, ``y`` and ``S_c``.  Every
    product runs on the tensor cores as three TF32 products (``a = hi +
    lo``, ``hi hi + hi lo + lo hi``), which keeps it float32-accurate.
:func:`ssd_intra_chunk_plain`
    The reference's oracle ``ssd_intra_chunk_ref`` in float32 einsums.
:class:`SsdIntraChunk` and :func:`ssd_intra_chunk_autograd`
    K5 under autograd: the forward is :func:`ssd_intra_chunk` (K5's launch
    on CUDA tensors, the plain version on CPU tensors), the backward is
    :func:`ssd_intra_chunk_backward`, torch ops on the saved inputs.  There
    is no backward kernel because the TPU kernel has none: the reference
    trains through its plain jnp SSD, and its Pallas kernel is its
    production forward only.

Every input is either ``[G, q, x]`` as in the reference, or ``[G1, h, q, x]``
with ``G = G1 * h`` (program ``g = g1 * h + head``) and any strides.  The
second form lets :func:`repro_torch.nn.ssm.ssd_chunked` pass ``B`` and ``C``
of a (batch, chunk) expanded over its heads with stride 0, and ``dtx`` and
``cumA`` as transposed views, with no copies.  Counterpart of
``repro.kernels.ssd``; the kernel is built at first use by
:mod:`repro_torch.kernels.build`, nothing is compiled at import.
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs

from .build import count, kernel, launch

#: Kernel launches since the counts were last reset: every launch, and
#: those on the tensor cores (all of them: K5 has no other kernel).
LAUNCHES = {"ssd_intra_chunk": 0, "ssd_intra_chunk_tc": 0}
#: Shared memory one thread block may use on Hopper.
MAX_SMEM = 232448
#: Largest chunk length, state size and head dim K5 takes.
MAX_Q = MAX_N = MAX_P = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P,) * 7 + (_I,) * 5


def reset_launches() -> None:
    """Set the launch counts to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(q: int, n: int, p: int) -> int:
    """Shared memory of one K5 block, float32 (``dims_of`` and
    ``smem_floats`` in ``csrc/ssd.cu``): the ``16 x 8`` tiles of ``C B^T``
    on or below the diagonal, ``B^T`` ``[n, q]``, two dtx buffers ``[q,
    p]`` (which first hold C ``[q, n]``) and two cumA buffers, with q
    padded to 16, n to 16 and p to 32."""
    qp, np_, pp = _up(q, 16), _up(n, 16), _up(p, 32)
    tiles = qp // 16 * (qp // 16 + 1)
    return 4 * (128 * tiles + np_ * qp + max(2 * qp * pp, qp * np_) + 2 * qp)


def _as4(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(1) if t.dim() == 3 else t


def _check(dtx, Bm, Cm, cumA):
    """Raise unless the inputs are an intra-chunk step K5 takes; returns
    ``(device, G, heads, q, n, p)``.  Metadata only: it never waits on the
    card."""
    named = (("dtx", dtx), ("Bm", Bm), ("Cm", Cm), ("cumA", cumA))
    for what, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() not in (3, 4):
            raise ValueError(f"{what} must be [G, q, x] or [G1, h, q, x], "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} must be float32, got {t.dtype}")
        if isinstance(t, DTensor):
            raise TypeError(f"{what} is a DTensor: a layout hands K5 its "
                            "local shards (local_map)")
        if t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{what} lies on unsupported device {t.device}")
    d4, b4, c4, a4 = (_as4(t) for _, t in named)
    G1, heads, q, p = d4.shape
    n = b4.shape[-1]
    if b4.shape != c4.shape or b4.shape[:3] != (G1, heads, q):
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} "
                         f"must be [*, q, n] matching dtx {tuple(dtx.shape)}")
    if a4.shape != (G1, heads, q, 1):
        raise ValueError(f"cumA must be [*, q, 1] matching dtx, got "
                         f"{tuple(cumA.shape)}")
    if min(q, n, p) < 1 or q > MAX_Q or n > MAX_N or p > MAX_P:
        raise ValueError(f"q, n and p must be 1 to {MAX_Q}, got {q}, {n}, "
                         f"{p}")
    if smem_bytes(q, n, p) > MAX_SMEM:
        raise ValueError(f"q={q}, n={n}, p={p} needs {smem_bytes(q, n, p)} "
                         f"bytes of shared memory a block; K5 has "
                         f"{MAX_SMEM}")
    dev = dtx.device
    if any(t.device != dev for _, t in named):
        raise ValueError("inputs on different devices: "
                         + ", ".join(str(t.device) for _, t in named))
    return dev, G1 * heads, heads, q, n, p


def ssd_intra_chunk_plain(dtx, Bm, Cm, cumA):
    """Plain version of K5 on ``[G, q, x]`` or ``[G1, h, q, x]`` inputs;
    returns ``(y [G, q, p], S_c [G, n, p])`` in float32."""
    d4, b4, c4, a4 = (_as4(t) for t in (dtx, Bm, Cm, cumA))
    G1, heads, q, p = d4.shape
    cum = a4[..., 0]                                        # [G1, h, q]
    cb = torch.einsum("ghin,ghjn->ghij", c4, b4)
    ln = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=dtx.device).tril()
    scores = cb * torch.exp(ln.masked_fill(~mask, -1e30))
    y = torch.einsum("ghij,ghjp->ghip", scores, d4)
    seg = torch.exp(cum[..., -1:] - cum)                     # [G1, h, q]
    s = torch.einsum("ghjn,ghj,ghjp->ghnp", b4, seg, d4)
    n = b4.shape[-1]
    return y.reshape(G1 * heads, q, p), s.reshape(G1 * heads, n, p)


def ssd_intra_chunk(dtx, Bm, Cm, cumA):
    """Batched intra-chunk SSD.

    ``dtx`` ``[G, q, p]`` (``dt_j * x_j``), ``Bm``/``Cm`` ``[G, q, n]``,
    ``cumA`` ``[G, q, 1]`` (inclusive cumulative log-decay), all float32;
    or each ``[G1, h, q, x]`` with any strides.  Returns ``(y_intra [G, q,
    p], S_c [G, n, p])``, contiguous float32.  On CUDA tensors this is one
    launch of K5 (``q, n, p`` at most 128 and within :data:`MAX_SMEM` bytes
    of shared memory a block, :func:`smem_bytes`), float32-allclose to the
    plain version; on CPU tensors it is :func:`ssd_intra_chunk_plain`;
    on ``meta`` tensors (the dry run's trace: shapes only) it is the plain
    version's shapes, and builds and launches nothing.  A DTensor is
    refused: a layout hands K5 its local shards.
    """
    dev, G, heads, q, n, p = _check(dtx, Bm, Cm, cumA)
    if dev.type in ("cpu", "meta"):
        return ssd_intra_chunk_plain(dtx, Bm, Cm, cumA)
    return _ssd_intra_chunk_cuda(dtx, Bm, Cm, cumA, G, heads, q, n, p)


def _ssd_intra_chunk_cuda(dtx, Bm, Cm, cumA, G, heads, q, n, p):
    """K5's launch on checked CUDA inputs (the outputs allocated here)."""
    y = torch.empty(G, q, p, dtype=torch.float32, device=dtx.device)
    s = torch.empty(G, n, p, dtype=torch.float32, device=dtx.device)
    if G:
        strides = (ctypes.c_longlong * 16)(
            *(st for t in (dtx, Bm, Cm, cumA) for st in _as4(t).stride()))
        launch(kernel("ssd", "ssd_intra_chunk", _ARGTYPES), dtx.device,
               dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), cumA.data_ptr(),
               y.data_ptr(), s.data_ptr(), strides, G, heads, q, n, p)
        count(LAUNCHES, "ssd_intra_chunk", "ssd_intra_chunk_tc")
    return y, s


def ssd_intra_chunk_backward(dtx, Bm, Cm, cumA, dy, dS):
    """Gradients ``(d dtx, dBm, dCm, d cumA)`` of :func:`ssd_intra_chunk`
    at its inputs, given the gradients ``dy`` [G, q, p] and ``dS`` [G, n,
    p] of its outputs; torch ops in float32.

    With ``L[i,j] = exp(cumA_i - cumA_j)`` on and below the diagonal (else
    0), ``scores = (C B^T) * L``, ``y = scores dtx`` and ``S_c = B^T (seg *
    dtx)``, ``seg_j = exp(cumA_last - cumA_j)``: ``dscores = dy dtx^T``,
    ``d dtx = scores^T dy + seg * (B dS)``, ``dC = (dscores * L) B``, ``dB
    = (dscores * L)^T C + seg * (dtx dS^T)``, and ``d cumA`` from ``M =
    dscores * scores`` (row sums less column sums) and ``r = seg * rowsum((B
    dS) * dtx)`` (less ``r``, its sum added at the last position).  Each
    gradient has the shape of its input, so a ``B`` or ``C`` expanded over
    the heads with stride 0 gets a gradient a head, which the expand's own
    backward sums; no input is written."""
    d4, b4, c4, a4 = (_as4(t) for t in (dtx, Bm, Cm, cumA))
    G1, heads, q, p = d4.shape
    n = b4.shape[-1]
    dy4 = dy.reshape(G1, heads, q, p).float()
    ds4 = dS.reshape(G1, heads, n, p).float()
    cum = a4[..., 0]
    mask = torch.ones(q, q, dtype=torch.bool, device=dtx.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :])
                      .masked_fill(~mask, -1e30))
    scores = torch.einsum("ghin,ghjn->ghij", c4, b4) * decay
    seg = torch.exp(cum[..., -1:] - cum)
    dscores = torch.einsum("ghip,ghjp->ghij", dy4, d4)
    bds = torch.einsum("ghjn,ghnp->ghjp", b4, ds4)
    d_dtx = torch.einsum("ghij,ghip->ghjp", scores, dy4) + seg[..., None] * bds
    dcb = dscores * decay
    dC = torch.einsum("ghij,ghjn->ghin", dcb, b4)
    dB = torch.einsum("ghij,ghin->ghjn", dcb, c4) + seg[..., None] \
        * torch.einsum("ghjp,ghnp->ghjn", d4, ds4)
    m = dscores * scores
    r = seg * (bds * d4).sum(-1)
    d_cum = m.sum(-1) - m.sum(-2) - r
    d_cum[..., -1] += r.sum(-1)
    return (d_dtx.reshape(dtx.shape), dB.reshape(Bm.shape),
            dC.reshape(Cm.shape), d_cum.reshape(cumA.shape))


class SsdIntraChunk(torch.autograd.Function):
    """K5 under autograd: :func:`ssd_intra_chunk` forward (the launch on
    CUDA tensors, counted in :data:`LAUNCHES`; the plain version on CPU
    tensors), :func:`ssd_intra_chunk_backward` backward."""

    @staticmethod
    def forward(ctx, dtx, Bm, Cm, cumA):
        ctx.save_for_backward(dtx, Bm, Cm, cumA)
        return ssd_intra_chunk(dtx, Bm, Cm, cumA)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dS):
        with obs.span("repro_torch.ssd_bwd"):
            return ssd_intra_chunk_backward(*ctx.saved_tensors, dy, dS)


def ssd_intra_chunk_autograd(dtx, Bm, Cm, cumA):
    """:func:`ssd_intra_chunk` that autograd differentiates
    (:class:`SsdIntraChunk`); under ``torch.no_grad`` it is the same one
    launch."""
    return SsdIntraChunk.apply(dtx, Bm, Cm, cumA)
