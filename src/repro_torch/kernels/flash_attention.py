"""K4, flash attention forward and backward, and their plain versions.

:func:`flash_attention`
    Causal or full grouped-query attention, ``q`` ``[B, S, H, D]`` against
    ``k``/``v`` ``[B, S, KH, D]``.  It checks shapes, dtypes, devices and
    contiguity from the tensors' metadata alone (no device-to-host read)
    and raises on anything else.  On CUDA tensors it launches K4
    (``csrc/flash_attention.cu``: one thread block per (batch, head, tile
    of 64 query rows), an online softmax over kv tiles staged in shared
    memory) and counts the launch in :data:`LAUNCHES`; on CPU tensors it is
    :func:`flash_attention_plain` — there is no fallback.  K4 has one
    kernel for each dtype, chosen by :func:`_entry_for`: bfloat16 runs on
    the tensor cores (``wgmma``, ``p`` rounded to bfloat16 before P V),
    float32 as float32 FMAs on the CUDA cores.
:func:`flash_attention_plain`
    The reference's oracle ``flash_attention_ref``: an einsum in float32,
    a softmax, an einsum, cast to ``q``'s dtype.
:class:`FlashAttention` and :func:`flash_attention_autograd`
    K4 under autograd: the forward is :func:`flash_attention` (K4's launch
    on CUDA tensors, the plain version on CPU tensors), the backward is
    :func:`flash_attention_backward`.  The TPU kernel has no backward (the
    reference trains through plain jnp attention; its Pallas kernel is its
    production forward only), so the port added one: for bfloat16 on CUDA
    it is K4's backward kernels (``csrc/flash_attention_bwd.cu``: the row
    statistics and dq a tile of queries, then dk and dv a tile of keys, on
    ``wgmma``), counted in :data:`LAUNCHES`; for float32 on CUDA and for CPU and ``meta`` tensors
    it is :func:`flash_attention_backward_plain`, torch ops that recompute
    the softmax from the saved ``q``, ``k`` and ``v`` in float32, one
    block of queries at a time.

Counterpart of ``repro.kernels.flash_attention``, whose Pallas kernel also
needs ``S`` to be a multiple of its 128-row blocks; that is a limit of its
tiling, not of the function, and K4 takes any ``S``.  The kernel is built at
first use by :mod:`repro_torch.kernels.build`; nothing is compiled at
import.
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs

from .build import count, kernel, launch

#: Kernel launches since the counts were last reset: every forward launch,
#: those of the tensor-core (bfloat16) forward alone, and the backward's
#: calls (one a backward: its two kernels on the stream).
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_bwd": 0}
#: Head dims K4 is compiled for.
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30

_I = ctypes.c_int
_ARGTYPES = (ctypes.c_void_p,) * 4 + (_I,) * 7 + (ctypes.c_float,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 10 + (_I,) * 6 + (ctypes.c_float,)
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    """Set the launch counts to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _entry_for(dtype: torch.dtype, head_dim: int) -> str:
    """Which of K4's kernels takes inputs of ``dtype`` and ``head_dim``:
    ``"tc"`` (bfloat16, on the tensor cores) or ``"fma"`` (float32, FMAs
    on the CUDA cores).  A dispatch on the dtype, not a fallback."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not supported; K4 takes "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"K4 takes float32 or bfloat16, got {dtype}")


def _check(q, k, v) -> torch.device:
    """Raise unless ``(q, k, v)`` is an attention K4 takes; returns their
    device.  Reads metadata only, so it never waits on the card."""
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{what} must be 4-D, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{what} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if isinstance(t, DTensor):
            raise TypeError(f"{what} is a DTensor: a layout hands K4 its "
                            "local shards (local_map)")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{what} lies on unsupported device {t.device}")
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share batch, sequence and head dim")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} must be a multiple of "
                         f"KH={k.shape[2]}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not supported; K4 takes "
                         f"{HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{k.device} and {v.device}")
    return q.device


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version of K4: exact softmax attention in float32."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, D).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) / (D ** 0.5)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Grouped-query attention forward.

    ``q`` ``[B, S, H, D]``, ``k``/``v`` ``[B, S, KH, D]``: contiguous, one
    dtype (float32 or bfloat16), ``H`` a multiple of ``KH`` (query head
    ``h`` reads kv head ``h // (H // KH)``), ``D`` in :data:`HEAD_DIMS`, any
    ``S``.  Scale ``1 / sqrt(D)``; returns ``[B, S, H, D]`` in ``q``'s
    dtype.  On CUDA tensors this is one launch of K4: for float32 inputs
    the FMA kernel, float32-allclose to the plain version (the sums run in
    another order); for bfloat16 the tensor-core kernel, which rounds the
    softmax weights ``p`` to bfloat16 before ``P V`` (as a TPU's matrix
    unit does at default precision), moving a row by at most ``2^-9 max_j
    |v_j|`` beyond the float32 result (``l`` is summed from the unrounded
    ``p``); it needs 16-byte aligned inputs.  On CPU tensors it is
    :func:`flash_attention_plain`; on ``meta`` tensors (the dry run's
    trace: shapes only) it is the plain version's shapes, and builds and
    launches nothing.  A DTensor is refused: a layout hands K4 its local
    shards.
    """
    if _check(q, k, v).type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal)
    return _flash_attention_cuda(q, k, v, causal)


def _flash_attention_cuda(q, k, v, causal: bool) -> torch.Tensor:
    """K4's launch on checked CUDA inputs (the output allocated here)."""
    B, S, H, D = q.shape
    entry = _entry_for(q.dtype, D)
    out = torch.empty_like(q)
    if not out.numel():
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tc = entry == "tc"
    if tc and any(p % 16 for p in ptrs):
        raise ValueError("K4's bfloat16 kernel copies 16 bytes at a time: "
                         "q, k and v must be 16-byte aligned")
    launch(kernel("flash_attention", "flash_attention_fwd", _ARGTYPES),
           q.device, *ptrs, B, S, H, k.shape[2], D, int(bool(causal)),
           int(tc), 1.0 / D ** 0.5)
    count(LAUNCHES, "flash_attention", *(["flash_attention_tc"] if tc
                                         else []))
    return out


#: Score elements (float32) a block of queries of the backward holds at
#: once in each of its four ``[B, KH, rep, rows, S]`` temporaries.
BACKWARD_BLOCK_ELEMS = 1 << 26


def backward_rows(B: int, H: int, S: int) -> int:
    """Queries a block of :func:`flash_attention_backward` takes: as many
    as keep ``B * H * rows * S`` within :data:`BACKWARD_BLOCK_ELEMS`, at
    least 1 and at most ``S``."""
    return max(1, min(S, BACKWARD_BLOCK_ELEMS // max(1, B * H * S)))


def flash_attention_backward(q, k, v, out, dout, causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k,
    v)``, given its output ``out`` and the output's gradient ``dout``; each
    gradient has its input's dtype.

    The path follows the inputs, with no fallback: bfloat16 on CUDA is one
    call of K4's backward kernels (:func:`_flash_attention_backward_cuda`,
    counted in ``LAUNCHES["flash_attention_bwd"]``), which round P and dS
    to bfloat16 before their products as the reference's bf16 autodiff
    does; float32 on CUDA, and any CPU or ``meta`` input, is
    :func:`flash_attention_backward_plain`.
    """
    return _backward_entry(q)(q, k, v, out, dout, causal)


def _backward_entry(q):
    """Which backward takes ``q``'s device and dtype: K4's backward kernels
    for bfloat16 on CUDA, else the plain version (float32 on CUDA, and
    CPU and ``meta`` tensors, the dry run's shapes)."""
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        return _flash_attention_backward_cuda
    return flash_attention_backward_plain


def flash_attention_backward_plain(q, k, v, out, dout, causal: bool = True):
    """Plain version of K4's backward, and the float32 route of
    :func:`flash_attention_backward` (a float32 CUDA input takes it: there
    is no float32 backward kernel).

    Torch ops in float32, one block of :func:`backward_rows` queries at a
    time, so no ``[B, H, S, S]`` tensor is live whole: the scores and
    softmax ``P`` of the block are recomputed from ``q`` and ``k`` (under
    the causal mask only the keys up to the block's last query), then
    ``dV += P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))``, ``dQ = dS K
    scale`` and ``dK += dS^T Q scale``, each kv head's gradients summed
    over its group of query heads.  Each gradient has its input's dtype.
    """
    B, S, H, D = q.shape
    KH = k.shape[2]
    rep = H // KH
    scale = 1.0 / D ** 0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty(B, S, H, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, S, KH, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    # rowsum(dO * O): [B, KH, rep, S]
    delta = (dout.float() * out.float()).sum(-1).reshape(
        B, S, KH, rep).permute(0, 2, 3, 1)
    rows = backward_rows(B, H, S)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        ke = s1 if causal else S
        qb = q[:, s0:s1].float().reshape(B, s1 - s0, KH, rep, D)
        dob = dout[:, s0:s1].float().reshape(B, s1 - s0, KH, rep, D)
        kb, vb = kf[:, :ke], vf[:, :ke]
        s = torch.einsum("bqhrd,bkhd->bhrqk", qb, kb) * scale
        if causal:
            s = s.masked_fill(pos[s0:s1, None] < pos[None, :ke], NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv[:, :ke] += torch.einsum("bhrqk,bqhrd->bkhd", p, dob)
        ds = torch.einsum("bqhrd,bkhd->bhrqk", dob, vb)
        ds = p * (ds - delta[..., s0:s1, None])
        dq[:, s0:s1] = torch.einsum("bhrqk,bkhd->bqhrd", ds, kb).reshape(
            B, s1 - s0, H, D) * scale
        dk[:, :ke] += torch.einsum("bhrqk,bqhrd->bkhd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_row_stats_plain(q, k, out, dout, causal: bool = True):
    """Plain version of the row statistics K4's backward recomputes:
    ``lse`` ``[B, H, S]``, each query row's log-sum-exp of its scaled,
    masked scores (its running max and sum over blocks of
    :func:`backward_rows` keys, as the kernel takes them over kv tiles),
    and ``delta`` ``[B, H, S]``, ``rowsum(dO * O)``; both float32."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qg = q.float().reshape(B, S, KH, H // KH, D)
    m = torch.full((B, KH, H // KH, S), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    pos = torch.arange(S, device=q.device)
    cols = backward_rows(B, H, S)
    for k0 in range(0, S, cols):
        k1 = min(S, k0 + cols)
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k[:, k0:k1].float()) / (
            D ** 0.5)
        if causal:
            s = s.masked_fill(pos[:, None] < pos[None, k0:k1], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            s - m_new[..., None]).sum(-1)
        m = m_new
    lse = (m + torch.log(l)).reshape(B, H, S)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    return lse, delta


def _flash_attention_backward_cuda(q, k, v, out, dout, causal: bool):
    """K4's backward kernels on CUDA bfloat16 inputs: ``(dq, dk, dv)``."""
    return _backward_launch(q, k, v, out, dout, causal)[:3]


def _backward_launch(q, k, v, out, dout, causal: bool):
    """One call of ``csrc/flash_attention_bwd.cu`` (its two kernels on the
    current stream): ``(dq, dk, dv, lse, delta)``, the last two the row
    statistics it recomputed, float32 ``[B, H, S]``.  Checks the inputs'
    metadata and raises on what the kernels do not take; ``dout`` is made
    contiguous (autograd may hand an expanded gradient)."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"K4's backward kernels take bfloat16, got {q.dtype}")
    dout = dout.contiguous()
    for t, what in ((out, "out"), (dout, "dout")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what} must match q ({tuple(q.shape)}, "
                             f"{q.dtype}, {q.device}), got "
                             f"{tuple(t.shape)}, {t.dtype}, {t.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    B, S, H, D = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    Sp = -(-S // 64) * 64
    lse = torch.empty(B, H, Sp, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    if not q.numel():
        return dq, dk, dv, lse[..., :S], delta[..., :S]
    torch.ops.repro_torch.flash_attention_bwd(
        *(t.detach() for t in (q, k, v, out, dout)), dq, dk, dv, lse, delta,
        bool(causal))
    count(LAUNCHES, "flash_attention_bwd")
    return dq, dk, dv, lse[..., :S], delta[..., :S]


def _flash_attention_bwd_op(q, k, v, out, dout, dq, dk, dv, lse, delta,
                            causal: bool) -> None:
    """CUDA kernel of the operator ``repro_torch::flash_attention_bwd``:
    one call of ``csrc/flash_attention_bwd.cu``'s C entry on the current
    stream, writing ``dq``, ``dk``, ``dv``, ``lse`` and ``delta`` (shapes
    as :func:`_backward_launch` makes them)."""
    ptrs = tuple(t.data_ptr() for t in (q, k, v, out, dout, dq, dk, dv, lse,
                                        delta))
    if any(p % 16 for p in ptrs):
        raise ValueError("K4's backward copies 16 bytes at a time: q, k, v, "
                         "out and dout must be 16-byte aligned")
    B, S, H, D = q.shape
    launch(kernel("flash_attention_bwd", "flash_attention_bwd",
                  _BWD_ARGTYPES),
           q.device, *ptrs, B, S, H, k.shape[2], D, int(causal),
           1.0 / D ** 0.5)


# K4's backward is an operator with a CUDA kernel only, so that it is an op
# inside its caller's spans: the profiler books a kernel to the innermost
# op open when it was launched, never to a ``record_function`` span, and the
# innermost op around a backward is autograd's node, outside every span the
# backward opens (the forward's launch books to ``FlashAttention``'s op).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor dout, Tensor(a!) dq, Tensor(b!) dk, Tensor(c!) dv, "
            "Tensor(d!) lse, Tensor(e!) delta, bool causal) -> ()")
_LIB.impl("flash_attention_bwd", _flash_attention_bwd_op, "CUDA")


class FlashAttention(torch.autograd.Function):
    """K4 under autograd: :func:`flash_attention` forward (the launch on
    CUDA tensors, counted in :data:`LAUNCHES`; the plain version on CPU
    tensors), :func:`flash_attention_backward` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        out = flash_attention(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        B, S, H, D = q.shape
        with obs.span("repro_torch.attn_bwd", B=B, S=S, H=H, KH=k.shape[2],
                      D=D, causal=bool(ctx.causal)):
            return (*flash_attention_backward(q, k, v, out, dout,
                                              ctx.causal), None)


def flash_attention_autograd(q, k, v, causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention` that autograd differentiates
    (:class:`FlashAttention`); under ``torch.no_grad`` it is the same one
    launch."""
    return FlashAttention.apply(q, k, v, causal)
