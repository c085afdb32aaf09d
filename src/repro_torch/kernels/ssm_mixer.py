"""The Mamba2 mixer's elementwise passes around K5, fused into two kernels,
and their plain versions.

:func:`prologue`
    From ``in_proj``'s output, ``xBC`` ``[b, l, di + 2 n]`` and ``dt`` ``[b,
    l, h]`` (slices of ``zxbcdt``), to K5's inputs: the depthwise causal
    conv, its bias and SiLU (float32 sums, one rounding to the activations'
    dtype), ``dt = softplus(dt + dt_bias)``, ``cumA`` (the inclusive sum of
    ``-exp(A_log) dt`` over each chunk) and ``dt x``.  On CUDA tensors one
    launch of ``ssm_prologue`` (``csrc/ssm_mixer.cu``), counted in
    :data:`LAUNCHES`; on CPU and ``meta`` tensors :func:`prologue_plain`.
:func:`epilogue`
    From K5's ``y_intra``, the inter-chunk product ``C S_in``, ``cumA``,
    ``x`` and ``z`` to ``out_proj``'s input: ``y_intra + exp(cumA) C S_in +
    D x``, the gate ``silu(z)`` and the RMSNorm, float32 throughout and one
    rounding.  One launch of ``ssm_epilogue`` on CUDA tensors;
    :func:`epilogue_plain` on the others.  Given the process ``group`` over
    which a tensor-parallel layout splits the heads, the norm's sum of
    squares spans the group: two launches around an all-reduce.

Both are autograd Functions: the backward runs the plain version again on
the saved inputs under autograd and takes its gradients (the kernels have
no backward of their own; the JAX package trains through jnp ops here).

K5's layout, which both sides share: ``dtx`` ``[b nc, h, q, p]``, ``Bm``
and ``Cm`` ``[b nc, q, n]``, ``cumA`` ``[b nc, h, q, 1]``, all float32,
``nc = l / q`` chunks of ``q = min(chunk, l)`` positions.

The plain versions are the mixer's torch ops, which
:func:`repro_torch.nn.ssm.ssm_mixer` also runs on CPU and ``meta`` tensors,
piece by piece: :func:`conv_plain`, :func:`scan_inputs_plain` and
:func:`combine_plain`.  On bf16 inputs they round where the mixer always
rounded (the conv's taps and sums, ``y`` before the gate, the gate itself);
the kernels keep float32 from the conv through the norm and round once at
each output, so the two differ by those bf16 roundings, and on float32
inputs by float32 round-off.

Port-only: the JAX package leaves these passes to XLA as jnp ops and has no
Pallas kernel for them.  The kernels are built at first use by
:mod:`repro_torch.kernels.build`; nothing is compiled at import.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.nn.functional import all_reduce
from torch.distributed.tensor import DTensor

from .build import count, kernel, launch
from .ssd import MAX_N, MAX_P, MAX_Q

#: Kernel launches since the counts were last reset.
LAUNCHES = {"ssm_prologue": 0, "ssm_epilogue": 0}
#: Largest conv kernel, and the widest ``di`` the epilogue takes (1024
#: threads of 32 channels).
MAX_K = 4
MAX_DI = 32768
#: The activations' dtypes the kernels take, by their code in the C entries.
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def reset_launches() -> None:
    """Set every count of :data:`LAUNCHES` to zero."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PROLOGUE_ARGS = (_P, _L, _P, _L) + (_P,) * 9 + (_I,) * 8
_EPILOGUE_ARGS = (_P,) * 6 + (_L,) + (_P,) * 4 + (_I,) * 6 \
    + (ctypes.c_float,) * 2 + (_I,)


# -- the plain versions: the mixer's torch ops --------------------------------
def conv_plain(pad, w, b):
    """Depthwise conv of ``pad`` ``[b, l + K - 1, C]`` (the sequence with
    K - 1 leading zero rows) over the taps ``w`` ``[K, C]``, plus ``b``,
    then SiLU: ``[b, l, C]`` in ``pad``'s dtype.  Taps and sums in the
    promoted dtype of ``pad`` and ``w``, SiLU in float32."""
    K = w.shape[0]
    L = pad.shape[1] - K + 1
    out = sum(pad[:, k:k + L, :] * w[k] for k in range(K))
    return F.silu((out + b).float()).to(pad.dtype)


def scan_inputs_plain(x, Bm, Cm, dt, A_log, chunk: int):
    """K5's inputs from the scan's: ``x`` ``[b, l, h, p]``, ``Bm``/``Cm``
    ``[b, l, n]``, ``dt`` ``[b, l, h]`` (post-softplus), ``A_log`` ``[h]``
    or ``[b, h]``.  Returns ``(dtx, Bm, Cm, cumA)`` in K5's layout (float32;
    ``dtx`` and ``cumA`` transposed views).  Raises unless the chunk
    divides the sequence."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    nc = l // q
    if nc * q != l:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    bc = b * nc
    xr = x.reshape(b, nc, q, h, p)
    Br = Bm.reshape(bc, q, n).float()
    Cr = Cm.reshape(bc, q, n).float()
    dtr = dt.reshape(b, nc, q, h).float()
    A_log = A_log.float().reshape(-1 if A_log.ndim == 2 else 1, 1, 1, h)
    a = -torch.exp(A_log) * dtr                            # [b,nc,q,h]
    cumA = torch.cumsum(a, dim=2)                          # inclusive
    dtx = xr.float() * dtr[..., None]                      # dt_j * x_j
    return (dtx.permute(0, 1, 3, 2, 4).reshape(bc, h, q, p), Br, Cr,
            cumA.permute(0, 1, 3, 2).reshape(bc, h, q, 1))


def combine_plain(y_intra, CS, cumA, x, D):
    """The scan's output ``y_intra + exp(cumA) C S_in + D x``, ``[b, l, h,
    p]`` float32: ``y_intra`` K5's ``[b nc h, q, p]``, ``CS`` the
    inter-chunk product ``[b, nc, q, h, p]``, ``cumA`` ``[b nc, h, q, 1]``,
    ``x`` ``[b, l, h, p]``, ``D`` ``[h]`` or ``[b, h]``."""
    b, l, h, p = x.shape
    q = cumA.shape[2]
    nc = l // q
    D = D.float().reshape(-1 if D.ndim == 2 else 1, 1, 1, h)
    y_intra = y_intra.reshape(b, nc, h, q, p).permute(0, 1, 3, 2, 4)
    decay = torch.exp(cumA.reshape(b, nc, h, q).permute(0, 1, 3, 2))
    y = y_intra + CS * decay[..., None] \
        + D[..., None] * x.reshape(b, nc, q, h, p).float()
    return y.reshape(b, l, h, p)


def prologue_plain(xBC, dt, conv_w, conv_b, dt_bias, A_log, state: int,
                   chunk: int):
    """Plain version of :func:`prologue`: ``(dtx, Bm, Cm, cumA, x)``, the
    first four in K5's layout, ``x`` ``[b, l, di]`` in ``xBC``'s dtype."""
    b, l, _ = xBC.shape
    K, h = conv_w.shape[0], dt.shape[-1]
    di = xBC.shape[-1] - 2 * state
    xBC = conv_plain(F.pad(xBC, (0, 0, K - 1, 0)), conv_w, conv_b)
    x = xBC[..., :di]
    dt = F.softplus(dt.float() + dt_bias.float())
    return (*scan_inputs_plain(x.reshape(b, l, h, di // h),
                               xBC[..., di:di + state], xBC[..., di + state:],
                               dt, A_log, chunk), x)


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def epilogue_plain(y_intra, CS, cumA, x, z, D, norm, eps: float,
                   group=None):
    """Plain version of :func:`epilogue`: ``[b, l, di]`` in ``x``'s dtype.
    ``y`` and the gate round to that dtype (where the mixer always rounded
    them) and the norm runs in float32, as ``nn.layers.rmsnorm``; over
    ``group`` the mean of the squares spans its ranks' heads."""
    b, l, di = x.shape
    h = cumA.shape[1]
    y = combine_plain(y_intra, CS, cumA, x.reshape(b, l, h, di // h), D)
    g = (y.reshape(b, l, di).to(x.dtype)
         * F.silu(z.float()).to(x.dtype)).float()
    if _group_size(group) == 1:
        var = (g * g).mean(dim=-1, keepdim=True)
    else:
        # the sum of the squares over the group's ranks, under autograd
        var = all_reduce((g * g).sum(dim=-1, keepdim=True), group=group) \
            / (di * _group_size(group))
    return (g * torch.rsqrt(var + eps) * norm.float()).to(x.dtype)


# -- checks -------------------------------------------------------------------
def _tensors(named) -> torch.device:
    """Raise unless every ``(name, t)`` is a plain tensor on one supported
    device; returns the device."""
    for what, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if isinstance(t, DTensor):
            raise TypeError(f"{what} is a DTensor: the mixer's kernels take "
                            "local shards (nn.ssm runs them through "
                            "head_local or item_local)")
        if t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{what} lies on unsupported device {t.device}")
    dev = named[0][1].device
    if any(t.device != dev for _, t in named):
        raise ValueError("inputs on different devices: "
                         + ", ".join(f"{w} {t.device}" for w, t in named))
    return dev


def _dtype(what: str, t, dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{what} must be "
                        + " or ".join(str(d) for d in dtypes)
                        + f", got {t.dtype}")


def _shape(what: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _sizes(q: int, n: int, p: int, di: int) -> None:
    if q > MAX_Q or n > MAX_N or p > MAX_P:
        raise ValueError(f"q, n and p must be at most {MAX_Q} (K5's "
                         f"limits), got {q}, {n}, {p}")
    if di > MAX_DI:
        raise ValueError(f"di {di} is past the epilogue's {MAX_DI}")


def _check_prologue(xBC, dt, conv_w, conv_b, dt_bias, A_log, state: int,
                    chunk: int):
    """Raise unless the inputs are a prologue the kernel takes; returns
    ``(device, b, l, q, h, p, K)``.  Metadata only."""
    dev = _tensors((("xBC", xBC), ("dt", dt), ("conv_w", conv_w),
                    ("conv_b", conv_b), ("dt_bias", dt_bias),
                    ("A_log", A_log)))
    _dtype("xBC", xBC, tuple(DTYPES))
    _dtype("dt", dt, (xBC.dtype,))
    for what, t in (("conv_w", conv_w), ("conv_b", conv_b),
                    ("dt_bias", dt_bias), ("A_log", A_log)):
        if not t.is_floating_point():
            raise TypeError(f"{what} must be floating point, got {t.dtype}")
    if xBC.dim() != 3 or dt.dim() != 3 or conv_w.dim() != 2:
        raise ValueError(f"xBC must be [b, l, di + 2 n], dt [b, l, h] and "
                         f"conv_w [K, di + 2 n], got {tuple(xBC.shape)}, "
                         f"{tuple(dt.shape)} and {tuple(conv_w.shape)}")
    b, l, C = xBC.shape
    h, K, di = dt.shape[-1], conv_w.shape[0], C - 2 * state
    if dt.shape[:2] != xBC.shape[:2] or state < 1 or h < 1 or di < h \
            or di % h or conv_w.shape[1] != C:
        raise ValueError(f"xBC {tuple(xBC.shape)}, dt {tuple(dt.shape)} and "
                         f"conv_w {tuple(conv_w.shape)} are no [b, l, di + 2 "
                         f"n], [b, l, h] and [K, di + 2 n] with n = {state} "
                         "and di a multiple of h")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the conv kernel must be 1 to {MAX_K} taps, got {K}")
    _shape("conv_b", conv_b, (C,))
    _shape("dt_bias", dt_bias, (h,))
    _shape("A_log", A_log, (h,))
    if l < 1 or chunk < 1:
        raise ValueError(f"the sequence ({l}) and chunk ({chunk}) must be "
                         "at least 1")
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"seq {l} not divisible by chunk {q}")
    p = di // h
    _sizes(q, state, p, di)
    return dev, b, l, q, h, p, K


def _check_epilogue(y_intra, CS, cumA, x, z, D, norm):
    """Raise unless the inputs are an epilogue the kernel takes; returns
    ``(device, b, l, q, h, p)``.  Metadata only."""
    dev = _tensors((("y_intra", y_intra), ("CS", CS), ("cumA", cumA),
                    ("x", x), ("z", z), ("D", D), ("norm", norm)))
    for what, t in (("y_intra", y_intra), ("CS", CS), ("cumA", cumA)):
        _dtype(what, t, (torch.float32,))
    _dtype("x", x, tuple(DTYPES))
    _dtype("z", z, (x.dtype,))
    if x.dim() != 3 or cumA.dim() != 4:
        raise ValueError(f"x must be [b, l, di] and cumA [b nc, h, q, 1], got "
                         f"{tuple(x.shape)} and {tuple(cumA.shape)}")
    b, l, di = x.shape
    bc, h, q, _ = cumA.shape
    if h < 1 or di % h or q < 1 or l % q or bc != b * (l // q):
        raise ValueError(f"cumA {tuple(cumA.shape)} is no [b nc, h, q, 1] "
                         f"of x {tuple(x.shape)}")
    p, nc = di // h, l // q
    _shape("cumA", cumA, (bc, h, q, 1))
    _shape("y_intra", y_intra, (bc * h, q, p))
    _shape("CS", CS, (b, nc, q, h, p))
    _shape("z", z, (b, l, di))
    _shape("D", D, (h,))
    _shape("norm", norm, (di,))
    _sizes(q, 1, p, di)
    return dev, b, l, q, h, p


def _rows(t):
    """``t`` ``[b, l, c]`` with unit channel stride and evenly spaced rows
    (a slice of a contiguous tensor, as ``zxbcdt``'s are), else a
    contiguous copy; and its row (token) stride."""
    if t.stride(-1) != 1 or t.stride(0) != t.shape[1] * t.stride(1):
        t = t.contiguous()
    return t, t.stride(1)


def _f32(*ts):
    return tuple(t.float().contiguous() for t in ts)


# -- the forward calls --------------------------------------------------------
def _prologue(xBC, dt, conv_w, conv_b, dt_bias, A_log, state: int,
              chunk: int):
    dev, b, l, q, h, p, K = _check_prologue(xBC, dt, conv_w, conv_b, dt_bias,
                                            A_log, state, chunk)
    if dev.type != "cuda":
        return prologue_plain(xBC, dt, conv_w, conv_b, dt_bias, A_log, state,
                              chunk)
    bc = b * (l // q)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty(bc, h, q, p, **f32), torch.empty(bc, q, state, **f32),
            torch.empty(bc, q, state, **f32), torch.empty(bc, h, q, 1, **f32),
            torch.empty(b, l, h * p, dtype=xBC.dtype, device=dev))
    if bc:
        _prologue_cuda(_rows(xBC), _rows(dt),
                       *_f32(conv_w, conv_b, dt_bias, A_log), outs, K)
    return outs


def _prologue_cuda(xbc_rows, dt_rows, conv_w, conv_b, dt_bias, A_log, outs,
                   K: int):
    """The prologue's launch on checked CUDA inputs laid out as the kernel
    reads them (``xbc_rows`` and ``dt_rows`` from :func:`_rows`, the
    weights float32 and contiguous) into ``outs``."""
    (xBC, ld_x), (dt, ld_dt) = xbc_rows, dt_rows
    dtx, Bm, Cm, cumA, x = outs
    b, l, _ = x.shape
    _, h, q, p = dtx.shape
    launch(kernel("ssm_mixer", "ssm_prologue", _PROLOGUE_ARGS), xBC.device,
           xBC.data_ptr(), ld_x, dt.data_ptr(), ld_dt, conv_w.data_ptr(),
           conv_b.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
           dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), cumA.data_ptr(),
           x.data_ptr(), b, l, q, h, p, Bm.shape[-1], K, DTYPES[x.dtype])
    count(LAUNCHES, "ssm_prologue")


def _epilogue(y_intra, CS, cumA, x, z, D, norm, eps: float, group=None):
    dev, b, l, q, h, p = _check_epilogue(y_intra, CS, cumA, x, z, D, norm)
    if dev.type != "cuda":
        return epilogue_plain(y_intra, CS, cumA, x, z, D, norm, eps, group)
    out = torch.empty(b, l, h * p, dtype=x.dtype, device=dev)
    if not out.numel():
        return out
    ranks = _group_size(group)
    args = (y_intra.contiguous(), CS, *(t.contiguous() for t in (cumA, x)),
            _rows(z), *_f32(D, norm))
    if ranks == 1:
        _epilogue_cuda(*args, eps, out)
        return out
    ss = torch.empty(b * l, dtype=torch.float32, device=dev)
    _epilogue_cuda(*args, eps, out, ss=ss, mode=1, di_norm=ranks * h * p)
    dist.all_reduce(ss, group=group)
    _epilogue_cuda(*args, eps, out, ss=ss, mode=2, di_norm=ranks * h * p)
    return out


def _epilogue_cuda(y_intra, CS, cumA, x, z_rows, D, norm, eps: float, out,
                   ss=None, mode: int = 0, di_norm: int | None = None):
    """The epilogue's launch on checked CUDA inputs laid out as the kernel
    reads them (``z_rows`` from :func:`_rows`) into ``out``; ``mode`` 1
    writes each token's sum of squares to ``ss``, 2 takes it from there."""
    z, z_ld = z_rows
    b, l, di = x.shape
    _, h, q, _ = cumA.shape
    strides = (ctypes.c_longlong * 5)(*CS.stride())
    launch(kernel("ssm_mixer", "ssm_epilogue", _EPILOGUE_ARGS), x.device,
           y_intra.data_ptr(), CS.data_ptr(), strides, cumA.data_ptr(),
           x.data_ptr(), z.data_ptr(), z_ld, D.data_ptr(), norm.data_ptr(),
           None if ss is None else ss.data_ptr(), out.data_ptr(), b, l, q, h,
           y_intra.shape[-1], mode, float(di_norm or di), float(eps),
           DTYPES[x.dtype])
    count(LAUNCHES, "ssm_epilogue")


# -- under autograd -----------------------------------------------------------
def _recomputed_grads(ctx, plain, grads) -> tuple:
    """The gradients of ``plain`` at the saved inputs given its outputs'
    ``grads``: the plain version run again under autograd (``ctx.consts``
    its other arguments)."""
    ins = [t.detach().requires_grad_(need)
           for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*ins, *ctx.consts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
    wrt = [t for t in ins if t.requires_grad]
    if not pairs or not wrt:
        return (None,) * len(ins)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in ins)


class _Prologue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xBC, dt, conv_w, conv_b, dt_bias, A_log, state, chunk):
        ctx.save_for_backward(xBC, dt, conv_w, conv_b, dt_bias, A_log)
        ctx.consts = (state, chunk)
        return _prologue(xBC, dt, conv_w, conv_b, dt_bias, A_log, state,
                         chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return _recomputed_grads(ctx, prologue_plain, grads) + (None, None)


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_intra, CS, cumA, x, z, D, norm, eps, group):
        ctx.save_for_backward(y_intra, CS, cumA, x, z, D, norm)
        ctx.consts = (eps, group)
        return _epilogue(y_intra, CS, cumA, x, z, D, norm, eps, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _recomputed_grads(ctx, epilogue_plain, (grad,)) + (None, None)


# -- the wrappers -------------------------------------------------------------
def prologue(xBC, dt, conv_w, conv_b, dt_bias, A_log, state: int,
             chunk: int):
    """K5's inputs: ``(dtx, Bm, Cm, cumA, x)``, the first four in K5's
    layout (contiguous float32), ``x`` ``[b, l, di]`` in ``xBC``'s dtype.

    ``xBC`` ``[b, l, di + 2 n]`` and ``dt`` ``[b, l, h]`` of one dtype
    (bf16 or float32; slices of ``zxbcdt`` are read in place);
    ``conv_w`` ``[K, di + 2 n]`` (K at most :data:`MAX_K`) and ``conv_b``
    ``[di + 2 n]``, ``dt_bias`` and ``A_log`` ``[h]`` of any float dtype;
    ``state`` is ``n``; the chunk ``q = min(chunk, l)`` divides ``l``, and
    ``q``, ``n`` and ``p = di / h`` are within K5's limits.  On CUDA
    tensors one launch; on CPU and ``meta`` tensors :func:`prologue_plain`.
    Under autograd the backward is :func:`prologue_plain`'s.  A DTensor is
    refused."""
    return _Prologue.apply(xBC, dt, conv_w, conv_b, dt_bias, A_log, state,
                           chunk)


def epilogue(y_intra, CS, cumA, x, z, D, norm, eps: float, group=None):
    """``out_proj``'s input ``[b, l, di]`` in ``x``'s dtype: ``y = y_intra +
    exp(cumA) CS + D x``, ``g = y silu(z)``, ``g rsqrt(mean(g^2) + eps)
    norm``, the mean over ``group``'s ranks where it is given.

    ``y_intra`` K5's ``[b nc h, q, p]``; ``CS`` the inter-chunk product
    ``[b, nc, q, h, p]`` (any strides); ``cumA`` ``[b nc, h, q, 1]``
    (those three float32); ``x`` and ``z`` ``[b, l, di]`` of one dtype
    (bf16 or float32); ``D`` ``[h]``, ``norm`` ``[di]`` (``di`` at
    most :data:`MAX_DI`).  On CUDA tensors one launch (two around an
    all-reduce over a ``group`` of more than one rank); on CPU and
    ``meta`` tensors :func:`epilogue_plain`.  Under autograd the backward
    is :func:`epilogue_plain`'s.  A DTensor is refused."""
    return _Epilogue.apply(y_intra, CS, cumA, x, z, D, norm, eps, group)
