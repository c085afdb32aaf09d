"""Mamba2 SSD (state-space duality) mixer, chunked matmul form (counterpart of
``repro.nn.ssm``).

Prefill uses the SSD block decomposition: the intra-chunk step is one K5
call, :func:`repro_torch.kernels.ops.ssd_intra_chunk`, over all G = b * nc
* h (batch, chunk, head) programs — the hand-written kernel on the card,
its plain version on CPU tensors — and the inter-chunk recurrence (nc small
state updates and the product ``C S_in``, span ``repro_torch.ssd_inter``)
stays plain torch, as it stays jnp in the reference.

Around them, :func:`ssm_mixer` takes one of two paths (:func:`_fused`):

- fused, for CUDA tensors: two kernels of
  :mod:`repro_torch.kernels.ssm_mixer`, the prologue (``zxbcdt`` to K5's
  inputs: conv, SiLU, softplus, ``cumA``, ``dt x``) and the epilogue (K5's
  and the recurrence's outputs to ``out_proj``'s input: ``exp(cumA)``
  decay, ``D x``, the gate and the RMSNorm), float32 from the conv through
  the norm with one rounding at each kernel's output.  Under autograd (the
  training step and its recompute) their backward is the plain pieces'
  (:mod:`repro_torch.kernels.ssm_mixer`).  Under a layout the kernels run
  on local shards: through :func:`head_local` where the heads split over
  the model axis, the norm's sum of squares then added over that axis;
  else through :func:`item_local`, each model rank taking whole rows;
- plain, for CPU and ``meta`` tensors (the tests, the dry run): the same
  steps as torch ops, which round to bf16 where the mixer always did.

Counters ``ssm.calls`` (every mixer call) and ``ssm.fused`` (those on the
fused path).  Decode is the O(1) recurrent update, plain torch.  Single B/C
group, as in the configs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_mixer as ssm_mixer_k
from repro_torch.parallel.context import (constrain, current, gather_model,
                                          head_local, is_dtensor, item_local,
                                          local_op, local_product, merge_dims,
                                          model_shards, model_size,
                                          replicate_dims, split_dim)

from .config import ArchConfig
from .layers import rmsnorm


def ssm_param_shapes(cfg: ArchConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        "in_proj": (d, 2 * di + 2 * n + h),
        "conv_w": (cfg.ssm_conv_kernel, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (h,),
        "D": (h,),
        "dt_bias": (h,),
        "norm": (di,),
        "out_proj": (di, d),
    }


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, K: int):
    """Depthwise causal conv1d, kernel K (stacked-slice form,
    :func:`ssm_mixer.conv_plain`); a DTensor pads its shards (the sequence
    whole on each)."""
    if is_dtensor(xBC):
        pad = local_op(lambda a: F.pad(a, (0, 0, K - 1, 0)),
                       replicate_dims(xBC, [1]))
    else:
        pad = F.pad(xBC, (0, 0, K - 1, 0))
    return ssm_mixer_k.conv_plain(pad, w, b)


def _scan(dtx, Bm, Cm, cumA, b: int):
    """K5 and the inter-chunk recurrence on K5's layout
    (:mod:`repro_torch.kernels.ssm_mixer`): ``(y_intra [b nc h, q, p], C
    S_in [b, nc, q, h, p], final state [b, h, n, p])``, float32.  The
    recurrence's output is left undecayed: its ``exp(cumA)`` factor is
    applied where the output is put together."""
    bc, h, q, p = dtx.shape
    n, nc = Bm.shape[-1], bc // b
    # every input as a [b*nc, h, q, x] view: B and C of a (batch, chunk)
    # expanded over its heads with stride 0
    with obs.span("repro_torch.ssd_intra", G=bc, h=h, q=q, n=n, p=p):
        y_intra, S_c = ops.ssd_intra_chunk(
            dtx, Bm.reshape(bc, 1, q, n).expand(bc, h, q, n),
            Cm.reshape(bc, 1, q, n).expand(bc, h, q, n), cumA)
    S_c = S_c.reshape(b, nc, h, n, p)

    with obs.span("repro_torch.ssd_inter", b=b, nc=nc, h=h, n=n, p=p):
        chunk_decay = torch.exp(cumA[:, :, -1, 0]).reshape(b, nc, h)
        s = torch.zeros(b, h, n, p, dtype=torch.float32, device=dtx.device)
        S_in = []
        for c in range(nc):
            S_in.append(s)
            s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
        S_in = torch.stack(S_in, dim=1)                    # [b,nc,h,n,p]
        CS = torch.einsum("bcin,bchnp->bcihp", Cm.reshape(b, nc, q, n), S_in)
    return y_intra, CS, s


def ssd_chunked(x, Bm, Cm, dt, A_log, D, chunk: int,
                return_final_state: bool = False):
    """SSD scan in chunked matmul form.

    x: [b, l, h, p]; Bm/Cm: [b, l, n]; dt: [b, l, h] (post-softplus);
    A_log/D: [h], or [b, h] for heads that differ by row.
    Returns y: [b, l, h, p] float32 (and the final SSD state [b, h, n, p]
    when ``return_final_state``, which seeds decode).
    """
    dtx, Br, Cr, cumA = ssm_mixer_k.scan_inputs_plain(x, Bm, Cm, dt, A_log,
                                                      chunk)
    y_intra, CS, s = _scan(dtx, Br, Cr, cumA, x.shape[0])
    y = ssm_mixer_k.combine_plain(y_intra, CS, cumA, x, D)
    if return_final_state:
        return y, s
    return y


def _ssd(x, Bm, Cm, dt, A_log, D, chunk: int, return_state: bool):
    """:func:`ssd_chunked`; DTensors through :func:`head_local`, each rank
    scanning its heads (B and C, shared by the heads, whole on every
    rank), or where the heads do not split over the model axis through
    :func:`item_local`, each (row, head) item of a data shard scanned by
    one model rank in turn."""
    def run(x, Bm, Cm, dt, A_log, D):
        return ssd_chunked(x, Bm, Cm, dt, A_log, D, chunk,
                           return_final_state=return_state)

    args = (x, Bm, Cm, dt, A_log, D)
    if not is_dtensor(x):
        return run(*args)
    if x.shape[2] % model_size(x) == 0:
        return head_local(run, args, (2, None, None, 2, 0, 0),
                          (2, 1) if return_state else (2,),
                          batch_dims=(0, 0, 0, 0, None, None))

    def items(rank, ranks, x, Bm, Cm, dt, A_log, D):
        b, l, h, p = x.shape
        picked = torch.arange(rank, max(rank, b * h), ranks,
                              device=x.device)
        rows, heads = picked // h, picked % h
        y = x.new_zeros(b, l, h, p, dtype=torch.float32)
        s = x.new_zeros(b, h, Bm.shape[-1], p, dtype=torch.float32)
        if len(picked):
            res = run(x[rows, :, heads][:, :, None], Bm[rows], Cm[rows],
                      dt[rows, :, heads][:, :, None], A_log[heads][:, None],
                      D[heads][:, None])
            y_i, s_i = res if return_state else (res, None)
            y[rows, :, heads] = y_i[:, :, 0]
            if return_state:
                s[rows, heads] = s_i[:, 0]
        return (y, s) if return_state else y

    return item_local(items, args, (True,) * 4 + (False,) * 2,
                      2 if return_state else 1)


def _in_proj(xin, w):
    """``xin @ w``.  Under a layout ``xin`` may come sequence-sharded
    over the model axis: where that axis splits ``w``'s columns, ``xin`` is
    gathered first (column-parallel); where it does not (their count does
    not divide it), each rank projects its own positions and the product
    is gathered after, so that no rank projects another's."""
    if not is_dtensor(xin):
        return xin @ w
    ctx = current()
    spec = None if model_shards(w, 1) or ctx is None \
        else ctx.residual_sharding(xin.shape[0], xin.shape[1])
    if spec is None:
        return gather_model(xin) @ w
    return replicate_dims(local_product(constrain(xin, spec), w), [1])


def _fused(zxbcdt) -> bool:
    """Whether the mixer takes its two kernels: on CUDA tensors, plain or
    a layout's."""
    return zxbcdt.device.type == "cuda"


def _mixer_local(xBC, dt, z, conv_w, conv_b, dt_bias, A_log, D, norm,
                 cfg: ArchConfig, group=None):
    """The fused path on plain tensors, from ``in_proj``'s slices to
    ``out_proj``'s input: the prologue kernel, K5 and the recurrence, the
    epilogue kernel (its norm over ``group``'s heads where given); returns
    it and the scan's final state."""
    dtx, Bm, Cm, cumA, x = ssm_mixer_k.prologue(
        xBC, dt, conv_w, conv_b, dt_bias, A_log, cfg.ssm_state,
        cfg.ssm_chunk)
    y_intra, CS, s_fin = _scan(dtx, Bm, Cm, cumA, xBC.shape[0])
    y = ssm_mixer_k.epilogue(y_intra, CS, cumA, x, z, D, norm, cfg.norm_eps,
                             group)
    return y, s_fin


def _mixer_fused(zxbcdt, p, cfg: ArchConfig):
    """:func:`_mixer_local` on ``zxbcdt``'s slices; a layout's DTensors
    rank by rank.  Where the heads split over the model axis each rank
    runs its heads (:func:`head_local`; B and C, shared by the heads, whole
    on every rank) and the norm adds its sums of squares over the axis;
    else each model rank runs whole rows of its data shard in turn
    (:func:`item_local`)."""
    di, n, h, phd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    names = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm")
    if not is_dtensor(zxbcdt):
        return _mixer_local(xBC, dt, z, *(p[k] for k in names), cfg)
    b, l, _ = zxbcdt.shape
    if h % model_size(zxbcdt):
        def rows(rank, ranks, xBC, dt, z, *weights):
            picked = torch.arange(rank, max(rank, xBC.shape[0]), ranks,
                                  device=xBC.device)
            y = z.new_zeros(z.shape)
            s = z.new_zeros(z.shape[0], h, n, phd, dtype=torch.float32)
            if len(picked):
                y_i, s_i = _mixer_local(xBC[picked], dt[picked], z[picked],
                                        *weights, cfg)
                y[picked], s[picked] = y_i, s_i
            return y, s

        return item_local(rows, (xBC, dt, z, *(p[k] for k in names)),
                          (True,) * 3 + (False,) * 6, 2)

    ctx = current()
    axis = ctx.model_axis if ctx is not None else "model"
    K = cfg.ssm_conv_kernel
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    args = (split_dim(xBC[..., :di], (b, l, h, phd)), xBC[..., di:], dt,
            split_dim(z, (b, l, h, phd)),
            split_dim(conv_w[:, :di], (K, h, phd)), conv_w[:, di:],
            split_dim(conv_b[:di], (h, phd)), conv_b[di:], p["dt_bias"],
            p["A_log"], p["D"], split_dim(p["norm"], (h, phd)))

    def heads(x, BC, dt, z, wx, wbc, bx, bbc, dt_bias, A_log, D, norm):
        bl, ll, hl, _ = x.shape
        group = None if hl == h else zxbcdt.device_mesh.get_group(axis)
        y, s = _mixer_local(
            torch.cat([x.reshape(bl, ll, hl * phd), BC], -1), dt,
            z.reshape(bl, ll, hl * phd),
            torch.cat([wx.reshape(K, hl * phd), wbc], -1),
            torch.cat([bx.reshape(hl * phd), bbc]), dt_bias, A_log, D,
            norm.reshape(hl * phd), cfg, group)
        return y.reshape(bl, ll, hl, phd), s

    y, s = head_local(heads, args, (2, None, 2, 2, 1, None, 0, None, 0, 0,
                                    0, 0), (2, 1),
                      batch_dims=(0,) * 4 + (None,) * 8)
    return merge_dims(y, 2), s


def ssm_mixer(xin, p, cfg: ArchConfig, return_state: bool = False):
    """Full Mamba2 mixer (prefill).  xin: [b, l, d] -> [b, l, d]; under a
    layout ``xin`` may be sequence-sharded over the model axis
    (:func:`_in_proj`).

    CUDA inputs take the fused path (:func:`_fused`): the prologue kernel,
    K5, the recurrence and the epilogue kernel, under autograd and under a
    layout too.  CPU and ``meta`` inputs take the plain torch ops.
    Counters ``ssm.calls`` (every call) and ``ssm.fused`` (the fused
    path's).

    With ``return_state``, also returns (conv_state, ssd_state) ready for
    decode continuation.
    """
    di, n, h, phd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    K = cfg.ssm_conv_kernel
    obs.count("ssm.calls", 1)
    zxbcdt = _in_proj(xin, p["in_proj"])
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)
    if _fused(zxbcdt):
        obs.count("ssm.fused", 1)
        y, s_fin = _mixer_fused(zxbcdt, p, cfg)
    else:
        xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"], K)
        x = split_dim(xBC[..., :di], (xin.shape[0], xin.shape[1], h, phd))
        Bm = xBC[..., di:di + n]
        Cm = xBC[..., di + n:]
        dt = F.softplus(dt.float() + p["dt_bias"].float())
        res = _ssd(x, Bm, Cm, dt, p["A_log"], p["D"], cfg.ssm_chunk,
                   return_state)
        y, s_fin = res if return_state else (res, None)
        y = merge_dims(y, 2).to(xin.dtype)
        y = rmsnorm(y * F.silu(z.float()).to(xin.dtype), p["norm"],
                    cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        conv_state = xBC_raw[:, -(K - 1):, :].float()
        return out, (conv_state, s_fin)
    return out


# -------------------------------------------------------------- decode ------
def ssm_decode_state_shapes(cfg: ArchConfig, batch: int) -> dict:
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return {
        "conv": (batch, cfg.ssm_conv_kernel - 1, di + 2 * n),
        "ssd": (batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
    }


def ssm_decode(xin, p, cfg: ArchConfig, conv_state, ssd_state):
    """One-token recurrent update.  xin: [b, 1, d].

    Returns (y [b,1,d], new_conv_state, new_ssd_state), float32 states.
    """
    b = xin.shape[0]
    di, n, h, phd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    zxbcdt = xin @ p["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    # rolling conv buffer: [b, K-1, C] + current input (dtypes promote as in
    # the reference: a float32 state makes the window float32)
    window = torch.cat([conv_state, xBC.to(conv_state.dtype)], dim=1)
    new_conv = window[:, 1:, :]
    conv_out = torch.einsum("bkc,kc->bc", window,
                            p["conv_w"].to(window.dtype)) \
        + p["conv_b"].to(window.dtype)
    conv_out = F.silu(conv_out.float()).to(xin.dtype)
    x = conv_out[:, :di].reshape(b, h, phd)
    Bm = conv_out[:, di:di + n]
    Cm = conv_out[:, di + n:]
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())     # [b,h]
    a = torch.exp(-torch.exp(p["A_log"].float()) * dtv)           # [b,h]
    dtx = x.float() * dtv[..., None]                              # [b,h,p]
    new_ssd = ssd_state * a[..., None, None] \
        + torch.einsum("bn,bhp->bhnp", Bm.float(), dtx)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), new_ssd) \
        + p["D"].float()[None, :, None] * x.float()
    y = y.reshape(b, 1, di).to(xin.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(xin.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_conv, new_ssd
