"""Mamba2 SSD (state-space duality) mixer, chunked matmul form (counterpart of
``repro.nn.ssm``).

Prefill uses the SSD block decomposition: the intra-chunk step is one K5
call, :func:`repro_torch.kernels.ops.ssd_intra_chunk`, over all G = b * nc
* h (batch, chunk, head) programs — the hand-written kernel on the card,
its plain version on CPU tensors — and the inter-chunk recurrence (nc small
state updates) stays plain torch, as it stays jnp in the reference.  Decode
is the O(1) recurrent update, plain torch.  Single B/C group, as in the
configs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import ops
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
    """Depthwise causal conv1d, kernel K (stacked-slice form); a DTensor
    pads its shards (the sequence whole on each)."""
    if is_dtensor(xBC):
        pad = local_op(lambda a: F.pad(a, (0, 0, K - 1, 0)),
                       replicate_dims(xBC, [1]))
    else:
        pad = F.pad(xBC, (0, 0, K - 1, 0))
    L = xBC.shape[1]
    out = sum(pad[:, k:k + L, :] * w[k] for k in range(K))
    return F.silu((out + b).float()).to(xBC.dtype)


def ssd_chunked(x, Bm, Cm, dt, A_log, D, chunk: int,
                return_final_state: bool = False):
    """SSD scan in chunked matmul form.

    x: [b, l, h, p]; Bm/Cm: [b, l, n]; dt: [b, l, h] (post-softplus);
    A_log/D: [h], or [b, h] for heads that differ by row.
    Returns y: [b, l, h, p] float32 (and the final SSD state [b, h, n, p]
    when ``return_final_state``, which seeds decode).
    """
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    nc = l // q
    if nc * q != l:
        raise ValueError(f"seq {l} not divisible by chunk {q}")

    xr = x.reshape(b, nc, q, h, p)
    Br = Bm.reshape(b, nc, q, n).float()
    Cr = Cm.reshape(b, nc, q, n).float()
    dtr = dt.reshape(b, nc, q, h).float()
    A_log, D = (t.float().reshape(-1 if t.ndim == 2 else 1, 1, 1, h)
                for t in (A_log, D))                   # [b|1,1,1,h]
    a = -torch.exp(A_log) * dtr                            # [b,nc,q,h]
    cumA = torch.cumsum(a, dim=2)                          # inclusive
    dtx = xr.float() * dtr[..., None]                      # dt_j * x_j

    # ---- intra-chunk scores, y_intra and chunk states: one K5 call ---------
    # every input as a [b*nc, h, q, x] view: B and C of a (batch, chunk)
    # expanded over its heads with stride 0, dtx and cumA transposed
    bc = b * nc
    with obs.span("repro_torch.ssd_intra", G=bc, h=h, q=q, n=n, p=p):
        y_intra, S_c = ops.ssd_intra_chunk(
            dtx.permute(0, 1, 3, 2, 4).reshape(bc, h, q, p),
            Br.reshape(bc, 1, q, n).expand(bc, h, q, n),
            Cr.reshape(bc, 1, q, n).expand(bc, h, q, n),
            cumA.permute(0, 1, 3, 2).reshape(bc, h, q, 1))
    y_intra = y_intra.reshape(b, nc, h, q, p).permute(0, 1, 3, 2, 4)
    S_c = S_c.reshape(b, nc, h, n, p)

    # ---- inter-chunk recurrence --------------------------------------------
    with obs.span("repro_torch.ssd_inter", b=b, nc=nc, h=h, n=n, p=p):
        chunk_decay = torch.exp(cumA[:, :, -1, :])         # [b,nc,h]
        s = torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
        S_in = []
        for c in range(nc):
            S_in.append(s)
            s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
        S_in = torch.stack(S_in, dim=1)                    # [b,nc,h,n,p]

        y_inter = torch.einsum("bcin,bchnp->bcihp", Cr, S_in) \
            * torch.exp(cumA)[..., None]
    y = y_intra + y_inter + D[..., None] * xr.float()
    y = y.reshape(b, l, h, p)
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


def ssm_mixer(xin, p, cfg: ArchConfig, return_state: bool = False):
    """Full Mamba2 mixer (prefill).  xin: [b, l, d] -> [b, l, d]; under a
    layout ``xin`` may be sequence-sharded over the model axis
    (:func:`_in_proj`).

    With ``return_state``, also returns (conv_state, ssd_state) ready for
    decode continuation.
    """
    di, n, h, phd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    K = cfg.ssm_conv_kernel
    zxbcdt = _in_proj(xin, p["in_proj"])
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"], K)
    x = split_dim(xBC[..., :di], (xin.shape[0], xin.shape[1], h, phd))
    Bm = xBC[..., di:di + n]
    Cm = xBC[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    res = _ssd(x, Bm, Cm, dt, p["A_log"], p["D"], cfg.ssm_chunk,
               return_state)
    y, s_fin = res if return_state else (res, None)
    y = merge_dims(y, 2).to(xin.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(xin.dtype), p["norm"], cfg.norm_eps)
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
