"""The plain float32 forward of the benchmark's models.

Written from the layer equations, in plain PyTorch and float32 with TF32
off (:func:`strict_fp32`): no kernel, no cache, no import of the program.
It reads the weights the benchmark made (bf16 matrices, float32 norms and
SSM scalars), upcast a layer at a time, so the float32 copy of a large
model is never held whole.

A decoder layer is one of:

- ``hybrid`` (hymba): ``x + (attn(n(x)) + ssm(n(x))) / 2``, then ``x +
  mlp(n(x))``: grouped-query attention with half-split RoPE, and a Mamba2
  mixer (causal depthwise conv, SSD scan with one B/C group, gated
  RMSNorm);
- ``moe`` (deepseek-moe): ``x + attn(n(x))``, then ``x + moe(n(x))``: a
  float32 softmax router, the top ``K`` experts by a stable descending
  sort with their gates renormalised, each expert keeping the first ``C``
  of its assignments in (token, rank) order and dropping the rest (``C``
  from the configuration's capacity factor), plus shared experts;
- ``attn`` (and the leading dense layers): ``x + attn(n(x))``, then ``x +
  mlp(n(x))``.

``quant="fp8"`` is the control: the model computed in float8 e4m3 where
the configuration states bf16.  Every matrix product's operands are
rounded to it before a float32 product (a weight with one scale a tensor,
the activations one a token; attention's q, k and v one a token and head,
its softmax weights one a query row), and so is the embedding table; the
norms, the SSM scalars and the SSD scan, float32 in the configuration,
stay float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")
#: Score elements a block of queries holds at once.
ATTN_BLOCK_ELEMS = 1 << 27


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# ------------------------------------------------------------ precision ---
def fake_fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale of ``amax / 448`` (over
    ``dim``, or the whole tensor), back in float32; its gradient passes
    through unrounded, as float8 training keeps its backward wider."""
    with torch.no_grad():
        a = t.abs().amax() if dim is None else t.abs().amax(dim,
                                                            keepdim=True)
        s = a.clamp(min=1e-12) / 448.0
        r = (t / s).to(torch.float8_e4m3fn).float() * s
    return t + (r - t).detach() if t.requires_grad else r


def mm(x: torch.Tensor, w: torch.Tensor, quant: str | None = None):
    if quant == "fp8":
        return fake_fp8(x, -1) @ fake_fp8(w)
    if quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return x @ w


# ----------------------------------------------------------------- layers ---
def head_dim(c: dict) -> int:
    return c.get("d_head") or c["d_model"] // c["n_heads"]


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Half-split rotary embedding of x [B, S, H, D] at positions 0..S-1,
    the angle a float32 product of position and frequency."""
    D, S = x.shape[-1], x.shape[1]
    freqs = (1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                          device=x.device) / D)).float()
    ang = torch.arange(S, device=x.device).float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, quant=None):
    """Exact causal softmax attention, q [B, S, H, D] against k/v [B, S,
    KH, D] (query head h reads kv head h // (H / KH)), one block of
    queries at a time."""
    if quant == "fp8":
        q, k, v = (fake_fp8(t, -1) for t in (q, k, v))
    B, S, H, D = q.shape
    KH = k.shape[2]
    rep = H // KH
    qg = q.reshape(B, S, KH, rep, D)
    out = torch.empty_like(qg)
    rows = max(1, min(S, ATTN_BLOCK_ELEMS // max(1, B * H * S)))
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg[:, s0:s1], k[:, :s1]) \
            / math.sqrt(D)
        s = s.masked_fill(pos[s0:s1, None] < pos[None, :s1], NEG_INF)
        p = torch.softmax(s, dim=-1)
        if quant == "fp8":
            p = fake_fp8(p, -1)
        out[:, s0:s1] = torch.einsum("bhrqk,bkhd->bqhrd", p, v[:, :s1])
    return out.reshape(B, S, H, D)


def attention(xn, w: dict, c: dict, quant=None):
    """(output [B, S, d], k after RoPE, v), k/v [B, S, KH, D]."""
    B, S, _ = xn.shape
    H, KH, D = c["n_heads"], c["n_kv_heads"], head_dim(c)
    q = mm(xn, w["attn.wq"], quant).reshape(B, S, H, D)
    k = mm(xn, w["attn.wk"], quant).reshape(B, S, KH, D)
    v = mm(xn, w["attn.wv"], quant).reshape(B, S, KH, D)
    if c.get("rope_theta"):
        q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    o = causal_attention(q, k, v, quant).reshape(B, S, H * D)
    return mm(o, w["attn.wo"], quant), k, v


def swiglu(x, w1, w3, w2, quant=None):
    return mm(F.silu(mm(x, w1, quant)) * mm(x, w3, quant), w2, quant)


def ssd_scan(x, Bm, Cm, dt, A_log, Dskip, chunk: int):
    """The SSD scan ``h_t = exp(A dt_t) h_{t-1} + B_t (dt_t x_t)^T``, ``y_t
    = C_t h_t + D x_t`` (A = -exp(A_log)), in chunks of ``chunk``
    positions: exact products within a chunk, a recurrence between
    chunks.  x [b, l, h, p], B/C [b, l, n], dt [b, l, h].  Returns (y [b,
    l, h, p], the final state [b, h, n, p])."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"sequence {l} is not a multiple of the chunk {q}")
    nc = l // q
    a = (-torch.exp(A_log) * dt).reshape(b, nc, q, h)
    cum = a.cumsum(2)                                       # [b,nc,q,h]
    dtx = (x * dt[..., None]).reshape(b, nc, q, h, p)
    Br, Cr = Bm.reshape(b, nc, q, n), Cm.reshape(b, nc, q, n)
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = (cum.permute(0, 1, 3, 2)[..., :, None]
           - cum.permute(0, 1, 3, 2)[..., None, :])         # [b,nc,h,i,j]
    decay = torch.exp(seg.masked_fill(~tril, NEG_INF))
    cb = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    y = torch.einsum("bchij,bcjhp->bcihp", decay * cb[:, :, None], dtx)
    wlast = torch.exp(cum[:, :, -1:, :] - cum)             # [b,nc,q,h]
    states = torch.einsum("bcjn,bcjhp->bchnp", Br, dtx * wlast[..., None])
    s = torch.zeros(b, h, n, p, dtype=x.dtype, device=x.device)
    into = []
    for ci in range(nc):
        into.append(s)
        s = s * torch.exp(cum[:, ci, -1])[..., None, None] + states[:, ci]
    into = torch.stack(into, dim=1)                         # [b,nc,h,n,p]
    y = y + torch.einsum("bcin,bchnp->bcihp", Cr, into) \
        * torch.exp(cum)[..., None]
    y = y + Dskip[:, None] * x.reshape(b, nc, q, h, p)
    return y.reshape(b, l, h, p), s


def mamba2(xn, w: dict, c: dict, quant=None):
    """The Mamba2 mixer: (output [B, S, d], the conv state: the last K-1
    positions of the projected x, B, C before the conv, the final SSD
    state)."""
    B, S, _ = xn.shape
    d = c["d_model"]
    di = c.get("ssm_expand", 2) * d
    n, p = c["ssm_state"], c.get("ssm_head_dim", 64)
    h, K = di // p, c.get("ssm_conv_kernel", 4)
    proj = mm(xn, w["ssm.in_proj"], quant)
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[:, j:j + S] * w["ssm.conv_w"][j] for j in range(K))
    xbc_c = F.silu(conv + w["ssm.conv_b"])
    x = xbc_c[..., :di].reshape(B, S, h, p)
    Bm, Cm = xbc_c[..., di:di + n], xbc_c[..., di + n:]
    dt = F.softplus(dt + w["ssm.dt_bias"])
    y, state = ssd_scan(x, Bm, Cm, dt, w["ssm.A_log"], w["ssm.D"],
                        c.get("ssm_chunk", 128))
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), w["ssm.norm"],
                c.get("norm_eps", 1e-6))
    return mm(y, w["ssm.out_proj"], quant), xbc[:, S - (K - 1):], state


def capacity(tokens: int, c: dict) -> int:
    """An expert's slots for ``tokens`` tokens: ``T K cf / E`` plus one,
    rounded up to a multiple of 8, at least 8."""
    slots = int(tokens * c["n_experts_active"] * c.get("capacity_factor",
                                                       1.25)
                // c["n_experts"]) + 1
    return max(8, -(-slots // 8) * 8)


def moe(x, w: dict, c: dict, quant=None):
    """The MoE layer on one routing group x [T, d]."""
    T = x.shape[0]
    E, K = c["n_experts"], c["n_experts_active"]
    C = capacity(T, c)
    probs = torch.softmax(mm(x, w["moe.router"], quant), dim=-1)
    ranked, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = ranked[:, :K] / ranked[:, :K].sum(-1, keepdim=True)
    flat = ids[:, :K].reshape(-1)
    hot = F.one_hot(flat, E)
    rank = (hot.cumsum(0) * hot).sum(-1) - 1
    keep = rank < C
    y = torch.zeros_like(x)
    g = gates.reshape(-1)
    for e in range(E):
        sel = torch.nonzero((flat == e) & keep).squeeze(-1)
        tok = sel // K
        out = swiglu(x[tok], w["moe.w1"][e], w["moe.w3"][e], w["moe.w2"][e],
                     quant)
        y = y.index_add(0, tok, out * g[sel, None])
    if c.get("n_shared_experts"):
        y = y + swiglu(x, w["moe.shared_w1"], w["moe.shared_w3"],
                       w["moe.shared_w2"], quant)
    return y


def moe_tokens(x, w: dict, c: dict, quant=None):
    """The MoE layer on x [B, S, d]: the B * S tokens one routing group,
    or groups of ``moe_chunk_tokens`` where there are more in a whole
    multiple of it."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    chunk = c.get("moe_chunk_tokens", B * S)
    if B * S > chunk and (B * S) % chunk == 0:
        out = torch.cat([moe(part, w, c, quant)
                         for part in flat.split(chunk)])
    else:
        out = moe(flat, w, c, quant)
    return out.reshape(B, S, d)


def layer(x, w: dict, c: dict, kind: str, quant=None):
    """One decoder layer: (x, its cache elements {k, v[, conv, ssd]})."""
    eps = c.get("norm_eps", 1e-6)
    xn = rmsnorm(x, w["ln1.scale"], eps)
    el = {}
    if kind == "hybrid":
        a, el["k"], el["v"] = attention(xn, w, c, quant)
        s, el["conv"], el["ssd"] = mamba2(xn, w, c, quant)
        x = x + 0.5 * (a + s)
    else:
        a, el["k"], el["v"] = attention(xn, w, c, quant)
        x = x + a
    xn = rmsnorm(x, w["ln2.scale"], eps)
    if kind == "moe":
        return x + moe_tokens(xn, w, c, quant), el
    return x + swiglu(xn, w["mlp.w1"], w["mlp.w3"], w["mlp.w2"], quant), el


def layer_kind(c: dict) -> str:
    if c["family"] == "hybrid":
        return "hybrid"
    return "moe" if c.get("n_experts") else "attn"


def stack(c: dict) -> list[tuple[str, str]]:
    """(weight prefix, layer kind) of every decoder layer in order: the
    leading dense layers first."""
    dense = c.get("first_dense_layers", 0)
    return [(f"dense_layers.{i}.", "attn") for i in range(dense)] + \
        [(f"layers.{i}.", layer_kind(c)) for i in range(c["n_layers"] - dense)]


def embedding(weights: dict, tokens, quant=None):
    """The tokens' rows of the embedding table, in float32 (its values
    rounded to float8 first under ``quant``)."""
    table = weights["embed"].float()
    if quant == "fp8":
        table = fake_fp8(table)
    return table[tokens.long()]


def layer_weights(weights: dict, prefix: str) -> dict:
    """One layer's weights in float32, keyed without ``prefix``."""
    return {k[len(prefix):]: v.float() for k, v in weights.items()
            if k.startswith(prefix)}
