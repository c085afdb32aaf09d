"""The language model: parameter and cache shapes, init, and the prefill and
decode forwards (counterpart of ``repro.nn.model``) for the attn, ssm and
hybrid block kinds.

The parameters live in a :class:`Model`, an ``nn.Module`` whose layers are
an ``nn.ModuleList`` (the reference stacks them on axis 0 and scans; the
port loops in Python).  :func:`params_from_numpy` carries the reference's
parameter tree, as numpy arrays with the layers stacked, into a
:class:`Model`, and :func:`params_to_numpy` carries it back.  The decode
cache is the reference's: ``{"layers": {"k", "v", "conv", "ssd"}}``, each
stacked ``[L, ...]``, bf16 k/v and float32 conv/ssd from
:func:`init_cache`; after :func:`prefill` k/v are in the weights' dtype, as
in the reference.  :func:`decode_step` updates the cache in place and
returns it.

Every entry point takes ``device=None``, meaning CUDA, and raises without a
CUDA device; the CPU runs only when asked for with ``device="cpu"``.  Not
ported yet (``NotImplementedError``): MoE and leading dense layers,
encoder-decoder and modality frontends, the int8 KV cache, and
``lm_loss`` with the training step.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

from .blocks import block_decode, block_forward
from .config import ArchConfig
from .layers import norm
from .ssm import ssm_decode_state_shapes, ssm_param_shapes

_WAITS = "waits for the rest of ROADMAP queue item 5 (nn/)"
_F32_LEAVES = ("scale", "bias", "A_log", "D", "dt_bias", "norm", "q_norm",
               "k_norm")


def _check_ported(cfg: ArchConfig) -> None:
    for what, unported in (("MoE layers", cfg.is_moe),
                           ("leading dense layers", cfg.first_dense_layers),
                           ("the encoder", cfg.encoder_layers),
                           ("cross-attention", cfg.cross_attention),
                           ("modality frontends", cfg.frontend),
                           ("M-RoPE", cfg.m_rope),
                           ("the int8 KV cache", cfg.kv_quant)):
        if unported:
            raise NotImplementedError(f"{cfg.name}: {what} {_WAITS}")


# ==================================================================== shapes =
def _norm_shapes(cfg: ArchConfig) -> dict:
    if cfg.norm_type == "layernorm":
        return {"scale": (cfg.d_model,), "bias": (cfg.d_model,)}
    return {"scale": (cfg.d_model,)}


def _attn_shapes(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    s = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
         "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        s["q_norm"] = (hd,)
        s["k_norm"] = (hd,)
    return s


def _mlp_shapes(cfg: ArchConfig) -> dict:
    ff = cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"w1": (cfg.d_model, ff), "w3": (cfg.d_model, ff),
                "w2": (ff, cfg.d_model)}
    return {"w1": (cfg.d_model, ff), "w2": (ff, cfg.d_model)}


def _layer_shapes(cfg: ArchConfig) -> dict:
    """Shapes of one layer's parameters (not stacked)."""
    _check_ported(cfg)
    kind = cfg.block_kind
    s: dict = {"ln1": _norm_shapes(cfg)}
    if kind in ("attn", "hybrid"):
        s["attn"] = _attn_shapes(cfg)
    if kind in ("ssm", "hybrid"):
        s["ssm"] = ssm_param_shapes(cfg)
    if cfg.d_ff:
        s["mlp"] = _mlp_shapes(cfg)
        s["ln2"] = _norm_shapes(cfg)
    return s


def param_shapes(cfg: ArchConfig) -> dict:
    """Nested dict of parameter shapes (tuples); layers stacked on axis 0,
    as in the reference."""
    shapes: dict = {"embed": (cfg.vocab_size, cfg.d_model),
                    "final_norm": _norm_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    shapes["layers"] = {g: {k: (cfg.n_layers,) + sh for k, sh in d.items()}
                        for g, d in _layer_shapes(cfg).items()}
    return shapes


def param_dtype(path: tuple) -> torch.dtype:
    """bf16 weights; float32 for norms and SSM dynamics scalars."""
    name = path[-1] if path else ""
    return torch.float32 if name in _F32_LEAVES else torch.bfloat16


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


# ===================================================================== model =
class Model(nn.Module):
    """The model's parameters: ``embed``, ``lm_head`` (untied configs),
    ``final_norm`` and ``layers``, an ``nn.ModuleList`` of one
    ``nn.ModuleDict`` of ``nn.ParameterDict`` groups (``ln1``, ``attn``,
    ``ssm``, ``mlp``, ``ln2``) per layer.  No parameter requires grad.
    Call it on tokens for :func:`forward_logits`."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"])
        self.final_norm = nn.ParameterDict(tree["final_norm"])
        self.layers = nn.ModuleList(
            nn.ModuleDict({g: nn.ParameterDict(d) for g, d in lp.items()})
            for lp in tree["layers"])
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, device=None):
        return forward_logits(self, self.cfg, tokens, device=device)[0]


def _model_from_leaves(cfg: ArchConfig, make) -> Model:
    """A :class:`Model` whose leaf at stacked path ``path`` (shape ``sh``)
    is ``make(path, sh)``, a ``[L, ...]`` tensor for layer leaves."""
    shapes = param_shapes(cfg)
    tree: dict = {}
    layers = [{} for _ in range(cfg.n_layers)]
    for path, sh in _leaves(shapes):
        t = make(path, sh)
        if path[0] == "layers":
            for i in range(cfg.n_layers):
                layers[i].setdefault(path[1], {})[path[2]] = t[i].clone()
        elif len(path) == 2:
            tree.setdefault(path[0], {})[path[1]] = t
        else:
            tree[path[0]] = t
    tree["layers"] = layers
    return Model(cfg, tree)


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Model:
    """Random init on ``device`` with the reference's recipe (ones for norm
    scales and D, zeros for biases, log(linspace(1, 16)) for A_log, normal
    over sqrt(fan in) for weights) drawn from a ``torch.Generator`` seeded
    with ``seed``: the same recipe, not the reference's numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def make(path, sh):
        dt = param_dtype(path)
        name = path[-1]
        if name in ("scale", "norm", "q_norm", "k_norm", "D"):
            return torch.ones(sh, dtype=dt, device=dev)
        if name in ("bias", "conv_b", "dt_bias"):
            return torch.zeros(sh, dtype=dt, device=dev)
        if name == "A_log":
            row = torch.log(torch.linspace(1.0, 16.0, sh[-1], device=dev))
            return (row * torch.ones(sh, device=dev)).to(dt)
        fan_in = sh[-2] if len(sh) >= 2 else sh[-1]
        w = torch.randn(sh, generator=gen, device=dev) / np.sqrt(fan_in)
        return w.to(dt)

    return _model_from_leaves(cfg, make)


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ArchConfig, device=None,
                      dtype: torch.dtype | None = None) -> Model:
    """The reference's parameter tree (``repro.nn.init_params``'s, as numpy
    arrays with the layers stacked on axis 0) as a :class:`Model` on
    ``device``.  Every leaf of :func:`param_shapes` must be present with its
    shape, and nothing else.  Each leaf is cast to its :func:`param_dtype`
    (bf16 weights, float32 norms and SSM scalars; the reference's own tree
    keeps its bits), or to ``dtype`` when one is given."""
    dev = resolve_device(device)
    want = dict(_leaves(param_shapes(cfg)))
    have = dict(_leaves(tree))
    if set(want) != set(have):
        raise ValueError(f"parameter tree for {cfg.name}: missing "
                         f"{sorted(set(want) - set(have))}, unexpected "
                         f"{sorted(set(have) - set(want))}")

    def make(path, sh):
        t = _tensor_from_numpy(have[path])
        if tuple(t.shape) != sh:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, "
                             f"expected {sh}")
        return t.to(dev, dtype or param_dtype(path))

    return _model_from_leaves(cfg, make)


def params_to_numpy(model: Model) -> dict:
    """The model's parameters as the reference's tree: numpy arrays, layers
    stacked on axis 0 (bf16 leaves as float32, which holds them exactly)."""
    def np_(t):
        return t.detach().float().cpu().numpy()

    tree = {"embed": np_(model.embed),
            "final_norm": {k: np_(v) for k, v in model.final_norm.items()}}
    if not model.cfg.tie_embeddings:
        tree["lm_head"] = np_(model.lm_head)
    tree["layers"] = {g: {k: np.stack([np_(lp[g][k]) for lp in model.layers])
                          for k in d} for g, d in model.layers[0].items()}
    return tree


# ==================================================================== fwd ====
def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (a CUDA device without an
    index is the current one)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def _bind(params: Model, device, tokens) -> torch.Tensor:
    """Resolve ``device``, check the model lies there, and move ``tokens``
    there as int64."""
    dev = resolve_device(device)
    if not same_device(params.device, dev):
        raise ValueError(f"the model lies on {params.device}, not on {dev}")
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens))
    return tokens.to(dev).long()


def _embed(params: Model, tokens):
    return params.embed[tokens]


def _unembed(params: Model, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        return x @ params.embed.T
    return x @ params.lm_head


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


@torch.no_grad()
def forward_logits(params: Model, cfg: ArchConfig, tokens, device=None):
    """Full-sequence forward: tokens [B, S] -> (logits [B, S, V], aux)."""
    tokens = _bind(params, device, tokens)
    x = _embed(params, tokens)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, a, _ = block_forward(x, lp, cfg, positions)
        aux = aux + a
    x = norm(x, params.final_norm, cfg.norm_type, cfg.norm_eps)
    return _unembed(params, cfg, x), aux


# ================================================================= decode ====
def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Shapes of the per-layer decode cache (stacked [L, ...])."""
    _check_ported(cfg)
    kind = cfg.block_kind
    per: dict = {}
    if kind in ("attn", "hybrid"):
        per["k"] = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        per["v"] = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    if kind in ("ssm", "hybrid"):
        per.update(ssm_decode_state_shapes(cfg, batch))
    return {"layers": {k: (cfg.n_layers,) + v for k, v in per.items()}}


def cache_dtype(name: str) -> torch.dtype:
    """bf16 k/v, float32 conv and ssd states."""
    return torch.float32 if name in ("conv", "ssd") else torch.bfloat16


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """A zero decode cache on ``device``."""
    dev = resolve_device(device)
    return {"layers": {k: torch.zeros(sh, dtype=cache_dtype(k),
                                      device=dev)
                       for k, sh in cache_shapes(cfg, batch,
                                                 max_seq)["layers"].items()}}


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, cache: dict, token, pos: int,
                device=None):
    """One-token decode.  token: [B] ints; pos: the position of the token.

    Returns (logits [B, V], cache): the cache is updated in place (k/v at
    ``pos``, the conv and ssd states replaced) and returned.
    """
    token = _bind(params, device, token)
    pos = int(pos)
    x = _embed(params, token[:, None])
    stacked = cache["layers"]
    for i, lp in enumerate(params.layers):
        cl = {k: t[i] for k, t in stacked.items()}
        x, ncl = block_decode(x, lp, cfg, cl, pos)
        for k in ("conv", "ssd"):
            if k in ncl:
                stacked[k][i] = ncl[k]
    x = norm(x, params.final_norm, cfg.norm_type, cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0], cache


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, tokens, max_seq: int | None = None,
            device=None):
    """Run the prompt, build the decode cache.  Returns (last_logits [B, V],
    cache).

    Attention archs emit K/V (written into a cache of ``max_seq``
    positions, zero past the prompt: the reference's padding); SSM and
    hybrid archs also emit the final conv and SSD states of the chunked
    scan.
    """
    tokens = _bind(params, device, tokens)
    x = _embed(params, tokens)
    B, S = x.shape[:2]
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt {S}")
    positions = _positions(B, S, x.device)
    layers: dict = {}
    L = len(params.layers)
    for i, lp in enumerate(params.layers):
        x, _, el = block_forward(x, lp, cfg, positions, collect_cache=True)
        for k, t in el.items():
            if k not in layers:
                shape = (L, B, max_seq) + t.shape[2:] if k in ("k", "v") \
                    else (L,) + t.shape
                layers[k] = torch.zeros(shape, dtype=t.dtype,
                                        device=t.device)
            if k in ("k", "v"):
                layers[k][i, :, :S] = t
            else:
                layers[k][i] = t
    x = norm(x, params.final_norm, cfg.norm_type, cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    return logits, {"layers": layers}
