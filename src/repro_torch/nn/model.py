"""The language model: parameter and cache shapes, init, and the prefill,
decode and full-sequence forwards (counterpart of ``repro.nn.model``) for
every family of the configs: dense, MoE with leading dense layers and
shared experts, SSM, hybrid, the encoder-decoder (whisper) and the patch
frontend with M-RoPE (qwen2-vl).

The parameters live in a :class:`Model`, an ``nn.Module`` whose stacks
(``layers``, ``dense_layers``, ``encoder``) are ``nn.ModuleList``s of one
layer each (the reference stacks them on axis 0 and scans; the port loops
in Python).  :func:`params_from_numpy` carries the reference's parameter
tree, as numpy arrays with the layers stacked, into a :class:`Model`, and
:func:`params_to_numpy` carries it back.  The decode cache is the
reference's: ``{"layers": {"k", "v", "k_scale", "v_scale", "conv", "ssd",
"enc_out"}, "dense_layers": {"k", "v"}}`` as the config has them, each
stacked ``[L, ...]``; :func:`decode_step` updates it in place and returns
it.

:func:`prefill` emits the whole cache that :func:`decode_step` reads, where
the reference's leaves out two parts (ROADMAP §3, "Faults of the reference,
mended in the port"): the leading dense layers' k/v, and under ``kv_quant``
the int8 k/v with their scales, quantised as decode quantises.

The training objective is :func:`lm_loss` over :func:`forward_hidden`:
next-token cross-entropy over chunks of the sequence (each chunk's logits
recomputed in the backward pass) plus the MoE load-balance loss, with each
decoder layer checkpointed (``torch.utils.checkpoint``, non-reentrant)
under ``remat``, as the reference wraps its scanned layer in
``jax.checkpoint``.  K4 and K5 run under autograd (``kernels.ops``), so a
training step launches them in the forward and again in each layer's
recompute.  :meth:`Model.trainable` lets the parameters require grad; the
inference entry points run under ``torch.no_grad``.

Every entry point takes ``device=None``, meaning CUDA, and raises without a
CUDA device; the CPU runs only when asked for with ``device="cpu"``, and
``"meta"`` (shapes only) when named.  :func:`abstract_params` and
:func:`abstract_cache` give the dry run's ``meta`` trees.  Under a
parallel context (:mod:`repro_torch.parallel.context`) with DTensor
parameters the forwards run laid out: the residual sequence-sharded
between layers (``_constrain_residual``), the embedding vocab-parallel,
each mixer's input gathered over the model axis and its output reduced
back, K4 and K5 on each rank's heads through ``local_map``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.parallel import context as pctx

from .attention import quantize_kv
from .blocks import block_decode, block_forward, cross_block, encoder_block
from .config import ArchConfig
from .layers import norm
from .moe import moe_param_shapes
from .ssm import ssm_decode_state_shapes, ssm_param_shapes

_F32_LEAVES = ("scale", "bias", "A_log", "D", "dt_bias", "norm", "q_norm",
               "k_norm")
#: The parameter groups stacked on axis 0 in the reference's tree.
STACKS = ("layers", "dense_layers", "encoder")


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


def _layer_shapes(cfg: ArchConfig, kind: str) -> dict:
    """Shapes of the parameters of one layer (not stacked) of block kind
    ``kind``: its mixer's, then its MoE layer's or MLP's."""
    s: dict = {"ln1": _norm_shapes(cfg)}
    if kind in ("attn", "moe", "hybrid"):
        s["attn"] = _attn_shapes(cfg)
    if kind in ("ssm", "hybrid"):
        s["ssm"] = ssm_param_shapes(cfg)
    if cfg.is_moe:
        s["moe"] = moe_param_shapes(cfg)
        s["ln2"] = _norm_shapes(cfg)
    elif cfg.d_ff:
        s["mlp"] = _mlp_shapes(cfg)
        s["ln2"] = _norm_shapes(cfg)
    if cfg.cross_attention:
        s["xattn"] = _attn_shapes(cfg)
        s["ln3"] = _norm_shapes(cfg)
    return s


def _plain_layer_shapes(cfg: ArchConfig) -> dict:
    """A leading dense layer's or an encoder layer's: attention and MLP."""
    return {"ln1": _norm_shapes(cfg), "attn": _attn_shapes(cfg),
            "ln2": _norm_shapes(cfg), "mlp": _mlp_shapes(cfg)}


def _stack_layers(cfg: ArchConfig) -> dict[str, list[dict]]:
    """Each stack's layers in order, each layer's parameter shapes by
    group (not stacked)."""
    stacks = {"layers": [_layer_shapes(cfg, kind)
                         for kind in cfg.layer_kinds]}
    if cfg.first_dense_layers:
        stacks["dense_layers"] = [_plain_layer_shapes(cfg)] \
            * cfg.first_dense_layers
    if cfg.encoder_layers:
        stacks["encoder"] = [_plain_layer_shapes(cfg)] * cfg.encoder_layers
    return stacks


def _holders(layers: list[dict]) -> dict[str, list[int]]:
    """For each group of a stack's layers (in the order they first
    appear), the layers that have it."""
    out: dict = {}
    for i, lp in enumerate(layers):
        for g in lp:
            out.setdefault(g, []).append(i)
    return out


def param_shapes(cfg: ArchConfig) -> dict:
    """Nested dict of parameter shapes (tuples); layers stacked on axis 0,
    as in the reference: each group over the layers that have it (all of a
    stack's but where ``layer_types`` mixes its mixers)."""
    shapes: dict = {"embed": (cfg.vocab_size, cfg.d_model),
                    "final_norm": _norm_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    for name, layers in _stack_layers(cfg).items():
        shapes[name] = {g: {k: (len(at),) + sh
                            for k, sh in layers[at[0]][g].items()}
                        for g, at in _holders(layers).items()}
    if cfg.encoder_layers:
        shapes["enc_final_norm"] = _norm_shapes(cfg)
    if cfg.frontend:
        shapes["frontend_proj"] = (cfg.d_model, cfg.d_model)
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


def _dense_view(cfg: ArchConfig) -> ArchConfig:
    """The config the leading dense layers run under: no experts."""
    return dataclasses.replace(cfg, n_experts=0, n_experts_active=0)


# ===================================================================== model =
def _stack_module(layers: list) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleDict({g: nn.ParameterDict(d) for g, d in lp.items()})
        for lp in layers)


class Model(nn.Module):
    """The model's parameters: ``embed``, ``lm_head`` (untied configs),
    ``final_norm``, and the stacks ``layers``, ``dense_layers`` (deepseek's
    leading dense layers) and ``encoder`` (whisper's), each an
    ``nn.ModuleList`` of one ``nn.ModuleDict`` of ``nn.ParameterDict``
    groups (``ln1``, ``attn``, ``ssm``, ``moe``, ``mlp``, ``ln2``,
    ``xattn``, ``ln3``) a layer, empty where the config has none;
    ``enc_final_norm`` and ``frontend_proj`` where the config has an
    encoder or a frontend (else an empty dict and None).  No parameter
    requires grad until :meth:`trainable` (which the training step calls).
    Call it on tokens for :func:`forward_logits`."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"])
        self.final_norm = nn.ParameterDict(tree["final_norm"])
        for name in STACKS:
            setattr(self, name, _stack_module(tree.get(name, [])))
        self.enc_final_norm = nn.ParameterDict(tree.get("enc_final_norm", {}))
        fp = tree.get("frontend_proj")
        self.frontend_proj = None if fp is None else nn.Parameter(fp)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def trainable(self) -> "Model":
        """Let every parameter require grad; returns the model."""
        return self.requires_grad_(True)

    def forward(self, tokens, device=None):
        return forward_logits(self, self.cfg, tokens, device=device)[0]


def _model_from_leaves(cfg: ArchConfig, make) -> Model:
    """A :class:`Model` whose leaf at stacked path ``path`` (shape ``sh``)
    is ``make(path, sh, i)``: the ``i``-th tensor of a stacked leaf (of
    the ``i``-th layer that has its group), one layer at a time, and the
    whole leaf for ``i`` None."""
    stacks = _stack_layers(cfg)
    holders = {name: _holders(layers) for name, layers in stacks.items()}
    tree: dict = {}
    for path, sh in _leaves(param_shapes(cfg)):
        if path[0] in STACKS:
            layers = tree.setdefault(path[0],
                                     [{} for _ in stacks[path[0]]])
            for i, at in enumerate(holders[path[0]][path[1]]):
                layers[at].setdefault(path[1], {})[path[2]] = \
                    make(path, sh, i)
        elif len(path) == 2:
            tree.setdefault(path[0], {})[path[1]] = make(path, sh, None)
        else:
            tree[path[0]] = make(path, sh, None)
    return Model(cfg, tree)


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Model:
    """Random init on ``device`` with the reference's recipe (ones for norm
    scales and D, zeros for biases, log(linspace(1, 16)) for A_log, normal
    over sqrt(fan in) of the stacked leaf for weights) drawn from a
    ``torch.Generator`` seeded with ``seed``: the same recipe, not the
    reference's numbers.  Each layer of a stack is drawn on its own, so the
    largest transient is one layer's leaf in float32."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def make(path, sh, i):
        dt = param_dtype(path)
        name = path[-1]
        one = sh if i is None else sh[1:]
        if name in ("scale", "norm", "q_norm", "k_norm", "D"):
            return torch.ones(one, dtype=dt, device=dev)
        if name in ("bias", "conv_b", "dt_bias"):
            return torch.zeros(one, dtype=dt, device=dev)
        if name == "A_log":
            row = torch.log(torch.linspace(1.0, 16.0, sh[-1], device=dev))
            return (row * torch.ones(one, device=dev)).to(dt)
        fan_in = sh[-2] if len(sh) >= 2 else sh[-1]
        w = torch.randn(one, generator=gen, device=dev) / np.sqrt(fan_in)
        return w.to(dt)

    return _model_from_leaves(cfg, make)


def abstract_params(cfg: ArchConfig) -> Model:
    """A :class:`Model` of ``meta`` tensors in the parameter dtypes: shapes
    and dtypes only, nothing allocated (the dry run's parameters)."""
    return _model_from_leaves(cfg, lambda path, sh, i: torch.empty(
        sh if i is None else sh[1:], dtype=param_dtype(path), device="meta"))


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
    for path, sh in want.items():
        if tuple(np.shape(have[path])) != sh:
            raise ValueError(f"{'/'.join(path)}: shape "
                             f"{tuple(np.shape(have[path]))}, expected {sh}")

    def make(path, sh, i):
        a = have[path] if i is None else np.asarray(have[path])[i]
        return _tensor_from_numpy(a).to(dev, dtype or param_dtype(path))

    return _model_from_leaves(cfg, make)


def leaf_path(name: str) -> tuple[tuple, int | None]:
    """The reference's tree path of the :class:`Model` parameter ``name``
    (``"layers.3.attn.wq"`` -> ``("layers", "attn", "wq")``) and its layer
    in the stack (3; None outside the stacks)."""
    parts = tuple(name.split("."))
    if parts[0] in STACKS:
        return (parts[0],) + parts[2:], int(parts[1])
    return parts, None


def named_to_tree(named: dict) -> dict:
    """Arrays keyed by :class:`Model` parameter names as the reference's
    tree: nested dicts, a stack's layers stacked on axis 0 in layer
    order."""
    tree: dict = {}
    stacked: dict = {}
    for name, a in named.items():
        path, i = leaf_path(name)
        if i is not None:
            stacked.setdefault(path, {})[i] = a
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    for path, layers in stacked.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack([layers[i] for i in sorted(layers)])
    return tree


def named_from_tree(tree: dict, names) -> dict:
    """The reference's tree (layers stacked on axis 0) as arrays keyed by
    the parameter ``names``: each stacked leaf sliced at the name's
    layer."""
    out = {}
    for name in names:
        path, i = leaf_path(name)
        a = tree
        for k in path:
            a = a[k]
        out[name] = a if i is None else np.asarray(a)[i]
    return out


def params_to_numpy(model: Model) -> dict:
    """The model's parameters as the reference's tree: numpy arrays, layers
    stacked on axis 0 (bf16 leaves as float32, which holds them exactly)."""
    return named_to_tree({name: p.detach().float().cpu().numpy()
                          for name, p in model.named_parameters()})


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


def _bind(params: Model, device) -> torch.device:
    """Resolve ``device`` and check the model lies there."""
    dev = resolve_device(device, meta=True)
    if not same_device(params.device, dev):
        raise ValueError(f"the model lies on {params.device}, not on {dev}")
    return dev


def _put(t, dev: torch.device) -> torch.Tensor:
    """``t`` (a tensor or an array) on ``dev``."""
    if not isinstance(t, torch.Tensor):
        t = _tensor_from_numpy(t)
    return t.to(dev)


def _embed(params: Model, cfg: ArchConfig, tokens):
    if pctx.is_dtensor(params.embed):
        x = pctx.reduce_output(
            pctx.vocab_parallel_embedding(tokens, params.embed))
    else:
        x = params.embed[tokens]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def _unembed(params: Model, cfg: ArchConfig, x):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    with obs.span("repro_torch.unembed"):
        if pctx.is_dtensor(x) and not _vocab_split(params, cfg):
            # the vocab whole on each rank: each rank its own positions
            logits = pctx.local_product(x, w)
        else:
            logits = x @ w
        if cfg.logits_scaling != 1.0:
            logits = logits / cfg.logits_scaling
        return logits


def _project(params: Model, t: torch.Tensor) -> torch.Tensor:
    """Frontend embeddings through ``frontend_proj``, rounded to bf16
    first, as the reference does."""
    w = params.frontend_proj
    return t.bfloat16().to(w.dtype) @ w


def _input(params: Model, cfg: ArchConfig, dev, tokens, embeds):
    """The first layer's input: ``embeds`` [B, S, d] (through the frontend
    where the config has one) when given, else the tokens' embeddings."""
    if embeds is not None:
        x = _put(embeds, dev)
        return _project(params, x) if cfg.frontend else x
    return _embed(params, cfg, _put(tokens, dev).long())


def _positions(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """0..S-1 for each row: [B, S], or [B, S, 3] under M-RoPE."""
    pos = torch.arange(S, device=device).expand(B, S)
    return pos[..., None].expand(B, S, 3) if cfg.m_rope else pos


def _run_encoder(params: Model, cfg: ArchConfig, frames) -> torch.Tensor:
    """Whisper's encoder on precomputed frame embeddings [B, S_enc, d]:
    ``frontend_proj``, the encoder stack (K4 with no mask), its norm."""
    # laid out as a residual: the column-parallel projection's output
    # gathered over the model axis (its norm reduces over d)
    x = pctx.reduce_output(_project(params, frames))
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for lp in params.encoder:
        x = encoder_block(x, lp, cfg, positions)
    return norm(x, params.enc_final_norm, cfg.norm_type, cfg.norm_eps)


def _constrain_residual(x):
    """The residual [B, S, d] redistributed to the ambient context's
    sequence-sharded layout (Megatron-SP) when a context is active and
    ``x`` is a DTensor; else ``x`` itself."""
    ctx = pctx.current()
    if ctx is None or not pctx.is_dtensor(x):
        return x
    return pctx.constrain(x, ctx.residual_sharding(x.shape[0], x.shape[1]))


#: A block kind -> the mixer that the ``repro_torch.layer`` span names.
_LAYER_TYPE = {"ssm": "mamba", "hybrid": "hybrid", "attn": "attention",
               "moe": "attention"}


def _decoder_layer(x, lp, cfg: ArchConfig, positions, enc_out,
                   collect: bool, kind: str):
    """One decoder layer of block kind ``kind``: (x, its aux loss or None
    for a cross-attention layer, its cache elements when ``collect``)."""
    if cfg.cross_attention:
        x, (k, v) = cross_block(x, lp, cfg, positions, enc_out)
        return x, None, ({"k": k, "v": v} if collect else {})
    with obs.span("repro_torch.layer", type=_LAYER_TYPE[kind]):
        return block_forward(x, lp, cfg, positions, collect_cache=collect,
                             kind=kind)


def _remat_layer(x, lp, cfg: ArchConfig, positions, enc_out, kind: str):
    return _decoder_layer(x, lp, cfg, positions, enc_out, False, kind)[:2]


def _run_layers(params: Model, cfg: ArchConfig, x, positions, enc_out,
                collect: bool, remat: bool = False):
    """The leading dense layers, then the decoder layers, over a full
    sequence.  Returns (x, aux summed over the layers, the dense layers'
    and the decoder layers' cache elements, a dict a layer, when
    ``collect``).  Under ``remat`` (and not ``collect``) each decoder
    layer is checkpointed: its activations are recomputed in the backward
    pass, as the reference's ``jax.checkpoint`` of its scanned layer."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    dense_cfg = _dense_view(cfg)
    dense_els, els = [], []
    x = _constrain_residual(x)
    for lp in params.dense_layers:
        with obs.span("repro_torch.layer", type="attention"):
            x, a, el = block_forward(x, lp, dense_cfg, positions,
                                     collect_cache=collect)
        x = _constrain_residual(x)
        aux = aux + a
        dense_els.append(el)
    for lp, kind in zip(params.layers, cfg.layer_kinds):
        if remat and not collect:
            x, a = checkpoint(_remat_layer, x, lp, cfg, positions, enc_out,
                              kind, use_reentrant=False)
            el = {}
        else:
            x, a, el = _decoder_layer(x, lp, cfg, positions, enc_out,
                                      collect, kind)
        x = _constrain_residual(x)
        if a is not None:
            aux = aux + a
        els.append(el)
    return x, aux, dense_els, els


def _hidden(params: Model, cfg: ArchConfig, dev, tokens, embeds, positions,
            enc_frames, remat: bool):
    """The full-sequence forward up to the final norm: (x [B, S, d],
    aux)."""
    x = _input(params, cfg, dev, tokens, embeds)
    B, S = x.shape[:2]
    positions = _positions(cfg, B, S, dev) if positions is None \
        else _put(positions, dev)
    enc_out = _run_encoder(params, cfg, _put(enc_frames, dev)) \
        if cfg.encoder_layers else None
    x, aux, _, _ = _run_layers(params, cfg, x, positions, enc_out,
                               collect=False, remat=remat)
    x = norm(x, params.final_norm, cfg.norm_type, cfg.norm_eps)
    return (pctx.gather_model(x) if _vocab_split(params, cfg) else x), aux


def _vocab_split(params: Model, cfg: ArchConfig) -> bool:
    """Whether the model axis splits the unembedding's vocab: then the
    logits are vocab-parallel (the hidden state gathered over the model
    axis first); else the vocab is whole on each rank and the logits are
    computed on the residual's layout (sequence-parallel where the
    residual is sequence-sharded), so that no rank computes another's."""
    w, dim = (params.embed, 0) if cfg.tie_embeddings \
        else (params.lm_head, 1)
    return not pctx.is_dtensor(w) or pctx.model_shards(w, dim)


@torch.no_grad()
def forward_logits(params: Model, cfg: ArchConfig, tokens=None, embeds=None,
                   positions=None, enc_frames=None, device=None):
    """Full-sequence forward -> (logits [B, S, V], aux).

    ``embeds`` [B, S, d] (precomputed modality embeddings, through
    ``frontend_proj`` where the config has a frontend) replaces the token
    lookup; ``enc_frames`` [B, S_enc, d] feeds the encoder; ``positions``
    is [B, S], or [B, S, 3] under M-RoPE (0..S-1 on every component when
    None).  ``aux`` is the MoE layers' load-balance loss, summed.
    """
    dev = _bind(params, device)
    x, aux = _hidden(params, cfg, dev, tokens, embeds, positions, enc_frames,
                     remat=False)
    return _unembed(params, cfg, x), aux


def forward_hidden(params: Model, cfg: ArchConfig, tokens=None, embeds=None,
                   positions=None, enc_frames=None, remat: bool = True,
                   device=None):
    """Full-sequence forward up to the final norm -> (x [B, S, d], aux),
    differentiable (the inputs as :func:`forward_logits` takes them).
    ``remat`` checkpoints each decoder layer."""
    dev = _bind(params, device)
    return _hidden(params, cfg, dev, tokens, embeds, positions, enc_frames,
                   remat)


def _xent_block(params: Model, cfg: ArchConfig, xc, tc, mc):
    """Masked cross-entropy summed over one block of positions: logits in
    the weights' dtype, then float32 for the log-sum-exp."""
    lf = _unembed(params, cfg, xc).float()
    lse = torch.logsumexp(lf, dim=-1)
    if pctx.is_dtensor(lf):
        # vocab- or sequence-parallel: each rank picks the targets among
        # its own logits
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        tgt = torch.where(tc[..., None] == vocab, lf, 0).sum(-1)
    else:
        tgt = lf.gather(-1, tc[..., None])[..., 0]
    return torch.sum((lse - tgt) * mc)


def _chunked_xent(params: Model, cfg: ArchConfig, x, targets, mask,
                  chunk: int = 512):
    """Mean cross-entropy over the masked positions without the whole
    ``[B, S, V]`` logits: chunks of ``chunk`` positions, each checkpointed
    (its logits recomputed in the backward pass), when ``chunk`` divides
    ``S`` and is shorter; else one block, as in the reference."""
    S = x.shape[1]
    # a sequence-sharded DTensor would gather for each slice: one block
    if S % chunk or S <= chunk or (pctx.is_dtensor(x)
                                   and pctx.shard_parts(x, 1) > 1):
        tot = _xent_block(params, cfg, x, targets, mask)
    else:
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, S, chunk):
            sl = slice(i, i + chunk)
            tot = tot + checkpoint(_xent_block, params, cfg, x[:, sl],
                                   targets[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return tot / mask.sum().clamp(min=1)


def lm_loss(params: Model, cfg: ArchConfig, batch: dict, remat: bool = True,
            aux_weight: float = 0.01, loss_chunk: int = 512, device=None):
    """Next-token cross-entropy plus ``aux_weight`` times the MoE
    load-balance loss -> (loss, {"nll", "aux"}), differentiable.

    ``batch`` holds ``tokens`` [B, S] (targets the next token, the last
    position masked out), or ``embeds`` [B, S, d], ``positions`` and
    ``targets`` [B, S] (every position counted); ``frames`` [B, S_enc, d]
    feed an encoder.  Arrays or tensors; they are put on ``device``.
    """
    dev = _bind(params, device)
    batch = {k: _put(v, dev) for k, v in batch.items()}
    x, aux = _hidden(params, cfg, dev, batch.get("tokens"),
                     batch.get("embeds"), batch.get("positions"),
                     batch.get("frames"), remat)
    B, S = x.shape[:2]
    if "targets" in batch:
        targets = batch["targets"].long()
        mask = torch.ones(B, S, dtype=torch.float32, device=dev)
    else:
        tokens = batch["tokens"].long()
        targets = torch.cat([tokens[:, 1:], tokens.new_zeros(B, 1)], dim=1)
        mask = torch.ones(B, S, dtype=torch.float32, device=dev)
        mask[:, -1] = 0
    nll = _chunked_xent(params, cfg, x, targets, mask, chunk=loss_chunk)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


# ================================================================= decode ====
def _layer_cache_shapes(cfg: ArchConfig, kind: str, batch: int,
                        max_seq: int) -> dict:
    """Shapes of one layer's decode cache entries, of block kind
    ``kind``."""
    per: dict = {}
    if kind in ("attn", "moe", "hybrid"):
        per["k"] = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        per["v"] = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_quant:
            per["k_scale"] = (batch, max_seq, cfg.n_kv_heads)
            per["v_scale"] = (batch, max_seq, cfg.n_kv_heads)
    if kind in ("ssm", "hybrid"):
        per.update(ssm_decode_state_shapes(cfg, batch))
    if cfg.cross_attention:
        per["enc_out"] = (batch, cfg.encoder_seq, cfg.d_model)
    return per


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Shapes of the per-layer decode cache, each entry stacked [L, ...]
    over the layers that have it (all but where ``layer_types`` mixes the
    mixers: then k/v over the attention layers, conv/ssd over the Mamba2
    layers, each in layer order)."""
    per_layer = [_layer_cache_shapes(cfg, kind, batch, max_seq)
                 for kind in cfg.layer_kinds]
    shapes = {"layers": {k: (len(at),) + per_layer[at[0]][k]
                         for k, at in _holders(per_layer).items()}}
    if cfg.first_dense_layers:
        kv = (cfg.first_dense_layers, batch, max_seq, cfg.n_kv_heads,
              cfg.head_dim)
        shapes["dense_layers"] = {"k": kv, "v": kv}
    return shapes


def cache_dtype(name: str, cfg: ArchConfig | None = None) -> torch.dtype:
    """float32 conv and ssd states and scales; k/v int8 under
    ``cfg.kv_quant``, else bf16 like every other entry."""
    if name in ("conv", "ssd") or name.endswith("_scale"):
        return torch.float32
    if cfg is not None and cfg.kv_quant and name in ("k", "v"):
        return torch.int8
    return torch.bfloat16


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """A zero decode cache on ``device``."""
    dev = resolve_device(device)
    return {group: {k: torch.zeros(sh, dtype=cache_dtype(k, cfg), device=dev)
                    for k, sh in shapes.items()}
            for group, shapes in cache_shapes(cfg, batch, max_seq).items()}


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The decode cache as ``meta`` tensors of its shapes and dtypes."""
    return {group: {k: torch.empty(sh, dtype=cache_dtype(k, cfg),
                                   device="meta")
                    for k, sh in shapes.items()}
            for group, shapes in cache_shapes(cfg, batch, max_seq).items()}


def _decode_stack(x, layers, cfg: ArchConfig, stacked: dict, pos: int,
                  kinds=None):
    """One token through a stack of layers, of block kinds ``kinds``
    (the config's block kind throughout when None), and its cache group:
    each layer reads the next entry of each stacked leaf its kind has."""
    kinds = kinds or (cfg.block_kind,) * len(layers)
    at = dict.fromkeys(stacked, 0)
    for lp, kind in zip(layers, kinds):
        keys = [k for k in _layer_cache_shapes(cfg, kind, 0, 0)
                if k in stacked]
        cl = {k: stacked[k][at[k]] for k in keys}
        x, ncl = block_decode(x, lp, cfg, cl, pos, kind=kind)
        for k in ("conv", "ssd"):
            if k in ncl:
                stacked[k][at[k]] = ncl[k]
        for k in keys:
            at[k] += 1
    return x


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, cache: dict, token, pos: int,
                device=None):
    """One-token decode.  token: [B] ints; pos: the position of the token.

    Returns (logits [B, V], cache): the cache is updated in place (k/v and
    their scales at ``pos``, the conv and ssd states replaced; ``enc_out``
    unchanged) and returned.  The leading dense layers run first.
    """
    dev = _bind(params, device)
    x = _embed(params, cfg, _put(token, dev).long()[:, None])
    pos = int(pos)
    if cfg.first_dense_layers:
        x = _decode_stack(x, params.dense_layers, _dense_view(cfg),
                          cache["dense_layers"], pos)
    x = _decode_stack(x, params.layers, cfg, cache["layers"], pos,
                      cfg.layer_kinds)
    x = pctx.gather_model(
        norm(x, params.final_norm, cfg.norm_type, cfg.norm_eps))
    return _unembed(params, cfg, x)[:, 0], cache


def _cache_of(els: list, cfg: ArchConfig, B: int, S: int,
              max_seq: int) -> dict:
    """A stack's decode cache from its layers' prefill elements: k/v in a
    cache of ``max_seq`` positions, zero past the prompt (the reference's
    padding); under ``cfg.kv_quant`` int8 with float32 scales, quantised
    as decode quantises."""
    if els and pctx.is_dtensor(next(iter(els[0].values()))):
        return _cache_of_layout(els, cfg, S, max_seq)
    out: dict = {}
    held = {name: len(layers) for name, layers in _holders(els).items()}

    def put(name, t, seq: bool, of: str):
        # the next entry of leaf ``name``, stacked over the layers that
        # have element ``of``
        if name not in out:
            shape = (held[of], B, max_seq) + t.shape[2:] if seq \
                else (held[of],) + t.shape
            out[name] = torch.zeros(shape, dtype=t.dtype, device=t.device)
            at[name] = 0
        if seq:
            out[name][at[name], :, :S] = t
        else:
            out[name][at[name]] = t
        at[name] += 1

    at: dict = {}
    for el in els:
        for name, t in el.items():
            if name in ("k", "v") and cfg.kv_quant:
                q, s = quantize_kv(t)
                put(name, q, True, name)
                put(f"{name}_scale", s, True, name)
            else:
                put(name, t, name in ("k", "v"), name)
    return out


def _cache_of_layout(els: list, cfg: ArchConfig, S: int,
                     max_seq: int) -> dict:
    """:func:`_cache_of` for DTensor elements: each leaf stacked over the
    layers, k/v (and scales) zero-padded to ``max_seq`` positions, then
    laid out by the context's cache layouts (``cache_pspecs``), as the
    reference's prefill emits its cache to its output shardings."""
    from repro_torch.parallel import sharding

    def pad(t):
        if max_seq == S:
            return t
        widths = [0, 0] * (t.ndim - 3) + [0, max_seq - S]
        return pctx.local_op(lambda a: F.pad(a, widths),
                             pctx.replicate_dims(t, [2]))

    out: dict = {}
    for name in _holders(els):
        ts = [el[name] for el in els if name in el]
        if name in ("k", "v") and cfg.kv_quant:
            qs = [quantize_kv(t) for t in ts]
            out[name] = pad(torch.stack([q for q, _ in qs]))
            out[f"{name}_scale"] = pad(torch.stack([s for _, s in qs]))
        elif name in ("k", "v"):
            out[name] = pad(torch.stack(ts))
        else:
            out[name] = torch.stack(ts)
    ctx = pctx.current()
    if ctx is None:
        return out
    plan = sharding.MeshPlan(ctx.mesh, ctx.dp_axes, ctx.model_axis)
    specs = sharding.cache_pspecs(plan, out)
    return {k: pctx.constrain(t, specs[k]) for k, t in out.items()}


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, tokens=None, embeds=None,
            enc_frames=None, max_seq: int | None = None, device=None):
    """Run the prompt, build the decode cache.  Returns (last_logits [B, V],
    cache).

    ``embeds`` (qwen2-vl's patch embeddings, through ``frontend_proj``)
    replaces the tokens when given; ``enc_frames`` feeds whisper's encoder,
    whose output the cache keeps for every layer.  Attention archs emit
    K/V (written into a cache of ``max_seq`` positions, zero past the
    prompt: the reference's padding), the leading dense layers' too; SSM
    and hybrid archs also emit the final conv and SSD states of the
    chunked scan.
    """
    dev = _bind(params, device)
    x = _input(params, cfg, dev, tokens, embeds)
    B, S = x.shape[:2]
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt {S}")
    positions = _positions(cfg, B, S, dev)
    enc_out = _run_encoder(params, cfg, _put(enc_frames, dev)) \
        if cfg.encoder_layers else None
    x, _, dense_els, els = _run_layers(params, cfg, x, positions, enc_out,
                                       collect=True)
    x = pctx.gather_model(
        norm(x, params.final_norm, cfg.norm_type, cfg.norm_eps))
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    with obs.span("repro_torch.cache"):
        cache = {"layers": _cache_of(els, cfg, B, S, max_seq)}
        if cfg.first_dense_layers:
            cache["dense_layers"] = _cache_of(dense_els, cfg, B, S, max_seq)
    if cfg.cross_attention:
        cache["layers"]["enc_out"] = enc_out.expand(
            (len(els),) + enc_out.shape).contiguous()
    return logits, cache
