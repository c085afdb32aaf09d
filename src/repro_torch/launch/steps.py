"""Train, prefill and serve step functions, and the abstract inputs of a
cell (counterpart of ``repro.launch.steps``).

:func:`input_specs` and :func:`abstract_opt_state` give ``meta`` tensors
of the reference's shapes and dtypes: what the dry run
(:mod:`repro_torch.launch.dryrun`) lays out and traces.  The train step's
microbatch pieces (:func:`split_microbatches`, :func:`zero_grads`,
:func:`accumulate_microbatch`) are public so the dry run can trace one
slice and count it once a slice.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.nn import model as M
from repro_torch.nn.config import ArchConfig
from repro_torch.parallel import context as pctx
from repro_torch.train.optim import AdamWConfig, adamw_update


def grads_of(model, cfg: ArchConfig, batch: dict, remat: bool = True,
             device=None):
    """(loss, metrics, gradients keyed by parameter name) of ``lm_loss``
    at ``batch``; a parameter the loss does not reach gets zeros."""
    with obs.span("repro_torch.grads"):
        with obs.span("repro_torch.loss"):
            loss, metrics = M.lm_loss(model, cfg, batch, remat=remat,
                                      device=device)
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(named.items(), grads)}


def split_microbatches(batch: dict, microbatches: int) -> dict:
    """Each leaf ``[n, ...]`` as ``[microbatches, n / microbatches, ...]``:
    slice ``i`` is rows ``i * size`` to ``(i + 1) * size``.

    A DTensor leaf whose rows are sharded over ``P`` data ranks is split as
    data-parallel training splits it: each rank cuts its own ``n / P``
    rows into the slices (slice ``i`` is every rank's ``i``-th run of ``n /
    (P m)`` rows), so no row moves.  Where a rank's rows do not split so,
    the rows are gathered first and each slice laid out over the data
    axes."""
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch of {n} does not split into {microbatches} "
                         "microbatches")
    size = n // microbatches
    return {k: _split_rows(v, microbatches, size) for k, v in batch.items()}


def _split_rows(v, microbatches: int, size: int):
    rest = tuple(v.shape[1:])
    if not pctx.is_dtensor(v):
        return v.reshape((microbatches, size) + rest)
    parts = pctx.shard_parts(v, 0)
    if size % parts == 0:
        per = size // parts
        return v.reshape((parts, microbatches, per) + rest).transpose(
            0, 1).reshape((microbatches, size) + rest)
    v = pctx.replicate_dims(v, [0]).reshape((microbatches, size) + rest)
    ctx = pctx.current()
    if ctx is None:
        return v
    dp = pctx.dp_spec(pctx.axis_sizes(ctx.mesh), ctx.dp_axes, size)
    return pctx.constrain(v, (None, dp) + (None,) * len(rest))


def zero_grads(model) -> dict:
    """float32 zeros laid out as each parameter: the gradient
    accumulators of a microbatched step."""
    return {name: torch.zeros_like(p, dtype=torch.float32)
            for name, p in model.named_parameters()}


def accumulate_microbatch(model, cfg: ArchConfig, slices: dict, i: int,
                          acc: dict, loss, microbatches: int,
                          remat: bool = True, device=None):
    """Slice ``i`` of ``slices`` (:func:`split_microbatches`): its loss and
    gradients, each divided by the slice count, added in float32 to
    ``loss`` and (in place) ``acc``.  Returns (loss, the slice's
    metrics)."""
    part = {k: v[i] for k, v in slices.items()}
    l, metrics, g = grads_of(model, cfg, part, remat, device)
    loss = loss + l.float() / microbatches
    for name, a in acc.items():
        a += g[name].float() / microbatches
    return loss, metrics


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                    remat: bool = True, microbatches: int = 1, device=None):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the loss and its gradients (``lm_loss``, each decoder layer
    checkpointed under ``remat``), then AdamW, the model and the state
    updated in place, on ``device`` (None: CUDA), where ``lm_loss`` puts a
    numpy batch.

    ``microbatches > 1`` splits the batch into that many slices along
    axis 0, one after another, and accumulates the loss and gradients in
    float32, each divided by the slice count, as the reference's scan
    does; ``nll`` and ``aux`` are the last slice's.  ``metrics`` holds
    ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``, 0-d tensors on
    the device (read them on the host only where needed: each read waits
    for the card).
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model, opt_state, batch):
        with obs.step("repro_torch.train_step"):
            model.trainable()
            if microbatches == 1:
                loss, metrics, grads = grads_of(model, cfg, batch, remat,
                                                device)
            else:
                slices = split_microbatches(batch, microbatches)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                grads = zero_grads(model)
                for i in range(microbatches):
                    loss, metrics = accumulate_microbatch(
                        model, cfg, slices, i, grads, loss, microbatches,
                        remat, device)
            with obs.span("repro_torch.optimizer"):
                model, opt_state, opt_metrics = adamw_update(
                    model, grads, opt_state, opt_cfg)
            return model, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ArchConfig, max_seq: int | None = None,
                      device=None):
    """``prefill_step(params, batch) -> (last_logits [B, V], cache)`` with
    ``batch["tokens"]`` [B, S] or ``batch["embeds"]`` [B, S, d] (patch
    embeddings), ``batch["frames"]`` [B, S_enc, d] for an encoder, and a
    cache of ``max_seq`` positions (the prompt's length when None), on
    ``device`` (None: CUDA)."""
    def prefill_step(params, batch):
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        B, L = (tokens if tokens is not None else embeds).shape[:2]
        with obs.step("repro_torch.prefill_step", B=B, L=L):
            return M.prefill(params, cfg, tokens=tokens, embeds=embeds,
                             enc_frames=batch.get("frames"), max_seq=max_seq,
                             device=device)
    return prefill_step


def make_serve_step(cfg: ArchConfig, device=None):
    """``serve_step(params, cache, token, pos) -> (logits [B, V], cache)``:
    one decode step, the cache updated in place, on ``device`` (None:
    CUDA)."""
    def serve_step(params, cache, token, pos):
        return M.decode_step(params, cfg, cache, token, pos, device=device)
    return serve_step


# ------------------------------------------------------- abstract inputs ----
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Abstract model inputs for one (arch x shape) cell, as ``meta``
    tensors.

    train/prefill: the batch dict.  decode: {"cache", "token", "pos"} with
    the KV cache sized to the cell's seq_len.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            batch = {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                     "positions": _meta((B, S, 3), torch.int32)}
            if shape.kind == "train":
                batch["targets"] = _meta((B, S), torch.int32)
        else:
            batch = {"tokens": _meta((B, S), torch.int32)}
            if cfg.family == "audio":
                batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                        torch.bfloat16)
        return {"batch": batch}
    # decode: one new token against a seq_len cache
    return {"cache": M.abstract_cache(cfg, B, S),
            "token": _meta((B,), torch.int32),
            "pos": _meta((), torch.int32)}


def abstract_opt_state(model) -> dict:
    """The optimizer state of ``model`` (:func:`~repro_torch.nn.model.
    abstract_params`' on ``meta``) as ``meta`` tensors: float32 moments
    keyed by parameter name, an int32 step."""
    def f32():
        return {name: _meta(p.shape, torch.float32)
                for name, p in model.named_parameters()}
    return {"m": f32(), "v": f32(), "step": _meta((), torch.int32)}
