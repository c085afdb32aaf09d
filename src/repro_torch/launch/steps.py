"""Train, prefill and serve step functions (counterpart of
``repro.launch.steps``).

The dry-run's abstract input specs (``input_specs``,
``abstract_opt_state``) wait for the compile-and-price path (ROADMAP queue
item 14).
"""
from __future__ import annotations

import torch

from repro_torch.nn import model as M
from repro_torch.nn.config import ArchConfig
from repro_torch.train.optim import AdamWConfig, adamw_update


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

    def grads_of(model, batch):
        loss, metrics = M.lm_loss(model, cfg, batch, remat=remat,
                                  device=device)
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
            name: torch.zeros_like(p) if g is None else g
            for (name, p), g in zip(named.items(), grads)}

    def train_step(model, opt_state, batch):
        model.trainable()
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{microbatches} microbatches")
            size = n // microbatches
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                     for name, p in model.named_parameters()}
            for i in range(microbatches):
                part = {k: v[i * size:(i + 1) * size]
                        for k, v in batch.items()}
                l, metrics, g = grads_of(model, part)
                loss = loss + l.float() / microbatches
                for name, acc in grads.items():
                    acc += g[name].float() / microbatches
        model, opt_state, opt_metrics = adamw_update(model, grads, opt_state,
                                                     opt_cfg)
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
        return M.prefill(params, cfg, tokens=batch.get("tokens"),
                         embeds=batch.get("embeds"),
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
