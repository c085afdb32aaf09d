"""Prefill and serve step functions (counterpart of ``repro.launch.steps``).

``make_train_step`` and the abstract input specs of the dry-run wait for the
training slice and the compile-and-price path (ROADMAP queue items 6 and
14).
"""
from __future__ import annotations

from repro_torch.nn import model as M
from repro_torch.nn.config import ArchConfig


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
