"""Deterministic synthetic token pipeline with per-host sharding, prefetch
and fault re-dispatch (the port's own copy of ``repro.data.pipeline``,
which is numpy only).

Determinism contract: ``batch_at(step, shard)`` is a pure function of
(seed, step, shard), bit-equal to the reference's for every family, so a
restarted job replays the same token stream and a dead host's shards can
be recomputed by any survivor (:func:`shard_assignment`).  Batches are
numpy arrays; the training step puts them on its device.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


def shard_assignment(n_shards: int,
                     alive_hosts: list[int]) -> dict[int, list[int]]:
    """Round-robin shard ownership over the alive hosts (straggler or
    failure re-dispatch).  Deterministic: every survivor computes the same
    map."""
    alive = sorted(alive_hosts)
    out: dict[int, list[int]] = {h: [] for h in alive}
    for s in range(n_shards):
        out[alive[s % len(alive)]].append(s)
    return out


class SyntheticTokens:
    """Deterministic LM token batches: dicts matching the model's batch
    contract for the arch family (``tokens``; ``embeds``, ``positions``
    and ``targets`` for vlm; ``tokens`` and ``frames`` for audio)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 n_shards: int = 1, shard: int = 0, seed: int = 0,
                 prefetch: int = 2, family: str = "dense",
                 d_model: int = 0, encoder_seq: int = 0):
        if batch % n_shards:
            raise ValueError(f"batch {batch} is not a multiple of "
                             f"n_shards {n_shards}")
        self.vocab = vocab_size
        self.local_batch = batch // n_shards
        self.seq = seq_len
        self.shard = shard
        self.n_shards = n_shards
        self.seed = seed
        self.family = family
        self.d_model = d_model
        self.encoder_seq = encoder_seq
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = 0
        self._thread: threading.Thread | None = None

    # -- pure batch function --------------------------------------------------
    def batch_at(self, step: int, shard: int | None = None) -> dict:
        shard = self.shard if shard is None else shard
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        b = {"tokens": rng.integers(
            1, self.vocab, (self.local_batch, self.seq)).astype(np.int32)}
        if self.family == "vlm":
            b = {"embeds": rng.standard_normal(
                     (self.local_batch, self.seq, self.d_model)
                 ).astype(np.float32),
                 "positions": np.broadcast_to(
                     np.arange(self.seq, dtype=np.int32)[None, :, None],
                     (self.local_batch, self.seq, 3)).copy(),
                 "targets": rng.integers(
                     1, self.vocab,
                     (self.local_batch, self.seq)).astype(np.int32)}
        elif self.family == "audio":
            b["frames"] = rng.standard_normal(
                (self.local_batch, self.encoder_seq, self.d_model)
            ).astype(np.float32)
        return b

    # -- prefetching iterator -------------------------------------------------
    def _producer(self):
        step = self._step
        while True:
            self._q.put((step, self.batch_at(step)))
            step += 1

    def __iter__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()
        return self

    def __next__(self):
        step, batch = self._q.get()
        self._step = step + 1
        return batch
