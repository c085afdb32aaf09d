"""Batched serving engine: decode with slot-based batching (counterpart of
``repro.serve.engine``).

A fixed-size batch of decode slots; requests queue up, are admitted into
free slots, and decode proceeds for the whole batch every step (finished
slots are refilled between steps without stopping the batch).  As in the
reference, a prompt is ingested one token at a time through
:func:`repro_torch.nn.model.decode_step`, so the engine reaches no kernel;
each of its decode calls runs the whole batch, the other slots on token 0,
as the reference's do.  It runs on the card unless built with
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn import model as M
from repro_torch.nn.config import ArchConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: M.Model, batch_slots: int = 4,
                 max_seq: int = 128, device=None):
        self.device = resolve_device(device)
        if not M.same_device(params.device, self.device):
            raise ValueError(f"the model lies on {params.device}, not on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_seq = max_seq
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, dtype=np.int64)
        self.finished: list[Request] = []
        self.cache = M.init_cache(cfg, batch_slots, max_seq, self.device)

    def _decode(self, toks: np.ndarray, pos: int):
        return M.decode_step(self.params, self.cfg, self.cache,
                             torch.from_numpy(toks), pos, device=self.device)

    def submit(self, req: Request):
        """Enqueue a request after validating it: the prompt must be
        non-empty, ``max_new_tokens`` positive, and the prompt shorter than
        the engine's ``max_seq`` cache window (``ValueError`` otherwise)."""
        if not req.prompt:
            raise ValueError(f"request {req.uid}: prompt must be non-empty")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} "
                f"exceeds the engine's max_seq = {self.max_seq} window")
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _admit(self):
        """Fill free slots by decoding the prompt token by token."""
        for s in range(self.B):
            if self.slots[s] is None and self.queue:
                req = self.queue.popleft()
                self.slots[s] = req
                self._reset_slot(s)
                self.pos[s] = 0
                for t in req.prompt[:-1]:
                    self._step_single(s, t)
                req._next = req.prompt[-1]

    def _reset_slot(self, s: int):
        """Zero a reused slot's recurrent state: KV entries are gated by
        position masks, but the conv and SSD states accumulate."""
        for name in ("conv", "ssd"):
            if name in self.cache["layers"]:
                self.cache["layers"][name][:, s] = 0

    def _step_single(self, s: int, token: int):
        """Advance one slot one token (prompt ingestion)."""
        toks = np.zeros(self.B, dtype=np.int64)
        toks[s] = token
        logits, self.cache = self._decode(toks, int(self.pos[s]))
        self.pos[s] += 1
        return logits

    # ------------------------------------------------------------------
    def step(self):
        """One engine tick: admit work, decode one token for active slots.
        Slots at different positions step in sub-groups of equal position,
        since a decode step takes one position."""
        self._admit()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            return False
        by_pos: dict[int, list[int]] = {}
        for s in active:
            by_pos.setdefault(int(self.pos[s]), []).append(s)
        for pos, group in by_pos.items():
            toks = np.zeros(self.B, dtype=np.int64)
            for s in group:
                toks[s] = self.slots[s]._next
            logits, self.cache = self._decode(toks, pos)
            nxt = logits.argmax(dim=-1).cpu().numpy()
            for s in group:
                req = self.slots[s]
                tok = int(nxt[s])
                req.output.append(tok)
                req._next = tok
                self.pos[s] += 1
                if (len(req.output) >= req.max_new_tokens
                        or tok == req.eos_id
                        or self.pos[s] >= self.max_seq - 1):
                    req.done = True
                    self.slots[s] = None
                    self.finished.append(req)
        return True

    def run_until_done(self, max_ticks: int = 1000) -> list[Request]:
        """Run engine ticks until queue and slots drain (or ``max_ticks``).
        Returns every request completed so far, in completion order."""
        ticks = 0
        while (self.queue or any(self.slots)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
