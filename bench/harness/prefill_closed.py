"""Closed-loop batched prefill through ``make_prefill_step``.

One client submits a batch of prompts of one length and waits for their
first tokens (the argmax of ``last_logits``, read on the host) before it
submits the next.  The lengths follow the traffic file
(:mod:`harness.traffic`), each step ``tokens_per_step`` tokens, the cache
``L + cache_extra`` positions.  A request's time to first token runs from
its batch's submission to that read.

Which steps are judged is drawn from the seed as the window runs: for each
length, ``steps_per_length`` of its steps, uniformly over those the window
finished (a reservoir), each kept with its prompts, its logits and one row's
cache (a row drawn from the seed).  After the window the reference
recomputes them (:mod:`reference.prefill`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from reference import prefill as ref_prefill

from . import checks, trace, traffic
from .weights import arch_config, build_model, leaf_specs, make_weights


@dataclasses.dataclass
class Sample:
    index: int
    tokens: torch.Tensor
    logits: torch.Tensor
    served: torch.Tensor
    row: int
    cache: dict


def cache_row(cache: dict, row: int) -> dict:
    """One row's copy of each cache leaf, the leading dense layers' k and v
    first: {k, v [layers, max_seq, KH, D], conv, ssd}."""
    groups = [cache[g] for g in ("dense_layers", "layers") if g in cache]
    keys = dict.fromkeys(k for g in groups for k in g)
    return {k: torch.cat([g[k][:, row] for g in groups if k in g])
            for k in keys}


class Reservoir:
    """``k`` steps of each length, uniform over those offered, drawn from
    ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = traffic.rng(seed, "sample")
        self.seen: dict[int, int] = {}
        self.kept: dict[int, list] = {}

    def slot(self, L: int) -> int | None:
        n = self.seen[L] = self.seen.get(L, 0) + 1
        kept = self.kept.setdefault(L, [])
        if len(kept) < self.k:
            kept.append(None)
            return len(kept) - 1
        j = int(self.rng.integers(n))
        return j if j < self.k else None

    def offer(self, index, tokens, logits, cache, served) -> None:
        L = tokens.shape[1]
        i = self.slot(L)
        if i is None:
            return
        row = int(self.rng.integers(tokens.shape[0]))
        self.kept[L][i] = Sample(index, tokens.clone(), logits.clone(),
                                 served.clone(), row, cache_row(cache, row))

    def samples(self) -> list[Sample]:
        return sorted((s for v in self.kept.values() for s in v),
                      key=lambda s: s.index)


@dataclasses.dataclass
class Window:
    seconds: float
    steps: list            # (B, L) of every step
    step_s: list           # each step's wall time
    ttft: list             # seconds, one a request
    attempted: int
    failed: int

    def end_to_end(self) -> dict:
        tokens = sum(B * L for B, L in self.steps)
        return {"prefill_tokens_per_s": tokens / self.seconds,
                "ttft_p95_ms": 1e3 * float(np.percentile(self.ttft, 95))}


class Run:
    """The program set up for one cell and seed: weights on the device
    (each residual branch's last projection narrowed by the mix's
    ``init_residual_scale``), one prefill step a length, each length
    warmed once."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        from repro_torch.launch.steps import make_prefill_step

        t = cell.traffic
        self.cfg = arch_config(cell.config)
        self.weights = make_weights(leaf_specs(self.cfg), seed, self.dev,
                                    t.get("init_residual_scale", 1.0))
        self.model = build_model(self.cfg, self.weights)
        self.lengths = sorted(set(t["lengths"]))
        self.fns = {L: make_prefill_step(self.cfg, L + t["cache_extra"],
                                         device=self.dev)
                    for L in self.lengths}
        self.order = traffic.lengths(t, seed)
        self.tokens = self._generator("tokens")
        self.reservoir = Reservoir(t["check"]["steps_per_length"], seed)
        self.ref = None
        warm = self._generator("warm-up")
        for L in self.lengths:
            self._step(L, warm)

    def _generator(self, stream: str) -> torch.Generator:
        word = int(traffic.rng(self.seed, stream).integers(1 << 62))
        return torch.Generator(device=self.dev).manual_seed(word)

    def _prompts(self, L: int, gen) -> torch.Tensor:
        B = traffic.batch_rows(self.cell.traffic, L)
        return torch.randint(0, self.cfg.vocab_size, (B, L), generator=gen,
                             device=self.dev, dtype=torch.int32)

    def _serve(self, toks):
        """One step: (logits, cache, served tokens and finiteness on the
        host)."""
        logits, cache = self.fns[toks.shape[1]](self.model, {"tokens": toks})
        first = torch.stack([logits.argmax(-1),
                             torch.isfinite(logits).all(-1).long()]).cpu()
        return logits, cache, first

    def _step(self, L: int, gen):
        self._serve(self._prompts(L, gen))
        return (traffic.batch_rows(self.cell.traffic, L), L)

    def window(self, seconds: float) -> Window:
        ttft, steps, step_s = [], [], []
        attempted = failed = 0
        start = time.perf_counter()
        end = start + seconds
        while True:
            toks = self._prompts(next(self.order), self.tokens)
            sent = time.perf_counter()
            logits, cache, first = self._serve(toks)
            done = time.perf_counter()
            B, L = toks.shape
            ttft.extend([done - sent] * B)
            step_s.append(done - sent)
            attempted += B
            failed += int((first[1] == 0).sum())
            self.reservoir.offer(len(steps), toks, logits, cache, first[0])
            steps.append((B, L))
            del logits, cache
            if done >= end:
                break
        return Window(done - start, steps, step_s, ttft, attempted, failed)

    def trace(self, sync) -> trace.Trace:
        """One step of each length, in increasing length, profiled (after
        as many under the profiler's warm-up)."""
        gen = self._generator("trace")
        return trace.profile_stretch(
            lambda: [self._step(L, gen) for L in self.lengths], sync)

    def free(self) -> None:
        """Drop the program's objects; the weights stay for the
        reference."""
        self.model = self.fns = None

    def _reference(self, samples, quant=None):
        return ref_prefill.forward(self.weights, self.cell.config,
                                   [(s.tokens, s.row) for s in samples],
                                   quant)

    def check(self, quant=None) -> dict:
        """The check's numbers of the steps the window sampled, the
        program freed first: of the program's outputs, or with ``quant``
        of the reference computed in that precision put in the program's
        place (the control), each against the float32 reference's
        outputs (computed once)."""
        self.free()
        samples = self.reservoir.samples()
        if self.ref is None:
            self.ref = self._reference(samples)
        if quant is None:
            return checks.prefill_numbers(
                [s.served for s in samples], [s.logits for s in samples],
                [s.cache for s in samples], self.ref)
        ctl = self._reference(samples, quant)
        return checks.prefill_numbers(
            [lg.argmax(-1) for lg, _ in ctl], [lg for lg, _ in ctl],
            [c for _, c in ctl], self.ref)
