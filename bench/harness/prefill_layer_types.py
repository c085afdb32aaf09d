"""Closed-loop batched prefill of a stack whose layers differ in their
mixer (granite-4.0-h), through ``make_prefill_step``.

The loop and the sampling of the judged steps are
:mod:`harness.prefill_closed`'s.  What differs:

- the program's ``ArchConfig`` is the configuration file's ``arch_config``
  object, each key a field of it: set-up raises where a key names no field
  of the program under test (a program without ``layer_types`` would run
  another model);
- the reference is :mod:`reference.layer_types`, given that object and
  the file's ``moe_chunk_tokens``;
- the judge takes the program's expert choices.  Top-k routing over 40
  layers flips between bf16 and float32 wherever two experts nearly tie
  (5 % of tokens in the first layer, 71 % by the last; PERF.md §2), so a
  reference that routes on its own lies apart from a sound program by as
  much as rounding itself does.  The window keeps the expert ids of every
  routing call (``nn.moe.route``) of each sampled step, and the float32
  reference computes the step on them (:class:`Fed`).  What they chose is
  judged on its own: ``route_gap`` and ``route_gap_mean``, the widest and
  the mean, over the tokens of every routing call, of how far the router's
  float32 probability of a token's weakest chosen expert lies below its
  ``K``-th best, as a share of that best (0 where it chose the top ``K``).
  The control (``quant``) puts the reference in that precision in the
  program's place, its own choices with it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from reference import layer_types as ref_layer_types

from . import checks, prefill_closed


def program_config(config: dict) -> dict:
    """The configuration as the program's ``ArchConfig`` takes it (its
    ``arch`` as the name), and as the reference reads it (with
    ``moe_chunk_tokens``); raises ``ValueError`` where a key of
    ``arch_config`` names no field of the program's ``ArchConfig``."""
    from repro_torch.nn.config import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    unknown = sorted(set(config["arch_config"]) - fields)
    if unknown:
        raise ValueError(f"the program's ArchConfig has no field "
                         f"{', '.join(unknown)}: it cannot run "
                         f"{config['arch']} as configured")
    return dict(config["arch_config"], arch=config["arch"],
                moe_chunk_tokens=config["moe_chunk_tokens"])


class Fed:
    """A step's expert ids [D, T, K], one a routing call, given to the
    reference call by call (a reference ``pick``), each call's gaps
    kept: per token, ``(p_K - p_min) / p_K``, ``p_K`` the ``K``-th best
    probability and ``p_min`` that of the weakest chosen.  Ids that do not
    fit the call (a step whose calls differ from the reference's) give
    way to the reference's own choice, and a gap of NaN."""

    def __init__(self, ids: list):
        self.ids = iter(ids)
        self.gaps: list[torch.Tensor] = []

    def __call__(self, probs: torch.Tensor, K: int) -> torch.Tensor:
        given = next(self.ids, None)
        if given is None or given.numel() != probs.shape[0] * K:
            self.gaps.append(torch.tensor([math.nan]))
            return ref_layer_types.top_ids(probs, K)
        ids = given.reshape(probs.shape[0], K).to(probs.device)
        best = probs.topk(K, dim=-1).values[:, -1]
        low = probs.gather(-1, ids).min(-1).values
        self.gaps.append(((best - low) / best).clamp(min=0))
        return ids


class Taken:
    """A reference ``pick`` that takes the top ``K`` and keeps them."""

    def __init__(self):
        self.ids: list[torch.Tensor] = []

    def __call__(self, probs: torch.Tensor, K: int) -> torch.Tensor:
        self.ids.append(ref_layer_types.top_ids(probs, K))
        return self.ids[-1]


class Reservoir(prefill_closed.Reservoir):
    """:class:`harness.prefill_closed.Reservoir` that also keeps each kept
    step's expert ids (``routes``, by step index) from ``now``, the list
    of the step just served."""

    def __init__(self, k: int, seed: int, now: list):
        super().__init__(k, seed)
        self.now = now
        self.routes: dict[int, list] = {}

    def offer(self, index, *args) -> None:
        super().offer(index, *args)
        kept = {s.index for s in self.samples()}
        self.routes = {i: r for i, r in self.routes.items() if i in kept}
        if index in kept:
            self.routes[index] = list(self.now)


class Run(prefill_closed.Run):
    """:class:`harness.prefill_closed.Run` on the configuration's
    ``arch_config``, its routing recorded, judged by
    :mod:`reference.layer_types` on the program's expert choices."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.nn import moe

        flat = dataclasses.replace(cell, config=program_config(cell.config))
        self.routes: list = []
        self._moe, self._route = moe, moe.route

        def route(*args, **kwargs):
            # the ids compact: the program's may be a view of all E ranks
            out = self._route(*args, **kwargs)
            self.routes.append(out[1].contiguous())
            return out
        moe.route = route
        try:
            super().__init__(flat, seed, device)
        except BaseException:
            self.free()
            raise
        self.reservoir = Reservoir(self.reservoir.k, seed, self.routes)

    def _serve(self, toks):
        self.routes.clear()
        return super()._serve(toks)

    def free(self) -> None:
        """Drop the program's objects and put its router back."""
        self._moe.route = self._route
        super().free()

    def _reference(self, samples, quant=None, picks=None):
        return ref_layer_types.forward(self.weights, self.cell.config,
                                       [(s.tokens, s.row) for s in samples],
                                       quant, picks)

    def check(self, quant=None) -> dict:
        """The check's numbers of the steps the window sampled, the
        program freed first: of the program's outputs, or with ``quant``
        of the reference computed in that precision put in the program's
        place (the control), each against the float32 reference on the
        same expert choices, and ``route_gap`` and ``route_gap_mean`` of
        those choices."""
        self.free()
        samples = self.reservoir.samples()
        if quant is None:
            routes = [self.reservoir.routes.get(s.index, []) for s in samples]
            served = [s.served for s in samples]
            logits = [s.logits for s in samples]
            caches = [s.cache for s in samples]
        else:
            taken = [Taken() for _ in samples]
            ctl = self._reference(samples, quant, taken)
            routes = [t.ids for t in taken]
            served = [lg.argmax(-1) for lg, _ in ctl]
            logits = [lg for lg, _ in ctl]
            caches = [cache for _, cache in ctl]
        fed = [Fed(r) for r in routes]
        want = self._reference(samples, None, fed)
        numbers = checks.prefill_numbers(served, logits, caches, want)
        gaps = torch.cat([g.float().cpu() for f in fed for g in f.gaps])
        left = sum(next(f.ids, None) is not None for f in fed)
        numbers["route_gap"] = math.nan if left else float(gaps.max())
        numbers["route_gap_mean"] = math.nan if left else float(gaps.mean())
        return numbers
