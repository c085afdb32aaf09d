"""The numbers that decide ``correct``, each beside its limit.

A served prompt is judged by the reference's logits at its last position:

- ``token_gap``: the widest gap, over the sampled prompts, by which the
  reference's logit of the token the program served lies below the
  reference's best (0 where they pick the same token);
- ``logits_rel``: the widest relative L2 distance of a prompt's logits
  from the reference's;
- ``cache_rel``: the widest relative L2 distance of a sampled row's cache
  leaf (k, v over every layer and every position of the cache, zero past
  the prompt; the conv and SSD states) from the reference's;
- ``token_gap_mean`` and ``logits_rel_median``: the mean gap and the
  median distance over the prompts, steadier than the widest.

A cell's limits file names the numbers it compares: those whose control
reading lies three times its program's or more.

A training run is judged over its first steps (:func:`train_numbers`).
Any number that is not finite fails.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def worst(values) -> float:
    """The largest of ``values``; NaN where any is NaN."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return math.nan
    return max(values, default=0.0)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, ``got`` longer along dim 1 than ``want``
    where the cache holds positions past the prompt (counted whole)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        S = want.shape[1]
        tail = float(torch.linalg.vector_norm(got[:, S:]))
        got = got[:, :S]
    else:
        tail = 0.0
    diff = float(torch.linalg.vector_norm(got - want))
    ref = float(torch.linalg.vector_norm(want))
    return math.hypot(diff, tail) / max(ref, 1e-30)


def prefill_numbers(served, logits, caches, ref) -> dict[str, float]:
    """The three numbers of prefilled prompts: ``served`` the tokens served
    [B] per step, ``logits`` the logits [B, V], ``caches`` one row's cache
    leaves, ``ref`` the reference's (logits, cache) per step."""
    gap, rel, crel = [], [], []
    for tok, lg, cache, (rlg, rcache) in zip(served, logits, caches, ref):
        rlg = rlg.float()
        best = rlg.max(-1).values
        picked = rlg.gather(-1, tok.to(rlg.device).long()[:, None])[:, 0]
        gap += (best - picked).tolist()
        lg = lg.float()
        num = torch.linalg.vector_norm(lg - rlg, dim=-1)
        den = torch.linalg.vector_norm(rlg, dim=-1).clamp(min=1e-30)
        rel += (num / den).tolist()
        crel += [_rel(cache[key], want) for key, want in rcache.items()]
    return {"token_gap": worst(gap), "token_gap_mean": _mean(gap),
            "logits_rel": worst(rel), "logits_rel_median": _median(rel),
            "cache_rel": worst(crel)}


def _mean(values) -> float:
    return float(torch.tensor(values, dtype=torch.float64).mean())


def _median(values) -> float:
    return float(torch.tensor(values, dtype=torch.float64).median())


def against(numbers: dict[str, float], limits: dict) -> list[Check]:
    """Each number that the cell's limits name beside its limit (a number
    that is NaN stays NaN and fails); a cell compares only the numbers
    that separate its program from its control."""
    return [Check(k, numbers[k], float(v)) for k, v in limits.items()]


def leaf_gaps(got: dict, want: dict, keep=None) -> dict[str, float]:
    """For each leaf, ``| |got_leaf| - |want_leaf| |`` over the larger of
    ``|want_leaf|`` and the median leaf's ``|want|`` (norms given per
    leaf); ``keep`` the leaves counted (all when None)."""
    med = float(torch.tensor([want[n] for n in want]).median())
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in want if keep is None or n in keep}


def train_leaves(prog: dict, ref: dict, cut: float = 1e-3) -> dict:
    """A training run's numbers by leaf: ``grad`` the gap of the first
    clipped gradient's norm (:func:`leaf_gaps`), ``grad_rel`` the norm of
    its difference from the reference's gradient (``prog["grad_diff"]``,
    estimated from a sample of entries) over the larger of the
    reference's norm of that leaf and of the median leaf, ``change`` the
    gap of each leaf's change over the steps, leaving out leaves whose
    reference gradient is under ``cut`` times the median leaf's (they move
    by round-off alone)."""
    med = float(torch.tensor(list(ref["grad"].values())).median())
    moved = {n for n, g in ref["grad"].items() if g >= cut * med}
    return {"grad": leaf_gaps(prog["grad"], ref["grad"]),
            "grad_rel": {n: d / max(ref["grad"][n], med, 1e-30)
                         for n, d in prog["grad_diff"].items()},
            "change": leaf_gaps(prog["change"], ref["change"], moved)}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of a training run's first steps: ``loss1_rel`` the
    relative gap of the first step's loss and ``loss_rel`` the widest of
    any step's; of :func:`train_leaves`, the worst leaf of each
    (``grad_gap``, ``grad_rel``, ``change_gap``) and the median leaf of
    the gradient's (``grad_median``, ``grad_rel_median``).  ``prog`` and
    ``ref`` hold ``loss`` (a list), ``grad`` and ``change`` (norms by leaf
    name), ``prog`` also ``grad_diff``."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    leaves = train_leaves(prog, ref)
    return {"loss1_rel": worst(gaps[:1]), "loss_rel": worst(gaps),
            "grad_gap": worst(leaves["grad"].values()),
            "grad_median": _median(list(leaves["grad"].values())),
            "grad_rel": worst(leaves["grad_rel"].values()),
            "grad_rel_median": _median(list(leaves["grad_rel"].values())),
            "change_gap": worst(leaves["change"].values())}
