"""Model-driven layout autotuning — the paper's model as a decision procedure
(counterpart of ``repro.parallel.autotune``).

For a given (arch x shape), enumerate candidate layouts (mesh factorization,
sequence sharding, attention chunk, FSDP), trace each
(:func:`repro_torch.launch.dryrun.trace_cell`), decompose the traced
collectives to p2p messages, and rank by the node-aware max-rate + queue +
contention step time (plus the compute/memory roofline terms so
communication wins don't get chosen when they blow the other budgets).

This mirrors the paper's conclusions loop: the model tells you WHETHER a
schedule is message-count-bound (queue), link-share-bound (contention) or
bandwidth-bound, and the tuner picks the layout that moves the dominant
term.  The rates are the reference's TPU v5e figures by default: the pod
the collectives are priced on.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.params import (V5E_HBM_BW, V5E_HBM_PER_CHIP,
                                     V5E_PEAK_FLOPS_BF16)


@dataclasses.dataclass(frozen=True)
class LayoutCandidate:
    name: str
    mesh_shape: tuple[int, ...]       # (data, model) or (pod, data, model)
    seq_shard: bool = True
    q_chunk: int = 1024
    fsdp: bool | None = None          # None = dryrun default rule


@dataclasses.dataclass
class LayoutScore:
    candidate: LayoutCandidate
    compute_s: float
    memory_s: float
    comm_naive_s: float
    comm_model_s: float
    queue_s: float
    contention_s: float
    peak_gib: float
    fits: bool

    @property
    def step_model_s(self) -> float:
        """Modeled step time: max(compute, memory) + modeled communication."""
        return max(self.compute_s, self.memory_s) + self.comm_model_s


def score_traced(art: dict, flops_per_device: float | None = None,
                 bytes_per_device: float | None = None,
                 peak_flops: float = V5E_PEAK_FLOPS_BF16,
                 hbm_bw: float = V5E_HBM_BW,
                 hbm_bytes: float = V5E_HBM_PER_CHIP) -> dict:
    """Roofline + Bienz terms from a traced cell (``trace_cell``'s
    artifact): the counterpart of the reference's ``score_compiled``."""
    flops = flops_per_device if flops_per_device is not None \
        else art["cost"]["flops_per_device"]
    byts = bytes_per_device if bytes_per_device is not None \
        else art["cost"]["bytes_per_device"]
    comm = art["comm_model"]
    peak = art["memory"]["peak_bytes"]
    return {
        "compute_s": flops / peak_flops,
        "memory_s": byts / hbm_bw,
        "comm_naive_s": comm["naive_time"],
        "comm_model_s": comm["model_time"],
        "queue_s": comm["queue"],
        "contention_s": comm["contention"],
        "peak_gib": peak / 2**30,
        "fits": peak < 15.5 / 16 * hbm_bytes,
    }


def rank(scores: list[LayoutScore]) -> list[LayoutScore]:
    """Feasible layouts first, by modeled step time."""
    return sorted(scores, key=lambda s: (not s.fits, s.step_model_s))
