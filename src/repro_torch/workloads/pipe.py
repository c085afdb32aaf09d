"""Pipeline-parallel stage-boundary traffic as point-to-point messages.

The GPipe schedule in :func:`repro_torch.parallel.pipeline.gpipe` runs ``M``
microbatches through ``S`` stages in ``M + S - 1`` ticks; every tick each
stage ``ppermute``\\ s its activation ``[microbatch, d_model]`` to the next
stage.  The *useful* payload — what a real point-to-point lowering would
send — is one microbatch activation per interior boundary ``s -> s + 1``
per microbatch: ``(S - 1) * M`` messages of ``microbatch_tokens * d_model *
dtype_bytes`` bytes, the total the property tests pin.  The ring
wrap-around ``S - 1 -> 0`` carries garbage the schedule masks out (bubble
ticks), so it is excluded here, as are the bubble ticks themselves: they
exist in the SPMD lowering only because ``ppermute`` is collective.

Stages are pinned to ranks the way a pod-per-stage launch lays them out:
with ``n_procs`` total ranks, stage ``s`` talks from rank
``s * (n_procs // n_stages)`` — the first rank of its contiguous block —
so on multi-node machines stage boundaries are exactly the node (or
torus-hop) crossings whose cost the node-aware model separates.

Deterministic (no RNG): equal arguments always produce bit-identical
patterns.

Port note: a copy of ``repro.workloads.pipe`` (host numpy).
"""
from __future__ import annotations

from repro_torch.nn.config import ArchConfig
from repro_torch.sparse.partition import CommPattern

from .moe import ACT_BYTES

import numpy as np


def pipeline_p2p_pattern(cfg: ArchConfig, n_stages: int, n_microbatches: int,
                         microbatch_tokens: int, n_procs: int | None = None,
                         dtype_bytes: int = ACT_BYTES) -> CommPattern:
    """Stage-boundary activation traffic of one GPipe forward pass.

    ``cfg`` supplies ``d_model``; each of the ``n_microbatches`` microbatches
    of ``microbatch_tokens`` tokens crosses each of the ``n_stages - 1``
    interior stage boundaries once, as one message of ``microbatch_tokens *
    cfg.d_model * dtype_bytes`` bytes (the ``[mb, d_model]`` activation on
    the wire; the masked ring wrap-around is not counted).  ``n_procs``
    spreads the stages over that many ranks in contiguous equal blocks
    (stage ``s`` sends from rank ``s * n_procs // n_stages``; ``n_stages``
    must divide ``n_procs``); it defaults to one rank per stage.
    """
    if n_stages < 2:
        raise ValueError(f"a pipeline needs n_stages >= 2, got {n_stages}")
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, "
                         f"got {n_microbatches}")
    if n_procs is None:
        n_procs = n_stages
    if n_procs % n_stages:
        raise ValueError(f"n_stages ({n_stages}) must divide n_procs "
                         f"({n_procs}) for contiguous stage blocks")
    block = n_procs // n_stages
    stage_rank = np.arange(n_stages, dtype=np.int64) * block
    src = np.repeat(stage_rank[:-1], n_microbatches)
    dst = np.repeat(stage_rank[1:], n_microbatches)
    size = np.full(src.size,
                   float(microbatch_tokens) * cfg.d_model * dtype_bytes)
    # typed output validation: a bad config (negative token count, zero
    # d_model) surfaces as a precise PatternError here, not as garbage
    # pricing downstream
    return CommPattern(src=src, dst=dst, size=size,
                       n_procs=n_procs).validate(where="pipeline_p2p_pattern")
