"""Tensor-parallel collective traffic as point-to-point phases.

Every row-parallel matmul in the TP layout (:mod:`repro.parallel.sharding`:
attention ``wo``, MLP ``w2``, shared-expert ``shared_w2``, SSM ``out_proj`` —
weights sharded on their *contraction* dimension) produces partial sums that
must be all-reduced across the TP group once per layer.  Lowered as the
standard ring (reduce-scatter then all-gather), an all-reduce of ``bytes``
payload moves exactly ``2 * (M - 1) / M * bytes`` per rank for a TP degree
of ``M`` — the analytic volume the property tests pin — as ``M - 1``
neighbor messages of ``bytes / M`` per rank per phase.

This module derives those phases numpy-only: the row-parallel op count comes
from an :class:`~repro_torch.nn.config.ArchConfig` via the same divisibility
rules :func:`repro.parallel.sharding.param_pspecs` applies (the reference
cross-checks the count against the real pspec tree), and the ring schedule
is pure arithmetic.  Ranks of TP group ``g`` are the
contiguous block ``[g * tp, (g + 1) * tp)`` — the model-axis-innermost
layout of :class:`repro.parallel.sharding.MeshPlan` — so on a machine with
``ppn`` ranks per node the ring crosses a node boundary every ``ppn``
hops: regular per-edge sizes, irregular locality, which is precisely where
the node-aware model earns its keep.

Everything here is deterministic (no RNG): equal arguments always produce
bit-identical patterns.

Port note: a copy of ``repro.workloads.tp`` (host numpy);
:func:`row_parallel_ops_from_pspecs` reads the port's layout tree
(:func:`repro_torch.parallel.sharding.param_pspecs`).  The patterns use only
:func:`row_parallel_ops_per_layer`, as the reference's do.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.nn.config import ArchConfig
from repro_torch.sparse.partition import CommPattern

from .moe import ACT_BYTES


@dataclasses.dataclass(frozen=True)
class TpCollectives:
    """One layer's TP all-reduce traffic, lowered to ring phases.

    ``reduce_scatter`` and ``all_gather`` are the two ring phases (each rank
    sends ``n_ops * (tp - 1)`` chunk messages of ``payload_bytes / tp`` to
    its ring successor per phase); ``payload_bytes`` is one activation
    tensor's wire size per group, ``n_ops`` the row-parallel matmuls per
    layer the all-reduce repeats for, ``tp`` the group degree.
    """

    reduce_scatter: CommPattern
    all_gather: CommPattern
    payload_bytes: float
    n_ops: int
    tp: int

    @property
    def per_rank_bytes(self) -> float:
        """Analytic ring all-reduce volume per rank:
        ``n_ops * 2 * (tp - 1) / tp * payload_bytes``."""
        return self.n_ops * 2.0 * (self.tp - 1) / self.tp * self.payload_bytes

    def phases(self) -> list[tuple[str, CommPattern]]:
        """The two ring phases in schedule order, labelled."""
        return [("reduce_scatter", self.reduce_scatter),
                ("all_gather", self.all_gather)]


def row_parallel_ops_per_layer(cfg: ArchConfig, tp: int) -> int:
    """Row-parallel matmuls per repeating layer of ``cfg`` at TP degree ``tp``.

    Mirrors the contraction-dimension sharding rules of
    :func:`repro.parallel.sharding.param_pspecs` (each rule degrades to
    replication — no collective — when the dimension is not divisible by
    ``tp``): attention ``wo`` (``n_heads * head_dim``), MLP ``w2``
    (``d_ff``, dense layers only — routed-expert ``w2`` is expert-parallel
    and combines through the all-to-all instead), shared-expert
    ``shared_w2`` (``n_shared_experts * moe_d_ff``), SSM ``out_proj``
    (``ssm_d_inner``).  The count covers the *scanned* (repeating) layer;
    deepseek-style leading dense layers are not included.
    """
    ops = 0
    if cfg.has_attention and cfg.block_kind != "ssm":
        if (cfg.n_heads * cfg.head_dim) % tp == 0:
            ops += 1
    if cfg.has_ssm:
        if cfg.ssm_d_inner % tp == 0:
            ops += 1
    if cfg.is_moe:
        sf = cfg.n_shared_experts * cfg.moe_d_ff
        if sf and sf % tp == 0:
            ops += 1
    elif cfg.d_ff and cfg.d_ff % tp == 0:
        ops += 1
    return ops


def row_parallel_ops_from_pspecs(cfg: ArchConfig, plan=None) -> int:
    """The same per-layer op count read off the *actual* layout tree.

    Builds :func:`repro_torch.parallel.sharding.param_pspecs` for ``cfg``
    (on ``plan``, or a single-axis plan of one model rank when ``plan`` is
    None, as the reference's one host device gives it) and counts the
    leaves of the ``layers`` stack whose layout places the model axis on
    the contraction (second-to-last) dimension — the row-parallel
    signature.  The numpy-only twin :func:`row_parallel_ops_per_layer` is
    the derivation the patterns use; tests hold the two equal.
    """
    from repro_torch.nn.model import param_shapes
    from repro_torch.parallel.sharding import (MODEL_AXIS, make_mesh_plan,
                                               param_pspecs)

    if plan is None:
        plan = make_mesh_plan({"data": 1, "model": 1})
    specs = param_pspecs(cfg, plan)["layers"]
    shapes = param_shapes(cfg)["layers"]
    ops = 0
    for group, leaves in specs.items():
        for name, spec in leaves.items():
            sh = shapes[group][name]
            parts = tuple(spec) + (None,) * (len(sh) - len(spec))
            if len(sh) >= 2 and parts[len(sh) - 2] == MODEL_AXIS:
                ops += 1
    return ops


def tp_collective_patterns(cfg: ArchConfig, tp: int, tokens: int,
                           n_groups: int = 1,
                           act_bytes: int = ACT_BYTES) -> TpCollectives:
    """One layer's TP all-reduces for ``cfg``, lowered to ring phases.

    The all-reduced payload is one activation tensor of ``tokens`` rows —
    ``tokens * cfg.d_model * act_bytes`` bytes per group — repeated for the
    layer's ``row_parallel_ops_per_layer(cfg, tp)`` row-parallel matmuls.
    Each of the ``n_groups`` TP groups (contiguous rank blocks of ``tp``)
    runs its ring concurrently: per phase, rank ``i`` of a group sends
    ``n_ops * (tp - 1)`` chunk messages of ``payload / tp`` bytes to rank
    ``(i + 1) % tp`` of the same group.  Raises if ``cfg`` has no
    row-parallel op at this ``tp`` (nothing to derive).
    """
    n_ops = row_parallel_ops_per_layer(cfg, tp)
    if n_ops == 0:
        raise ValueError(
            f"{cfg.name!r} has no row-parallel matmul at tp={tp} (every "
            "sharded dimension indivisible): no TP collective to derive")
    if tp < 2:
        raise ValueError(f"a TP collective needs tp >= 2, got {tp}")
    payload = float(tokens) * cfg.d_model * act_bytes
    chunk = payload / tp
    # every group's ring edges, each repeated for (tp-1) chunks x n_ops
    base = np.repeat(np.arange(n_groups, dtype=np.int64) * tp, tp)
    i = np.tile(np.arange(tp, dtype=np.int64), n_groups)
    edge_src = base + i
    edge_dst = base + (i + 1) % tp
    reps = n_ops * (tp - 1)
    src = np.repeat(edge_src, reps)
    dst = np.repeat(edge_dst, reps)
    size = np.full(src.size, chunk)
    n_procs = n_groups * tp

    def ring() -> CommPattern:
        return CommPattern(src=src.copy(), dst=dst.copy(), size=size.copy(),
                           n_procs=n_procs).validate(
                               where="tp_collective_patterns")

    return TpCollectives(reduce_scatter=ring(), all_gather=ring(),
                         payload_bytes=payload, n_ops=n_ops, tp=tp)
