"""Real LLM traffic shapes, derived from the in-repo model stack, priced
by the comm model (counterpart of ``repro.workloads``).

The LLM half of the repo *generates* irregular point-to-point
communication (MoE expert all-to-all, TP ring collectives, pipeline stage
boundaries); the :mod:`repro_torch.comm` / :mod:`repro_torch.core` half
*prices* it.  This package connects them: numpy-only derivations of
:class:`repro_torch.sparse.partition.CommPattern` from the real schedules
(capacity formulas, sharding rules and microbatch counts as the reference
takes them), plus a scenario registry that sweeps every derived shape
through one :func:`repro_torch.comm.strategies.best_strategy_many` call.

Port note: every name of the reference's ``__all__``;
``row_parallel_ops_from_pspecs`` reads the port's layout tree
(:mod:`repro_torch.parallel.sharding`).
"""
from .moe import (ACT_BYTES, MoeA2APattern, a2a_capacity, moe_a2a_pattern,
                  pattern_from_counts, router_routing_counts,
                  synthetic_routing_counts)
from .pipe import pipeline_p2p_pattern
from .registry import (DEFAULT_SCENARIOS, Scenario, SweepRow,
                       default_machines, scenario_patterns, sweep,
                       winner_table)
from .tp import (TpCollectives, row_parallel_ops_from_pspecs,
                 row_parallel_ops_per_layer, tp_collective_patterns)

__all__ = [
    "ACT_BYTES", "MoeA2APattern", "a2a_capacity", "moe_a2a_pattern",
    "pattern_from_counts", "router_routing_counts", "synthetic_routing_counts",
    "pipeline_p2p_pattern",
    "TpCollectives", "row_parallel_ops_from_pspecs",
    "row_parallel_ops_per_layer", "tp_collective_patterns",
    "DEFAULT_SCENARIOS", "Scenario", "SweepRow", "default_machines",
    "scenario_patterns", "sweep", "winner_table",
]
