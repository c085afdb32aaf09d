"""CommPhase, the PhaseStack arena, delta re-pricing, shared primitives and
strategy rewrites.

Re-exports the names of ``repro.comm``'s ``__all__`` that the port defines
in the same submodules.  The rest waits for its ROADMAP item: payload
accounting (3), fault injection and the health ledger (8).
"""
from .guard import (PatternError, MessageSizeError, RankError,
                    ArenaOverflowError, validate_messages, validate_phase)
from .phase import CommPhase
from .primitives import (active_senders_per_node, transport_times,
                         per_proc_sums, group_by_receiver, sum_by_pairs, segmented_arange,
                         grouped_queue_steps, queue_traversal_steps,
                         batched_queue_traversal_steps)
from .stack import PhaseStack, StackSimArrays
from .delta import (ARENA_TYPES, DeltaStack, message_delta,
                    pattern_fingerprint, phase_fingerprint)
from .strategies import (STRATEGIES, GPU_STRATEGIES, StrategyPlan,
                         StrategyVerdict, strategies_for, standard, two_step,
                         three_step, host_staged, device_direct, rewrite,
                         best_strategy, best_strategy_many)

__all__ = [
    "CommPhase", "PhaseStack", "StackSimArrays",
    "DeltaStack", "ARENA_TYPES",
    "message_delta", "pattern_fingerprint", "phase_fingerprint",
    "active_senders_per_node", "transport_times", "per_proc_sums",
    "group_by_receiver", "sum_by_pairs", "segmented_arange",
    "grouped_queue_steps",
    "queue_traversal_steps", "batched_queue_traversal_steps",
    "STRATEGIES", "GPU_STRATEGIES", "StrategyPlan", "StrategyVerdict",
    "strategies_for",
    "standard", "two_step", "three_step", "host_staged", "device_direct",
    "rewrite", "best_strategy", "best_strategy_many",
    "PatternError", "MessageSizeError", "RankError", "ArenaOverflowError",
    "validate_messages", "validate_phase",
]
