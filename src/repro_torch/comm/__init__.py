"""CommPhase, the PhaseStack arena, delta re-pricing, shared primitives,
strategy rewrites, typed validation, fault injection and the health ledger.

Re-exports the names of ``repro.comm``'s ``__all__`` that the port defines
in the same submodules, and one of its own: :class:`BackendUnavailable`
(:mod:`repro_torch.comm.health`), what the strategy service answers with
while a device's circuit breaker is open.  ``STACK_BACKENDS`` has no
counterpart: the port has one backend, the device the caller names.
"""
from .guard import (PatternError, MessageSizeError, RankError,
                    ArenaOverflowError, validate_messages, validate_phase)
from .faults import (FaultSpec, InjectedFault, InjectedTimeout, inject,
                     SITES as FAULT_SITES, MODES as FAULT_MODES)
from .health import (BackendHealth, BackendUnavailable, CircuitBreaker,
                     HealthEvent, get_health, reset_health)
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
                         injected_payload, delivered_payload,
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
    "rewrite", "injected_payload", "delivered_payload", "best_strategy",
    "best_strategy_many",
    "PatternError", "MessageSizeError", "RankError", "ArenaOverflowError",
    "validate_messages", "validate_phase",
    "FaultSpec", "InjectedFault", "InjectedTimeout", "inject",
    "FAULT_SITES", "FAULT_MODES",
    "BackendHealth", "CircuitBreaker", "HealthEvent", "get_health",
    "reset_health", "BackendUnavailable",
]
