"""Parameter tables, torus topology, the model ladder, the parameter fits,
HLO collective extraction and collective decomposition and pricing.

Re-exports every name of ``repro.core``'s ``__all__`` from the same
submodules.
"""
from .params import (CommParams, blue_waters, tpu_v5e, lassen, frontier,
                     HETERO_LOCALITIES, SHORT, EAGER, REND, PROTOCOL_NAMES)
from .models import (CostBreakdown, message_time, queue_time, contention_time,
                     phase_cost, model_ladder, MODEL_LEVELS,
                     phase_cost_phase, phase_cost_many, model_ladder_many,
                     sequence_cost)
from .topology import TorusTopology, average_hops, contention_ell, cube_side
from .fitting import (fit_alpha_beta, fit_node_aware_table, fit_RN, fit_gamma,
                      fit_delta, fit_rails)
from .hlo import CollectiveOp, parse_collectives, collective_summary, shape_bytes
from .decompose import (PodGeometry, MessageSet, decompose_collective,
                        price_collective, price_step, StepCommModel,
                        CollectiveCost)

__all__ = [
    "CommParams", "blue_waters", "tpu_v5e", "lassen", "frontier",
    "HETERO_LOCALITIES", "SHORT", "EAGER", "REND", "PROTOCOL_NAMES",
    "CostBreakdown", "message_time", "queue_time", "contention_time",
    "phase_cost", "model_ladder", "MODEL_LEVELS",
    "phase_cost_phase", "phase_cost_many", "model_ladder_many",
    "sequence_cost",
    "TorusTopology", "average_hops", "contention_ell", "cube_side",
    "fit_alpha_beta", "fit_node_aware_table", "fit_RN", "fit_gamma",
    "fit_delta", "fit_rails",
    "CollectiveOp", "parse_collectives", "collective_summary", "shape_bytes",
    "PodGeometry", "MessageSet", "decompose_collective", "price_collective",
    "price_step", "StepCommModel", "CollectiveCost",
]
