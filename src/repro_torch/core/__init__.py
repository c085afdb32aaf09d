"""Parameter tables, torus topology, the model ladder and the parameter
fits.

Re-exports the names of ``repro.core``'s ``__all__`` that the port defines
in the same submodules; HLO extraction and collective decomposition wait
for ROADMAP item 7.
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
]
