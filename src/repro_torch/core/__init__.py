"""Parameter tables, torus topology and the model ladder (stack path).

Re-exports the names of ``repro.core``'s ``__all__`` that the port defines
in the same submodules; the per-phase ladder and fitting wait for ROADMAP
item 9, HLO extraction and collective decomposition for item 7.
"""
from .params import (CommParams, blue_waters, tpu_v5e, lassen, frontier,
                     HETERO_LOCALITIES, SHORT, EAGER, REND, PROTOCOL_NAMES)
from .models import (CostBreakdown, queue_time, MODEL_LEVELS, phase_cost_many,
                     model_ladder_many)
from .topology import TorusTopology, average_hops, contention_ell, cube_side

__all__ = [
    "CommParams", "blue_waters", "tpu_v5e", "lassen", "frontier",
    "HETERO_LOCALITIES", "SHORT", "EAGER", "REND", "PROTOCOL_NAMES",
    "CostBreakdown", "queue_time", "MODEL_LEVELS",
    "phase_cost_many", "model_ladder_many",
    "TorusTopology", "average_hops", "contention_ell", "cube_side",
]
