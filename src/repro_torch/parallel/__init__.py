"""Distribution runtime of the port (counterpart of ``repro.parallel``):
sharding rules as DTensor placements, the ambient layout context and
model-driven layout autotuning.  Gradient compression, the pipeline and
the expert all-to-all (``compression``, ``pipeline``, ``ep_a2a``) are
ROADMAP queue item 15."""
from .sharding import (MeshPlan, make_mesh_plan, param_pspecs, batch_pspecs,
                       cache_pspecs, shardings)

__all__ = ["MeshPlan", "make_mesh_plan", "param_pspecs", "batch_pspecs",
           "cache_pspecs", "shardings"]
