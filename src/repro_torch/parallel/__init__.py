"""Distribution runtime of the port (counterpart of ``repro.parallel``):
sharding rules as DTensor placements, the ambient layout context,
model-driven layout autotuning, and the programs written against
``torch.distributed`` that run on every rank of a group — the int8
compressed all-reduce (``compression``), the GPipe pipeline
(``pipeline``) and the expert-parallel all-to-all (``ep_a2a``), over the
collectives of ``collectives``."""
from .compression import compressed_psum, dp_grads_compressed, quantize_int8
from .ep_a2a import moe_ffn_ep
from .pipeline import gpipe, stack_stages
from .sharding import (MeshPlan, make_mesh_plan, param_pspecs, batch_pspecs,
                       cache_pspecs, shardings)

__all__ = ["MeshPlan", "make_mesh_plan", "param_pspecs", "batch_pspecs",
           "cache_pspecs", "shardings", "quantize_int8", "compressed_psum",
           "dp_grads_compressed", "stack_stages", "gpipe", "moe_ffn_ep"]
