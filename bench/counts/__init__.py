"""Operation and byte counts of the work the benchmark's models and ops
need, as functions of the cell's shapes, and the card's peak rates.

They count what the computation needs, not what a kernel happens to do:
each input byte read once and each output byte written once, each product
once.  A share of a roofline or of the peak over 100 % is then a fault in
a count or in a time, never a fast kernel.
"""
from .model import layer_matmul_params, prefill_flops, train_flops
from .ops import attention_bwd, attention_fwd, least_seconds, ssd_intra
from .peaks import PEAKS

__all__ = ["PEAKS", "attention_bwd", "attention_fwd", "least_seconds",
           "layer_matmul_params", "prefill_flops", "ssd_intra",
           "train_flops"]
