"""The language model of the port: dense, MoE, SSM and hybrid decoders,
whisper's encoder-decoder and qwen2-vl's patch frontend, for prefill,
decode, the full-sequence forward and the training loss (counterpart of
``repro.nn``)."""
from .config import ArchConfig
from .model import (Model, abstract_cache, abstract_params, cache_shapes,
                    decode_step, forward_hidden, forward_logits, init_cache,
                    init_params, lm_loss, param_shapes, params_from_numpy,
                    params_to_numpy, prefill)

__all__ = [
    "ArchConfig", "Model", "param_shapes", "init_params",
    "params_from_numpy", "params_to_numpy", "forward_logits",
    "forward_hidden", "lm_loss", "decode_step", "prefill", "init_cache",
    "cache_shapes", "abstract_params", "abstract_cache",
]
