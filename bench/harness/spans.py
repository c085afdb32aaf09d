"""Spans around the program's layers, put in from the benchmark's side.

In a traced run each layer's entry is replaced, where the program calls it,
by a wrapper that opens a ``torch.profiler.record_function`` span named
``bench.<layer>`` around the call and notes the call's shapes; the wrapper
is taken out again afterwards.  A span's device time is what the profiler
attributes to it: the kernels launched while it was open on the host, the
hand-written ones included.  The program itself carries no spans.

Each target is (module, attribute, span, shapes), ``shapes`` a function of
the call's arguments giving what the counts need.
"""
from __future__ import annotations

import contextlib
import functools
import importlib

import torch


def _attn_shape(q, k, v, causal=True):
    B, S, H, D = q.shape
    return (B, S, H, k.shape[2], D, bool(causal))


def _ssd_shape(dtx, Bm, Cm, cumA):
    if dtx.dim() == 4:
        G1, h, q, p = dtx.shape
    else:
        (G1, q, p), h = dtx.shape, 1
    return (G1, h, q, Bm.shape[-1], p)


def _attn_bwd_shape(q, k, v, out, dout, causal=True):
    return _attn_shape(q, k, v, causal)


def _none(*a, **kw):
    return ()


#: The spans a traced run puts in: the program's call sites of each layer.
TARGETS = (
    ("repro_torch.nn.model", "block_forward", "bench.layer", _none),
    ("repro_torch.nn.blocks", "attention", "bench.attention", _none),
    ("repro_torch.kernels.ops", "mha_flash", "bench.attn_core", _attn_shape),
    ("repro_torch.nn.blocks", "ssm_mixer", "bench.ssm", _none),
    ("repro_torch.kernels.ops", "ssd_intra_chunk", "bench.ssd_intra",
     _ssd_shape),
    ("repro_torch.nn.blocks", "mlp", "bench.mlp", _none),
    ("repro_torch.nn.blocks", "moe_ffn", "bench.moe", _none),
    ("repro_torch.nn.model", "_cache_of", "bench.cache", _none),
    ("repro_torch.nn.model", "_unembed", "bench.unembed", _none),
    ("repro_torch.nn.model", "lm_loss", "bench.forward", _none),
    ("repro_torch.launch.steps", "grads_of", "bench.loss_and_grads", _none),
    ("repro_torch.launch.steps", "adamw_update", "bench.optimizer", _none),
    ("repro_torch.kernels.flash_attention", "flash_attention_backward",
     "bench.attn_bwd", _attn_bwd_shape),
    ("repro_torch.kernels.ssd", "ssd_intra_chunk_backward", "bench.ssd_bwd",
     _none),
)


class Calls:
    """The shapes of each span's calls while it is recording."""

    def __init__(self):
        self.shapes: dict[str, list] = {}
        self.on = False

    def note(self, span: str, shape) -> None:
        if self.on:
            self.shapes.setdefault(span, []).append(shape)


def _wrap(fn, span: str, shapes, calls: Calls):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        calls.note(span, shapes(*args, **kwargs))
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def installed(calls: Calls, targets=TARGETS):
    """Every target wrapped for the duration, then put back."""
    saved = []
    try:
        for mod_name, attr, span, shapes in targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, span, shapes, calls))
        yield calls
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
