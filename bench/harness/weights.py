"""The port's model built from a configuration file, with weights the
benchmark makes from the seed on the device.

The weights follow the port's initial recipe (ones for norm scales and
``D``, zeros for biases, ``log(linspace(1, 16))`` for ``A_log``, a normal
draw over the square root of the fan-in for every matrix) in the port's
parameter dtypes (bf16 matrices, float32 norms and SSM scalars), but are
drawn here: all leaves of one dtype lie in one flat buffer, filled by a few
large ``randn`` calls of one ``torch.Generator`` on the card and scaled a
run of equal fan-in at a time.  The port's model takes the buffer's views
with ``load_state_dict(assign=True)``, so there is one copy, which the
reference reads too.
"""
from __future__ import annotations

import dataclasses
import math

import torch

#: Elements a ``randn`` call fills (a few calls per buffer).
CHUNK = 1 << 30
#: Each leaf starts at a multiple of this many elements (128 bytes in bf16).
ALIGN = 64

ONES = ("scale", "norm", "q_norm", "k_norm", "D")
ZEROS = ("bias", "conv_b", "dt_bias")


def arch_config(config: dict):
    """The port's ``ArchConfig`` from a configuration file's object: its
    ``arch`` as the name, and every key that names one of its fields."""
    from repro_torch.nn.config import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)} - {"name"}
    return ArchConfig(name=config["arch"],
                      **{k: v for k, v in config.items() if k in names})


def leaf_specs(cfg) -> list[tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of every parameter of the port's model for
    ``cfg``, by name, from its shapes alone (``meta`` tensors)."""
    from repro_torch.nn.model import abstract_params

    return sorted((n, tuple(p.shape), p.dtype)
                  for n, p in abstract_params(cfg).named_parameters())


def _kind(name: str) -> str:
    last = name.rsplit(".", 1)[-1]
    if last in ONES:
        return "ones"
    if last in ZEROS:
        return "zeros"
    if last == "A_log":
        return "a_log"
    return "normal"


def _fan_in(shape: tuple) -> int:
    return shape[-2] if len(shape) >= 2 else shape[-1]


#: The last projection of each residual branch (attention, SSM mixer, MLP,
#: experts), which a scaled initialisation draws narrower.
RESIDUAL_OUT = ("attn.wo", "ssm.out_proj", "mlp.w2", "moe.w2",
                "moe.shared_w2")


def _std(name: str, shape: tuple, residual_scale: float) -> float:
    std = 1.0 / math.sqrt(_fan_in(shape))
    return std * residual_scale if name.endswith(RESIDUAL_OUT) else std


def make_weights(specs, seed: int, device,
                 residual_scale: float = 1.0) -> dict[str, torch.Tensor]:
    """The weights of ``specs`` ((name, shape, dtype) triples) drawn from
    ``seed`` on ``device``: name -> a view into one flat buffer a dtype.
    ``residual_scale`` multiplies the spread of each residual branch's
    last projection (:data:`RESIDUAL_OUT`).  The same seed gives the same
    tensors."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: dict[str, torch.Tensor] = {}
    for dtype in sorted({s[2] for s in specs}, key=str):
        def std(s):
            return _std(s[0], s[1], residual_scale)

        leaves = sorted((s for s in specs if s[2] == dtype),
                        key=lambda s: (_kind(s[0]), std(s), s[0]))
        offsets, off = [], 0
        for _, shape, _ in leaves:
            offsets.append(off)
            off += -(-math.prod(shape) // ALIGN) * ALIGN
        flat = torch.empty(off, dtype=dtype, device=device)
        runs: list[list] = []       # [kind, std, start, end]
        for (name, shape, dt), start in zip(leaves, offsets):
            key = (_kind(name), std((name, shape, dt)))
            end = start + math.prod(shape)
            if runs and tuple(runs[-1][:2]) == key:
                runs[-1][3] = end
            else:
                runs.append([*key, start, end])
            out[name] = flat[start:end].view(shape)
        for kind, sd, start, end in runs:
            seg = flat[start:end]
            if kind == "normal":
                for a in range(start, end, CHUNK):
                    b = min(end, a + CHUNK)
                    flat[a:b].normal_(0.0, 1.0, generator=gen)
                seg.mul_(sd)
            elif kind == "ones":
                seg.fill_(1.0)
            elif kind == "zeros":
                seg.zero_()
        for name, shape, _ in leaves:
            if _kind(name) == "a_log":
                row = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                               device=device))
                out[name].copy_(row.expand(shape))
    return out


def build_model(cfg, weights: dict[str, torch.Tensor]):
    """The port's ``Model`` for ``cfg`` holding ``weights`` themselves (no
    copy)."""
    from repro_torch.nn.model import abstract_params

    model = abstract_params(cfg)
    model.load_state_dict(weights, strict=True, assign=True)
    return model
