"""Assigned input shapes and per-cell applicability.

LM transformer shapes are seq_len x global_batch.  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``.  ``long_500k`` requires sub-quadratic attention: it runs for
ssm/hybrid families and is skipped (with a reason) for pure full-attention
architectures — see DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses

from repro_torch.nn.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 512k-token decode needs a "
                       "sub-quadratic mixer; runs only for ssm/hybrid "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


def all_cells(configs: dict[str, ArchConfig]) -> list[tuple[str, str, bool, str]]:
    """Every (arch, shape) pair with applicability flags, four an arch."""
    out = []
    for arch, cfg in configs.items():
        for sname, sp in SHAPES.items():
            ok, why = cell_applicable(cfg, sp)
            out.append((arch, sname, ok, why))
    return out
