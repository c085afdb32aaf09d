"""Architecture registry of the port: the 10 assigned configs.

Copies of ``repro.configs``.  Every id builds its ``ArchConfig``, and
every one runs on the port's model (``repro_torch.nn``); the workload
registry needs only the configs.
"""
from __future__ import annotations

import importlib

from repro_torch.nn.config import ArchConfig

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-small": "whisper_small",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ArchConfig:
    return _mod(arch).smoke_config()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


from .shapes import SHAPES, ShapeSpec, cell_applicable, all_cells  # noqa: E402

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "all_configs",
           "SHAPES", "ShapeSpec", "cell_applicable", "all_cells"]
