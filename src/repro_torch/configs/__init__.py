"""Architecture registry of the port: the 10 assigned configs and the
port's own.

``ARCH_IDS`` are copies of ``repro.configs``; ``PORT_ONLY_IDS`` the
configs only the port runs (granite-4.0-h-small: a stack whose layers
differ in their mixer).  Every id builds its ``ArchConfig``, and every one
runs on the port's model (``repro_torch.nn``); the workload registry and
the dry run take ``ARCH_IDS``.
"""
from __future__ import annotations

import importlib

from repro_torch.nn.config import ArchConfig

#: The ids the JAX package has too, in its order.
ARCH_IDS = ("llama3.2-3b", "tinyllama-1.1b", "starcoder2-3b", "qwen3-32b",
            "deepseek-moe-16b", "qwen3-moe-30b-a3b", "mamba2-130m",
            "hymba-1.5b", "qwen2-vl-72b", "whisper-small")
#: The ids only the port has.
PORT_ONLY_IDS = ("granite-4.0-h-small",)
#: Every id of the port.
ALL_IDS = ARCH_IDS + PORT_ONLY_IDS


def _mod(arch: str):
    """The module of ``arch``: its id with ``.`` and ``-`` as ``_``."""
    if arch not in ALL_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ALL_IDS)}")
    name = arch.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ArchConfig:
    return _mod(arch).smoke_config()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ALL_IDS}


from .shapes import SHAPES, ShapeSpec, cell_applicable, all_cells  # noqa: E402

__all__ = ["ARCH_IDS", "PORT_ONLY_IDS", "ALL_IDS", "get_config",
           "get_smoke_config", "all_configs", "SHAPES", "ShapeSpec",
           "cell_applicable", "all_cells"]
