"""Architecture registry of the port: the configs whose block kinds it runs.

The copies of ``repro.configs`` for hymba-1.5b (hybrid: attention and SSD
side by side), mamba2-130m (ssm) and llama3.2-3b (dense attention).  Any
other arch id of the reference registry raises a ``KeyError`` that says it
is not yet ported.
"""
from __future__ import annotations

import importlib

from repro_torch.nn.config import ArchConfig

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-130m": "mamba2_130m",
    "hymba-1.5b": "hymba_1_5b",
}
#: Arch ids of the reference registry that wait for their blocks' port.
NOT_YET_PORTED = ("tinyllama-1.1b", "starcoder2-3b", "qwen3-32b",
                  "deepseek-moe-16b", "qwen3-moe-30b-a3b", "qwen2-vl-72b",
                  "whisper-small")

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        if arch in NOT_YET_PORTED:
            raise KeyError(f"arch {arch!r} is not yet ported to repro_torch; "
                           f"ported: {list(_MODULES)}")
        raise KeyError(f"unknown arch {arch!r}; ported: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ArchConfig:
    return _mod(arch).smoke_config()


__all__ = ["ARCH_IDS", "NOT_YET_PORTED", "get_config", "get_smoke_config"]
