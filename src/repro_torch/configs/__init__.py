"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

A copy of ``repro/configs/__init__.py``; the arch files beside it are copies
of the reference's (pure data).

Arch ids are the assignment spellings (``--arch <id>``); module names are
their pythonized forms.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported API)
    ModelConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    cell_is_applicable,
    reduced,
    shape_for,
)

_ARCH_MODULES: Dict[str, str] = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "deepseek-7b": "deepseek_7b",
    "llama3.2-3b": "llama3_2_3b",
    "llama3-8b": "llama3_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-130m": "mamba2_130m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-base": "whisper_base",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
