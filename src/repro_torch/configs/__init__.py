"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``get_config(name).smoke()`` the reduced same-family config used by CPU
smoke tests. ``ARCHS`` lists all assigned ids, which the JAX package
shares; ``PATTERN_ARCHS`` the architectures of the port alone, stacks of
layers of different kinds (``models.config.PatternConfig``), which
:func:`canonical` and :func:`get_config` resolve too.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCHS: List[str] = [
    "llama4_maverick_400b_a17b",
    "deepseek_moe_16b",
    "yi_34b",
    "qwen1_5_32b",
    "command_r_35b",
    "minitron_8b",
    "hymba_1_5b",
    "musicgen_large",
    "internvl2_76b",
    "mamba2_370m",
]

PATTERN_ARCHS: List[str] = [
    "granite_4_0_h_small",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS and name not in PATTERN_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{ARCHS + PATTERN_ARCHS}")
    return name


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
