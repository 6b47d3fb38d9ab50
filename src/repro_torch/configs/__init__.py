"""Configurations of the port.

Counterpart of ``repro.configs``: the ten assigned architectures
(public-literature configs), each an :class:`ArchConfig` with its full-size
``model`` and its ``smoke`` config, resolved by id through ``get_arch``;
the LM input shapes (``shapes``); and ``paper_nets``, the paper's four
networks (§4), each with its ladder, full and reduced configs and input
shapes.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from .base import ArchConfig
from .shapes import SHAPE_ORDER, SHAPES, ShapeSpec, applicable, input_specs

_MODULES = {
    "llama4-maverick-400b-a17b": ".llama4_maverick_400b_a17b",
    "deepseek-v2-lite-16b": ".deepseek_v2_lite_16b",
    "whisper-tiny": ".whisper_tiny",
    "codeqwen1.5-7b": ".codeqwen15_7b",
    "minicpm-2b": ".minicpm_2b",
    "minitron-4b": ".minitron_4b",
    "llama3-405b": ".llama3_405b",
    "recurrentgemma-2b": ".recurrentgemma_2b",
    "internvl2-1b": ".internvl2_1b",
    "rwkv6-7b": ".rwkv6_7b",
}

ARCH_IDS: List[str] = list(_MODULES)

_cache: Dict[str, ArchConfig] = {}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    if arch_id not in _cache:
        _cache[arch_id] = import_module(_MODULES[arch_id], __package__).get()
    return _cache[arch_id]


def all_archs() -> List[ArchConfig]:
    return [get_arch(a) for a in ARCH_IDS]


__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "SHAPE_ORDER", "ShapeSpec",
           "all_archs", "applicable", "get_arch", "input_specs"]
