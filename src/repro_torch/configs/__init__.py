"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

One module per assigned architecture with the exact published configuration,
plus ``reduced()`` variants for CPU smoke tests.  The port of
``repro.configs``: the same dataclasses, field for field.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_IDS: List[str] = [
    "gemma3_12b",
    "phi3_mini_3p8b",
    "qwen3_32b",
    "qwen2p5_32b",
    "recurrentgemma_2b",
    "arctic_480b",
    "deepseek_v2_236b",
    "seamless_m4t_medium",
    "llama3p2_vision_11b",
    "xlstm_125m",
]

_ALIASES: Dict[str, str] = {
    "gemma3-12b": "gemma3_12b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen3-32b": "qwen3_32b",
    "qwen2.5-32b": "qwen2p5_32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "arctic-480b": "arctic_480b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-11b": "llama3p2_vision_11b",
    "xlstm-125m": "xlstm_125m",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.config()


def get_reduced_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.reduced()
