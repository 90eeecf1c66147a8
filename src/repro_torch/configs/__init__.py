"""Architecture config registry: --arch <id> resolves here."""
from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "qwen3_1_7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "minicpm3-4b": "minicpm3_4b",
    "yi-6b": "yi_6b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-350m": "xlstm_350m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
