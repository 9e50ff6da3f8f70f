"""--arch registry: maps architecture ids to their configs."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS: dict[str, str] = {
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return importlib.import_module(ARCHS[name]).config()


def get_smoke_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return importlib.import_module(ARCHS[name]).smoke_config()
