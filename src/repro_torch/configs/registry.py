"""Architecture registry of the port: ``--arch <id>`` lookup."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models import ModelConfig

_MODULES: Dict[str, str] = {             # the reference's order
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
    "internvl2-76b": "internvl2_76b",
    "qwen3-14b": "qwen3_14b",
    "smollm-135m": "smollm_135m",
    "llama3-405b": "llama3_405b",
    "glm4-9b": "glm4_9b",
    "whisper-base": "whisper_base",
    "mamba2-1.3b": "mamba2_1p3b",
    "jamba-v0.1-52b": "jamba_v01_52b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
