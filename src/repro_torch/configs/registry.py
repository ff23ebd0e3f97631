"""Architecture registry of the port: ``get_config("<arch-id>")`` and the
list of the archs it runs.

The dense-GQA archs of the reference's registry (``qwen3-0.6b``,
``gemma2-9b``, ``starcoder2-3b``).  The reference's other seven (MoE,
MLA, SSM, RG-LRU hybrid, enc-dec, VLM) join as their model families are
ported; until then an arch id not listed here raises ``KeyError``, as an
unknown one does in the reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-0.6b":    "repro_torch.configs.qwen3_0_6b",
    "gemma2-9b":     "repro_torch.configs.gemma2_9b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
}

ARCH_IDS: List[str] = list(_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _cache:
        if arch_id not in _MODULES:
            raise KeyError(
                f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
        _cache[arch_id] = importlib.import_module(_MODULES[arch_id]).CONFIG
    return _cache[arch_id]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
