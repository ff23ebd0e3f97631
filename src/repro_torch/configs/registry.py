"""Architecture registry of the port: ``get_config("<arch-id>")`` and the
list of the archs it runs.

The reference's ten LM archs, in the reference's order: dense GQA
(``qwen3-0.6b``, ``gemma2-9b``, ``starcoder2-3b``), the VLM
(``phi-3-vision-4.2b``), the RG-LRU hybrid (``recurrentgemma-2b``), the
enc-dec ``seamless-m4t-large-v2``, MLA over MoE (``deepseek-v2-236b``,
``deepseek-v2-lite-16b``), dense MLA (``minicpm3-4b``) and the SSM
``mamba2-780m``.  An unknown id raises ``KeyError``, as in the
reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen3-0.6b":            "repro_torch.configs.qwen3_0_6b",
    "phi-3-vision-4.2b":     "repro_torch.configs.phi_3_vision_4_2b",
    "gemma2-9b":             "repro_torch.configs.gemma2_9b",
    "recurrentgemma-2b":     "repro_torch.configs.recurrentgemma_2b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "starcoder2-3b":         "repro_torch.configs.starcoder2_3b",
    "deepseek-v2-236b":      "repro_torch.configs.deepseek_v2_236b",
    "minicpm3-4b":           "repro_torch.configs.minicpm3_4b",
    "mamba2-780m":           "repro_torch.configs.mamba2_780m",
    "deepseek-v2-lite-16b":  "repro_torch.configs.deepseek_v2_lite_16b",
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
