"""Registry mapping ``--arch <id>`` to its ModelConfig."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    # the paper's own model (not part of the assigned pool, used by the
    # calibration + misalignment benchmarks)
    "qwen2.5-32b": "repro_torch.configs.qwen25_32b",
}

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "qwen2.5-32b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def all_configs(include_paper_model: bool = False) -> Dict[str, ModelConfig]:
    names = list(_MODULES) if include_paper_model else ASSIGNED_ARCHS
    return {n: get_config(n) for n in names}
