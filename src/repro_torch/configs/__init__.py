"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).
Reference: ``src/repro/configs/__init__.py``.

Every arch of the reference, in its order; asking for any other raises a
``KeyError`` that names them. ``cell_is_skipped`` is the reference's rule
for the dry run's (arch x shape) grid.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    AggregationConfig, CheckpointConfig, ExecutionConfig, FaultConfig,
    MLAConfig, ModelConfig, MoEConfig, OptimizerConfig, ShapeConfig,
    SSMConfig, TrainConfig)

_ARCH_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "internvl2-2b": "internvl2_2b",
    "gemma3-1b": "gemma3_1b",
    "qwen3-0.6b": "qwen3_0_6b",
    "minitron-4b": "minitron_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-tiny": "whisper_tiny",
}

# archs whose long_500k cell is planned (the others are pure full
# attention: the reference skips that cell for them)
LONG_CONTEXT_ARCHS = ("gemma3-1b", "hymba-1.5b", "rwkv6-1.6b")


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cell_is_skipped(arch: str, shape_name: str) -> bool:
    return shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS
