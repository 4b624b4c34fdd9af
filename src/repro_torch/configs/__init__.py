"""Assigned architecture configs (exact published shapes) + registry.

Every architecture is selected by its id (or an alias) in :func:`get_config`.
``full()`` returns the exact published config; ``smoke()`` returns a
reduced same-family config for CPU tests. The port's own copy of the JAX
package's config registry; :mod:`~repro_torch.configs.paper_catalog` holds
the paper's own experimental setups.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "yi_34b",
    "smollm_360m",
    "gemma2_27b",
    "command_r_35b",
    "hubert_xlarge",
    "zamba2_2p7b",
    "internvl2_1b",
    "qwen3_moe_235b",
    "mixtral_8x7b",
    "mamba2_2p7b",
]

#: dashes-to-underscores aliases matching the assignment sheet names
ALIASES: Dict[str, str] = {
    "yi-34b": "yi_34b",
    "smollm-360m": "smollm_360m",
    "gemma2-27b": "gemma2_27b",
    "command-r-35b": "command_r_35b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2p7b",
    "internvl2-1b": "internvl2_1b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-2.7b": "mamba2_2p7b",
}


def _module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, *, tp_shards: int = 1, **overrides) -> ModelConfig:
    cfg = _module(arch).full()
    return cfg.with_(tp_shards=tp_shards, **overrides)


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).smoke()
    return cfg.with_(**overrides) if overrides else cfg


def all_configs(tp_shards: int = 1) -> Dict[str, ModelConfig]:
    return {a: get_config(a, tp_shards=tp_shards) for a in ARCH_IDS}
