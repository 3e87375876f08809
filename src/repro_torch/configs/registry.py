"""Registry of the 10 assigned architectures (``--arch <id>``).

Exact configs from the assignment sheet; source tags in each module docstring.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = [
    "qwen1_5_110b",
    "smollm_360m",
    "olmo_1b",
    "command_r_35b",
    "mamba2_370m",
    "qwen2_moe_a2_7b",
    "granite_moe_3b_a800m",
    "paligemma_3b",
    "seamless_m4t_large_v2",
    "zamba2_2_7b",
]

_BY_NAME: Dict[str, ArchConfig] = {}


def _load() -> None:
    if _BY_NAME:
        return
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg: ArchConfig = mod.CONFIG
        _BY_NAME[cfg.name] = cfg


def get(name: str) -> ArchConfig:
    _load()
    if name.endswith("-tiny"):
        return get(name[: -len("-tiny")]).tiny()
    if name not in _BY_NAME:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_BY_NAME)}")
    return _BY_NAME[name]


def names() -> List[str]:
    _load()
    return sorted(_BY_NAME)
