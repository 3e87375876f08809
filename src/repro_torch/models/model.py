"""Family dispatch facade: one object per architecture with a uniform API.

Port of ``src/repro/models/model.py``: ``build(cfg)`` takes the encdec
family to ``models.encdec`` and every other family to ``models.lm``.
``param_specs`` gives each parameter's logical axes (``sharding.
distribute`` places a leaf by them on a process-group mesh).
``init_params`` takes a ``torch.Generator`` and a device where the
reference takes a PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm

__all__ = ["Model", "build"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    param_plan: Callable[[], Any]
    init_params: Callable[[torch.Generator, Any], Any]
    param_specs: Callable[[], Any]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[..., Tuple[torch.Tensor, Any]]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]


def build(cfg: ArchConfig) -> Model:
    mod = encdec if cfg.family == "encdec" else lm
    return Model(
        cfg=cfg,
        param_plan=lambda: mod.param_plan(cfg),
        init_params=lambda generator, device: mod.init_params(cfg, generator, device),
        param_specs=lambda: mod.param_specs(cfg),
        loss_fn=lambda params, batch: mod.loss_fn(cfg, params, batch),
        prefill=lambda params, batch, **kw: mod.prefill(cfg, params, batch, **kw),
        decode_step=lambda params, tokens, caches: mod.decode_step(cfg, params, tokens, caches),
    )
