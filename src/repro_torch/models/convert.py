"""Bring weights held as numpy arrays into the port's parameter layout.

The port keeps the reference's parameter tree (nested dicts, per-layer
weights stacked on a leading ``L`` axis, projections ``(in, out)``), so a
tree of numpy arrays — for example the reference's initialized parameters
passed through ``np.asarray`` leaf by leaf, or leaves loaded from ``.npy``
files — converts leaf for leaf.  Both packages then compute the same
function on the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import DTYPES
from repro_torch.models.model import build

__all__ = ["params_from_numpy"]


def _convert(node, plan, device, dtype, path: str):
    if isinstance(node, dict):
        if not isinstance(plan, dict) or set(node) != set(plan):
            raise ValueError(f"parameter tree at {path or '<root>'} does not match the plan")
        return {k: _convert(node[k], plan[k], device, dtype, f"{path}/{k}") for k in node}
    a = np.array(node, dtype=np.float32)  # a copy; also lifts bfloat16 leaves losslessly
    if tuple(a.shape) != tuple(plan.shape):
        raise ValueError(f"parameter {path}: shape {a.shape} != planned {plan.shape}")
    return torch.as_tensor(a, device=device).to(dtype)


def params_from_numpy(
    cfg: ArchConfig, tree: Dict[str, Any], device, dtype: Optional[torch.dtype] = None
) -> Dict[str, Any]:
    """Numpy parameter tree -> tensors on ``device`` in ``dtype`` (default
    ``cfg.dtype``), checked leaf by leaf against the family's plan
    (``build(cfg).param_plan()``)."""
    dtype = DTYPES[cfg.dtype] if dtype is None else dtype
    return _convert(tree, build(cfg).param_plan(), torch.device(device), dtype, "")
