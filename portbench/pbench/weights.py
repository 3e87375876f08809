"""The cell's weights, drawn on the device from the seed.

One flat buffer in the served dtype is filled by a few large ``normal_``
calls of one generator on the device, then carved into the leaves of the
program's parameter tree (``lm.param_plan``: names, shapes, init kind and
std), each leaf's values scaled by its std (1/sqrt(fan in) unless the plan
states one), zeros and ones where the plan says so.  Leaves start on
256-byte boundaries.  The reference reads these same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

__all__ = ["make_params"]

_ALIGN = 128  # elements
_FILL = 1 << 30  # elements a normal_ call


def _leaves(plan: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for name in sorted(plan):
        node = plan[name]
        if isinstance(node, dict):
            out.extend(_leaves(node, prefix + (name,)))
        else:
            out.append((prefix + (name,), node))
    return out


def make_params(cfg, seed: int, device) -> Dict[str, Any]:
    """The weight tree of ``cfg`` in its dtype on ``device``, from ``seed``."""
    from repro_torch.models import lm

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    leaves = _leaves(lm.param_plan(cfg))
    offsets, total = [], 0
    for _, leaf in leaves:
        offsets.append(total)
        total += -(-math.prod(leaf.shape) // _ALIGN) * _ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for start in range(0, total, _FILL):
        flat[start:start + _FILL].normal_(generator=gen)
    params: Dict[str, Any] = {}
    for (path, leaf), off in zip(leaves, offsets):
        t = flat[off:off + math.prod(leaf.shape)].view(leaf.shape)
        if leaf.init == "zeros":
            t.zero_()
        elif leaf.init == "ones":
            t.fill_(1)
        else:
            fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
            t.mul_(leaf.scale if leaf.scale is not None else 1.0 / math.sqrt(max(fan_in, 1)))
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return params
