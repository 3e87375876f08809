"""Gradient compression with error feedback.

Port of ``src/repro/training/grad_compress.py``: :func:`ef_compress`
quantizes each gradient leaf (plus the error carried from the last step) to
int8-range symbols with one symmetric scale a leaf, and carries what the
quantization lost into the next step (1-bit-Adam family).  ``torch.round``
rounds half to even, as ``jnp.round`` does; the divisions divide by f32
tensors on the device, as the reference's do (see ``training.optimizer``).

The reference's ``compressed_psum`` (a cross-device mean whose wire tensor
is int8) is a collective (``all_gather``); it is not ported here and waits
for the port's slice on ``torch.distributed``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["ef_compress", "ef_init"]


def ef_init(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def ef_compress(grads, errors, bits: int = 8) -> Tuple[Any, Any]:
    """Quantize (grad + carried error); return (dequantized grads, new error)."""
    qmax = float(2 ** (bits - 1) - 1)

    def one(g, e):
        x = g.to(torch.float32) + e
        q_max = torch.full((), qmax, dtype=torch.float32, device=x.device)
        scale = torch.clamp_min(torch.max(torch.abs(x)) / q_max, 1e-12)
        q = torch.clamp(torch.round(x / scale), -qmax, qmax)
        xhat = q * scale
        return xhat.to(g.dtype), x - xhat

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(errors))]
    return (tree_unflatten(grads, [o[0] for o in out]), tree_unflatten(grads, [o[1] for o in out]))
