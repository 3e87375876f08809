"""Gradient compression with error feedback.

Port of ``src/repro/training/grad_compress.py``: :func:`ef_compress`
quantizes each gradient leaf (plus the error carried from the last step) to
int8-range symbols with one symmetric scale a leaf, and carries what the
quantization lost into the next step (1-bit-Adam family).  ``torch.round``
rounds half to even, as ``jnp.round`` does; the divisions divide by f32
tensors on the device, as the reference's do (see ``training.optimizer``).

:func:`compressed_psum` is the cross-device mean whose wire tensor is
int8: each rank quantizes with one scale shared over the axis (an
``all_reduce(MAX)`` of the ranks' ``|x|`` maxima), ``all_gather``s the int8
symbols over the axis's process group, and sums them dequantized.  It runs
on each rank's local tensor inside ``sharding.use_rules`` with a
``DeviceMesh`` (one process a device), where the reference runs inside
``shard_map`` with the axis bound.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["ef_compress", "ef_init", "compressed_psum"]


def ef_init(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


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


def _int8_symbols(x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 symbols of ``x``, the scale shared over ``group``): ``scale =
    max(max|x| over the group / 127, 1e-12)`` in f32, divided on the
    device; ``round(x / scale)`` half to even, clipped to ``[-127, 127]``."""
    import torch.distributed as dist

    xf = x.to(torch.float32)
    absmax = torch.max(torch.abs(xf))
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(absmax / torch.full((), 127.0, dtype=torch.float32, device=x.device), 1e-12)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Mean-reduce the local tensor ``x`` over mesh axis ``axis_name`` of the
    installed process-group mesh, with int8 on the wire: each rank's
    symbols (:func:`_int8_symbols`) are gathered from every rank of the
    axis, and the f32 sum of the gathered symbols times the shared scale
    over the axis size is returned in ``x``'s dtype."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import all_gather_into_tensor
    from repro_torch.models.sharding import process_mesh

    mesh = process_mesh()
    if mesh is None:
        raise RuntimeError("compressed_psum runs under sharding.use_rules with a process-group DeviceMesh")
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    q, scale = _int8_symbols(x, group)
    gathered = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
    all_gather_into_tensor(gathered, q.reshape(-1), group)  # int8 on the wire
    total = torch.sum(gathered.reshape((n,) + tuple(q.shape)).to(torch.float32), dim=0) * scale
    return (total / torch.full((), float(n), dtype=torch.float32, device=x.device)).to(x.dtype)
