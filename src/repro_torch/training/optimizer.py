"""AdamW (+ global-norm clipping, linear warmup) on parameter trees.

Port of ``src/repro/training/optimizer.py``.  Moments are kept in float32
whatever the parameters' dtype; the update runs in f32 and is cast back.
The state is a plain tree of tensors, the reference's layout.

The reference's f32 arithmetic is kept op for op: the step count, the
warmup fraction ``(step + 1) / warmup`` and the bias corrections
``1 - b ** step`` are f32 tensors, never Python doubles, and every division
by a scalar divides by an f32 tensor on the device (``_f32``): PyTorch's CUDA
division by a Python number multiplies by its reciprocal, one rounding more
than JAX's division.  The global norm adds the leaves' squared sums in the
reference's flatten order (``repro_torch._tree``: dict keys sorted).

The same code runs on DTensor parameters under ``sharding.use_rules``
with a process-group mesh: moments take each parameter's placements, each
gradient is brought to its parameter's (its partial sums reduced) and every
new leaf keeps them, a sharded leaf's squared sum is reduced over its
shards, and the scalars made here act as replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor  # () int32


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as an f32 scalar tensor on ``like``'s device (a fill, no copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _placed_as(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` (a gradient, a moment, an update) in its parameter
    ``p``'s placements, so a parameter keeps its split step after step (a
    gradient's partial sums are reduced here); a plain tensor as it is."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(p.placements):
        return x.redistribute(p.device_mesh, p.placements)
    return x


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared f32 values, summed leaf by
    leaf in flatten order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32))) for leaf in tree_leaves(tree)))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` (f32), from the 0-based step count."""
    warm = torch.clamp_max((step + 1).to(torch.float32) / _f32(max(cfg.warmup_steps, 1), step), 1.0)
    return cfg.lr * warm


def apply_updates(
    params, grads, state: OptState, cfg: AdamWConfig
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: returns (new params in their dtypes, new state,
    {"grad_norm": the pre-clip global norm, "lr": this step's rate})."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(_f32(cfg.grad_clip, gnorm) / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    c1 = 1.0 - torch.pow(_f32(cfg.b1, gnorm), step.to(torch.float32))
    c2 = 1.0 - torch.pow(_f32(cfg.b2, gnorm), step.to(torch.float32))

    def upd(p, g, mu, nu):
        g = _placed_as(g, p).to(torch.float32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / c1
        nhat = nu / c2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return _placed_as((p.to(torch.float32) - lr * delta).to(p.dtype), p), _placed_as(mu, p), _placed_as(nu, p)

    out = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (params, grads, state.mu, state.nu)))]
    new_p, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, OptState(mu=new_mu, nu=new_nu, step=step), {"grad_norm": gnorm, "lr": lr}
