"""Shared model building blocks: norms, RoPE, MLPs, param plans.

Parameters are plain nested dicts of tensors with the reference's layout:
per-layer weights stacked on a leading ``L`` axis, projections stored
``(in, out)`` and applied as ``x @ W``.  A *plan* is the single source of
truth for each parameter's shape, logical sharding axes and init scale;
:func:`init_from_plan` materializes values from a ``torch.Generator`` with
the reference's std rule (its random numbers differ: the tests share
weights through ``models.convert.params_from_numpy`` instead) and
:func:`specs_from_plan` derives the matching tree of logical axes, so the
two can never drift; :func:`abstract_from_plan` gives the tree as meta
tensors (the dry run's inputs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.sharding import constrain

__all__ = [
    "Leaf",
    "init_from_plan",
    "specs_from_plan",
    "abstract_from_plan",
    "rmsnorm",
    "layernorm",
    "apply_norm",
    "norm_plan",
    "rope",
    "mlp_plan",
    "mlp_apply",
    "softmax_cross_entropy",
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's plan: shape, logical axes, init."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev override

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"plan leaf rank mismatch: {self.shape} vs {self.logical}")


def _init_leaf(leaf: Leaf, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """One leaf's values, drawn in f32 and cast.  A leaf with an
    ``"experts"`` axis under its leading (layers) axis is drawn one layer at
    a time into the cast result, so its f32 transient is one layer's: a
    whole qwen2-moe expert leaf would be 16.6 GB of f32.  Every other leaf
    is one draw, so the dense configs' weights do not depend on this."""
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
    std = leaf.scale if leaf.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))

    def draw(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device).mul_(std)

    if "experts" not in leaf.logical[1:]:
        return draw(leaf.shape).to(dtype)
    out = torch.empty(leaf.shape, dtype=dtype, device=device)
    for l in range(leaf.shape[0]):
        out[l] = draw(leaf.shape[1:])
    return out


def init_from_plan(plan: Dict[str, Any], generator: torch.Generator, device, dtype) -> Dict[str, Any]:
    """Materialize a plan's leaves in a fixed (depth-first, sorted-key) order."""
    out: Dict[str, Any] = {}
    for name in sorted(plan):
        node = plan[name]
        if isinstance(node, Leaf):
            out[name] = _init_leaf(node, generator, device, dtype)
        else:
            out[name] = init_from_plan(node, generator, device, dtype)
    return out


def specs_from_plan(plan: Dict[str, Any]) -> Dict[str, Any]:
    """The plan's tree with each leaf's logical axes in its place."""
    return {name: node.logical if isinstance(node, Leaf) else specs_from_plan(node) for name, node in plan.items()}


def abstract_from_plan(plan: Dict[str, Any], dtype=torch.float32) -> Dict[str, Any]:
    """The plan's tree with a meta tensor of each leaf's shape and ``dtype``
    in its place (the reference's ``ShapeDtypeStruct`` tree): shapes to
    trace a step with, and no memory behind them."""
    return {name: torch.empty(node.shape, dtype=dtype, device="meta") if isinstance(node, Leaf)
            else abstract_from_plan(node, dtype) for name, node in plan.items()}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: Optional[torch.Tensor], eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    return y.to(x.dtype)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y.to(x.dtype)


def norm_plan(kind: str, d: int) -> Dict[str, Leaf]:
    if kind == "rmsnorm":
        return {"gamma": Leaf((d,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"gamma": Leaf((d,), ("embed",), "ones"), "beta": Leaf((d,), ("embed",), "zeros")}
    if kind == "nonparam_ln":  # OLMo: LN without affine params
        return {}
    raise ValueError(f"unknown norm {kind}")


def apply_norm(kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor):
    if kind == "rmsnorm":
        return rmsnorm(x, p["gamma"])
    if kind == "layernorm":
        return layernorm(x, p["gamma"], p["beta"])
    if kind == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., T, half)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_plan(kind: str, d: int, ff: int, bias: bool) -> Dict[str, Leaf]:
    p: Dict[str, Leaf] = {}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = Leaf((d, ff), ("embed", "mlp"))
        p["w_up"] = Leaf((d, ff), ("embed", "mlp"))
        p["w_down"] = Leaf((ff, d), ("mlp", "embed"))
        if bias:
            p["b_gate"] = Leaf((ff,), ("mlp",), "zeros")
            p["b_up"] = Leaf((ff,), ("mlp",), "zeros")
            p["b_down"] = Leaf((d,), ("embed",), "zeros")
    elif kind == "gelu":
        p["w_up"] = Leaf((d, ff), ("embed", "mlp"))
        p["w_down"] = Leaf((ff, d), ("mlp", "embed"))
        if bias:
            p["b_up"] = Leaf((ff,), ("mlp",), "zeros")
            p["b_down"] = Leaf((d,), ("embed",), "zeros")
    else:
        raise ValueError(f"unknown mlp {kind}")
    return p


def mlp_apply(kind: str, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """swiglu / geglu / gelu; gelu is the tanh form, as ``jax.nn.gelu``'s default."""

    def maybe_bias(y, name):
        return y + p[name] if name in p else y

    if kind in ("swiglu", "geglu"):
        g = maybe_bias(x @ p["w_gate"], "b_gate")
        u = maybe_bias(x @ p["w_up"], "b_up")
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
        if h.ndim == 3:
            h = constrain(h, "batch", "seq", "act_mlp")
        return maybe_bias(h @ p["w_down"], "b_down")
    if kind == "gelu":
        h = F.gelu(maybe_bias(x @ p["w_up"], "b_up"), approximate="tanh")
        if h.ndim == 3:
            h = constrain(h, "batch", "seq", "act_mlp")
        return maybe_bias(h @ p["w_down"], "b_down")
    raise ValueError(f"unknown mlp {kind}")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over masked positions, in f32.  logits (..., V), labels (...).

    DTensor logits (split over the vocab by ``"act_vocab"``) take DTensor's
    own ops: the log-sum-exp written out around a detached maximum, and the
    label's logit picked by comparing the vocab index with the label (a
    gather along a split vocab has no DTensor rule).  The sums over the
    vocab are reduced by an explicit ``redistribute`` before they are
    combined: under torch 2.11 the reduction DTensor inserts for ``log`` by
    itself gives a wrong gradient when the batch is split as well."""
    logits = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device).to(torch.long)
    if isinstance(logits, DTensor):
        mesh, last = logits.device_mesh, logits.ndim - 1
        rows = [Replicate() if isinstance(p, Shard) and p.dim % logits.ndim == last else p for p in logits.placements]
        m = logits.detach().amax(dim=-1, keepdim=True)
        se = torch.exp(logits - m).sum(dim=-1).redistribute(mesh, rows)
        lse = m[..., 0].redistribute(mesh, rows) + torch.log(se)
        hit = torch.arange(logits.shape[-1], device=logits.device) == labels[..., None]
        ll = torch.where(hit, logits, 0.0).sum(dim=-1).redistribute(mesh, rows)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=logits.device).to(torch.float32)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
