"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The reference's ``models/moe.py`` in PyTorch: top-k routing -> a stable
sort of the (token, expert) slots by expert -> position within the expert
by ``searchsorted`` -> scatter into a dense ``(E, capacity, d)`` buffer
(slots past capacity are dropped, GShard-style) -> block-diagonal expert
SwiGLU products (``torch.matmul`` over the expert axis, as the reference
leaves its ``einsum``s to XLA) -> weighted combine.  Shared experts
(qwen2-moe) are one dense SwiGLU over all tokens, added to the routed
output.

Both dispatches of the reference are here and share one body:

* ``global`` (every config): one group of all ``N = B * T`` tokens of the
  call, capacity ``round(N * k / E * capacity_factor)`` rounded up to a
  multiple of 128;
* ``grouped``: ``G`` groups of ``N / G`` tokens, each sorted and scattered
  on its own, capacity ``max(8, ceil8(int(n * k / E * capacity_factor)))``.
  The port has no mesh, so this is the reference's einsum branch; its
  ``shard_map`` branch waits for the mesh (``ROADMAP.md`` §1 item 8).

Capacity depends on the call's token count, padding included, so a token's
output depends on the other tokens of its call, as in the reference.

Determinism.  Ties among the gates go to the lower expert index, as
``jax.lax.top_k`` breaks them (a stable descending sort); the kept slots
are unique, so the scatter into the buffer writes each once (dropped slots
all land on a sentinel row that is thrown away); the combine adds a
token's ``k`` contributions in a fixed order, ascending expert id (the
order the reference's sorted scatter-add visits them), without atomics.
So two runs of one call give the same bits on the card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Leaf

__all__ = ["Routing", "moe_plan", "moe_apply", "route", "dropped_slots"]


def moe_plan(cfg: ArchConfig) -> Dict[str, object]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    d_axis = None if cfg.moe_replicate_d else "embed"
    p: Dict[str, object] = {
        "router": Leaf((d, E), ("embed", None), scale=0.02),
        "w_gate": Leaf((E, d, ff), ("experts", d_axis, "mlp")),
        "w_up": Leaf((E, d, ff), ("experts", d_axis, "mlp")),
        "w_down": Leaf((E, ff, d), ("experts", "mlp", d_axis)),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": Leaf((d, sff), ("embed", "mlp")),
            "w_up": Leaf((d, sff), ("embed", "mlp")),
            "w_down": Leaf((sff, d), ("mlp", "embed")),
        }
    return p


class Routing(NamedTuple):
    gates: torch.Tensor  # (..., E) f32 softmax of the router logits
    topv: torch.Tensor  # (..., k) f32, renormalized to sum 1
    topi: torch.Tensor  # (..., k) int64, descending gate, lower index on ties


def route(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> Routing:
    """Top-k routing of tokens ``x`` (..., d): logits in the parameters'
    dtype, then softmax and top-k in f32."""
    logits = (x @ p["router"]).to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.moe_topk
    topv, topi = vals[..., :k], idx[..., :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return Routing(gates, topv, topi)


def _groups(cfg: ArchConfig, n_tokens: int) -> Tuple[int, int]:
    """(groups, capacity per expert and group) for a call of ``n_tokens``."""
    E, k = cfg.n_experts, cfg.moe_topk
    if cfg.moe_dispatch == "grouped":
        G = min(cfg.moe_groups, n_tokens)
        while n_tokens % G:
            G //= 2
        n_loc = n_tokens // G
        return G, int(max(8, -(-int(n_loc * k / E * cfg.capacity_factor) // 8) * 8))
    # a multiple of 128, so the reference's (E, capacity, d) buffer shards
    # evenly over its data-parallel axes
    capacity = int(max(1, round(n_tokens * k / E * cfg.capacity_factor)))
    return 1, -(-capacity // 128) * 128


class _Slots(NamedTuple):
    order: torch.Tensor  # (G, n*k) stable argsort of the slots by expert
    slot: torch.Tensor  # (G, n*k) buffer row of each sorted slot, E*capacity if dropped
    keep: torch.Tensor  # (G, n*k) bool


def _assign(topi: torch.Tensor, n_experts: int, capacity: int) -> _Slots:
    """Each (token, choice) slot's row in the (E * capacity) buffer: sorted
    stably by expert, its position within the expert from ``searchsorted``;
    positions past capacity go to the sentinel row ``E * capacity``."""
    G, n, k = topi.shape
    flat_e = topi.reshape(G, n * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order).contiguous()
    seg_start = torch.searchsorted(sorted_e, sorted_e)  # side="left"
    pos = torch.arange(n * k, device=topi.device)[None] - seg_start
    keep = pos < capacity
    slot = sorted_e * capacity + pos.clamp_max(capacity - 1)
    slot = torch.where(keep, slot, torch.full_like(slot, n_experts * capacity))
    return _Slots(order, slot, keep)


def _expert_swiglu(p, buf: torch.Tensor) -> torch.Tensor:
    """(G, E, capacity, d) -> (G, E, capacity, d), expert e's SwiGLU on its rows."""
    g = torch.matmul(buf, p["w_gate"])
    u = torch.matmul(buf, p["w_up"])
    return torch.matmul(F.silu(g) * u, p["w_down"])


def _shared(p, x: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def moe_apply(
    cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (out (B, T, d), aux), ``aux`` the Switch
    load-balancing loss (f32 scalar).  Dispatch per ``cfg.moe_dispatch``."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.moe_topk
    N = B * T
    G, capacity = _groups(cfg, N)
    n = N // G
    xg = x.reshape(G, n, d)
    r = route(cfg, p, xg)

    density = F.one_hot(r.topi[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(density * r.gates.mean(dim=(0, 1)))

    s = _assign(r.topi, E, capacity)
    sorted_t = s.order // k  # slot t*k + j is token t's j-th choice
    rows = E * capacity
    xs = torch.gather(xg, 1, sorted_t[..., None].expand(G, n * k, d))
    buf = torch.zeros((G, rows + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, s.slot[..., None].expand(G, n * k, d), xs)
    y = _expert_swiglu(p, buf[:, :rows].reshape(G, E, capacity, d)).reshape(G, rows, d)

    y_slot = torch.gather(y, 1, s.slot.clamp_max(rows - 1)[..., None].expand(G, n * k, d))
    y_slot = torch.where(s.keep[..., None], y_slot, torch.zeros_like(y_slot))
    sorted_w = torch.gather(r.topv.reshape(G, n * k), 1, s.order)
    contrib = y_slot * sorted_w[..., None].to(y.dtype)  # (G, n*k, d), expert-sorted
    # each token's k contributions, ascending expert id, summed in that order
    rank = torch.empty_like(s.order)  # each slot's place in the sorted order
    rank.scatter_(1, s.order, torch.arange(n * k, device=x.device).expand(G, n * k))
    by_expert = torch.gather(rank.reshape(G, n, k), 2, torch.argsort(r.topi, dim=-1))
    parts = torch.gather(contrib, 1, by_expert.reshape(G, n * k, 1).expand(G, n * k, d)).reshape(G, n, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]

    out = out.reshape(B, T, d)
    if cfg.n_shared_experts:
        out = out + _shared(p, x)
    return out, aux


def dropped_slots(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """How many of the call's (token, expert) slots :func:`moe_apply` drops
    for lack of capacity (an int64 scalar on ``x``'s device)."""
    B, T, d = x.shape
    G, capacity = _groups(cfg, B * T)
    topi = route(cfg, p, x.reshape(G, -1, d)).topi
    return (~_assign(topi, cfg.n_experts, capacity).keep).sum()
