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

Under a process-group mesh (``sharding.use_rules`` with a ``DeviceMesh``)
the groups are split over ``"expert_cap"``'s axes and the layer runs in its
local form (:func:`_grouped_ffn_combine_sm`, the reference's ``shard_map``
branch): DTensor has no sharding rule for the dispatch's sort, gather,
``searchsorted`` and scatter, and each group's dispatch needs none, so each
rank routes, sorts and scatters its own groups with the single-device code.
The expert FFN splits ``ff`` over ``"act_mlp"``'s axis: each rank combines
its partial down-projections into ``(G_loc, n, d)`` and one
``all_reduce(SUM)`` over that axis adds them (never the ``(G, E, capacity,
d)`` buffer).  Routing, capacity and drops are the single-device ones.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.models import sharding
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


def _combine(cfg: ArchConfig, xg: torch.Tensor, topv: torch.Tensor, topi: torch.Tensor, capacity: int, ffn):
    """The routed half of the layer on groups ``xg`` (G, n, d) routed to
    ``topi`` with weights ``topv`` (G, n, k): slot assignment, the (G, E,
    capacity, d) buffer through ``ffn``, and the weighted combine; returns
    out (G, n, d)."""
    G, n, d = xg.shape
    E, k = cfg.n_experts, cfg.moe_topk
    s = _assign(topi, E, capacity)
    sorted_t = s.order // k  # slot t*k + j is token t's j-th choice
    rows = E * capacity
    xs = torch.gather(xg, 1, sorted_t[..., None].expand(G, n * k, d))
    buf = torch.zeros((G, rows + 1, d), dtype=xg.dtype, device=xg.device)
    buf.scatter_(1, s.slot[..., None].expand(G, n * k, d), xs)
    y = ffn(buf[:, :rows].reshape(G, E, capacity, d)).reshape(G, rows, d)

    y_slot = torch.gather(y, 1, s.slot.clamp_max(rows - 1)[..., None].expand(G, n * k, d))
    y_slot = torch.where(s.keep[..., None], y_slot, torch.zeros_like(y_slot))
    sorted_w = torch.gather(topv.reshape(G, n * k), 1, s.order)
    contrib = y_slot * sorted_w[..., None].to(y.dtype)  # (G, n*k, d), expert-sorted
    # each token's k contributions, ascending expert id, summed in that order
    rank = torch.empty_like(s.order)  # each slot's place in the sorted order
    rank.scatter_(1, s.order, torch.arange(n * k, device=xg.device).expand(G, n * k))
    by_expert = torch.gather(rank.reshape(G, n, k), 2, torch.argsort(topi, dim=-1))
    parts = torch.gather(contrib, 1, by_expert.reshape(G, n * k, 1).expand(G, n * k, d)).reshape(G, n, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out


def _aux_loss(E: int, gates: torch.Tensor, top1: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss from the gates (G, n, E) and each
    token's first choice (G, n): ``E * sum(density * mean gate)``."""
    density = F.one_hot(top1, E).to(torch.float32).mean(dim=(0, 1))
    return E * torch.sum(density * gates.mean(dim=(0, 1)))


def moe_apply(
    cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (out (B, T, d), aux), ``aux`` the Switch
    load-balancing loss (f32 scalar).  Dispatch per ``cfg.moe_dispatch``;
    a DTensor ``x`` runs the local form (:func:`_grouped_ffn_combine_sm`)."""
    B, T, d = x.shape
    G, capacity = _groups(cfg, B * T)
    xg = sharding.constrain(x.reshape(G, -1, d), "expert_cap", None, "act_embed")
    if isinstance(xg, DTensor):
        out, gates, top1 = _grouped_ffn_combine_sm(cfg, p, xg, capacity)
    else:
        r = route(cfg, p, xg)
        out = _combine(cfg, xg, r.topv, r.topi, capacity, lambda buf: _expert_swiglu(p, buf))
        gates, top1 = r.gates, r.topi[..., 0]
    out = out.reshape(B, T, d)
    if cfg.n_shared_experts:
        out = out + _shared(p, x)
    return out, _aux_loss(cfg.n_experts, gates, top1)


def _placed(w: torch.Tensor, mesh, spec) -> DTensor:
    """Weight ``w`` (a DTensor, or a full tensor the same on every rank)
    as a DTensor split as ``spec`` over ``mesh``."""
    if not isinstance(w, DTensor):
        w = distribute_tensor(w, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    return w.redistribute(mesh, sharding.placements(spec, mesh))


def _local_groups(xg: DTensor):
    """(``xg`` with only the mesh axes that split the groups kept, their
    placements, the process groups of those axes)."""
    mesh = xg.device_mesh
    rows = sharding.split_only(xg)
    split = [mesh.get_group(i) for i, pl in enumerate(rows) if isinstance(pl, Shard)]
    return xg.redistribute(mesh, rows), rows, split


def _grouped_ffn_combine_sm(cfg: ArchConfig, p, xg: DTensor, capacity: int):
    """The layer's routed half on DTensor groups ``xg`` (G, n, d) in local
    form, under autograd too: each rank routes and dispatches its own
    groups, runs the expert FFN on its ``ff`` block of ``act_mlp``'s axis
    (the whole ``ff`` when the axis is unset or does not divide it) and
    combines its partial outputs locally; the (G, n, d) result is ``Partial``
    over that axis, and one ``all_reduce(SUM)`` of each rank's (G_loc, n, d)
    adds them.  The backward declares what each rank's gradient covers:
    the weights' over the groups' axes and the input's and routing weights'
    over the ``ff`` axis are partial sums.  Returns (out (G, n, d), gates
    (G, n, E), first choices (G, n)), DTensors split as the groups."""
    mesh = xg.device_mesh
    mlp_axis = sharding.logical_to_spec(("act_mlp",))[0]
    if mlp_axis is not None and p["w_gate"].shape[-1] % mesh[mlp_axis].size():
        mlp_axis = None
    if mlp_axis is not None and not isinstance(mlp_axis, str):
        raise ValueError(f"the expert FFN splits ff over one mesh axis, not {mlp_axis}")
    xg, rows, _ = _local_groups(xg)
    m = None if mlp_axis is None else list(mesh.mesh_dim_names).index(mlp_axis)
    if m is not None and isinstance(rows[m], Shard):
        raise ValueError(f"mesh axis {mlp_axis} splits both the groups and the expert FFN's ff")
    summed = [Partial() if isinstance(pl, Shard) else Replicate() for pl in rows]  # a weight's gradient
    part = [Partial() if i == m else pl for i, pl in enumerate(rows)]  # ff's partial products
    specs = {"router": (None, None), "w_gate": (None, None, mlp_axis), "w_up": (None, None, mlp_axis),
             "w_down": (None, mlp_axis, None)}
    w = {k: _placed(p[k], mesh, spec) for k, spec in specs.items()}
    w_pl = {k: list(v.placements) for k, v in w.items()}
    w_grad = {k: [pl if i == m else s for i, (pl, s) in enumerate(zip(w_pl[k], summed))] for k in w}

    def local_route(x, router):
        r = route(cfg, {"router": router}, x)
        return r.gates, r.topv, r.topi

    gates, topv, topi = local_map(local_route, out_placements=(rows, rows, rows), in_placements=(rows, w_pl["router"]),
                                  in_grad_placements=(rows, w_grad["router"]), device_mesh=mesh)(xg, w["router"])

    def local_ffn(x, topv, topi, w_gate, w_up, w_down):
        local = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        return _combine(cfg, x, topv, topi, capacity, lambda buf: _expert_swiglu(local, buf))

    ffn = ("w_gate", "w_up", "w_down")
    out = local_map(local_ffn, out_placements=part, in_placements=(rows, rows, rows) + tuple(w_pl[k] for k in ffn),
                    in_grad_placements=(part, part, rows) + tuple(w_grad[k] for k in ffn),
                    device_mesh=mesh)(xg, topv, topi, *(w[k] for k in ffn))
    return out.redistribute(mesh, rows), gates, topi[..., 0]


def dropped_slots(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """How many of the call's (token, expert) slots :func:`moe_apply` drops
    for lack of capacity (an int64 scalar on ``x``'s device)."""
    B, T, d = x.shape
    G, capacity = _groups(cfg, B * T)
    xg = sharding.constrain(x.reshape(G, -1, d), "expert_cap", None, "act_embed")
    if not isinstance(xg, DTensor):
        return (~_assign(route(cfg, p, xg).topi, cfg.n_experts, capacity).keep).sum()
    x_loc, _, split = _local_groups(xg)
    topi = route(cfg, {"router": _placed(p["router"], xg.device_mesh, (None, None)).to_local()}, x_loc.to_local()).topi
    drops = (~_assign(topi, cfg.n_experts, capacity).keep).sum()
    for group in split:
        dist.all_reduce(drops, group=group)
    return drops
