"""Attention layer: plan, prefill, one-token decode and cross-attention.

  * prefill: ``attn_prefill`` → K4 (``kernels.ops.flash_attention``) on the
    card, its plain version (the reference's q-chunked ``chunked_mha``) on
    the CPU;
  * decode: ``attn_decode`` writes the new token into the cache in place and
    runs K3 (``kernels.ops.decode_attention``) over the cache, read in its
    native ``(B, S, Hkv, Dh)`` layout;
  * cross-attention (the encdec family's decoder against the encoder
    memory): ``memory_kv`` and ``cross_attn_prefill``, with no RoPE and no
    mask but the memory's length.  The reference computes it in plain jnp
    (``chunked_mha``, ``_decode_mha_plain``), outside any Pallas kernel, so
    the port runs K4's and K3's plain versions, which are those functions,
    on every device;
  * GQA throughout (n_kv_heads <= n_heads).

Under a process-group mesh (``sharding.use_rules`` with a ``DeviceMesh``,
one process a device) the tensors are DTensors and the reference's
sharding constraints apply (``sharding.constrain``).  Prefill runs K4 on
each rank's own batch rows and query heads (``local_map``), whatever the
mesh, as the reference's ``kops.mha`` does.  Decode follows the
reference's dispatch: K3 only without such a mesh; with one whose
``"kv_seq_decode"`` rule splits S, the sequence-parallel decode
(:func:`_decode_mha_sp`: each rank's block of the cache's S axis gives a
partial ``(m, l, acc)``, combined by one ``all_reduce(MAX)`` and two
``all_reduce(SUM)`` over that axis, or over the axes a tuple rule names as
one group); with any other, K3 on each rank's rows.  A rule whose axes
hold one rank splits nothing, so it takes the rows' K3 with no collective,
as XLA drops a collective over one device.  The new token's K/V lands only
on the rank that holds its slot (:func:`write_at`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import sharding
from repro_torch.models.common import Leaf, rope

__all__ = [
    "attn_plan",
    "attn_prefill",
    "attn_decode",
    "write_at",
    "cross_attn_prefill",
    "memory_kv",
]


def attn_plan(cfg: ArchConfig) -> Dict[str, Leaf]:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": Leaf((d, hq * dh), ("embed", "heads")),
        "wk": Leaf((d, hkv * dh), ("embed", "kv_heads")),
        "wv": Leaf((d, hkv * dh), ("embed", "kv_heads")),
        "wo": Leaf((hq * dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((hq * dh,), ("heads",), "zeros")
        p["bk"] = Leaf((hkv * dh,), ("kv_heads",), "zeros")
        p["bv"] = Leaf((hkv * dh,), ("kv_heads",), "zeros")
    return p


def _project_qkv(cfg: ArchConfig, p, x, positions):
    """Returns (q_roped, k_roped, v, k_pre_rope), each (B, T, H, Dh)."""
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, cfg.n_heads, cfg.d_head)
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k_pre = k
    k = rope(k, positions, cfg.rope_theta)
    q = sharding.constrain(q, "batch", "seq", "act_heads", "head_dim")
    k = sharding.constrain(k, "batch", "seq", "act_kv", "head_dim")
    v = sharding.constrain(v, "batch", "seq", "act_kv", "head_dim")
    return q, k, v, k_pre


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    """(B, T, H * Dh) -> (B, T, H, Dh).  A DTensor whose last axis is split
    over more shards than divide the heads is gathered on it first (15
    heads' columns split two ways cannot become whole heads)."""
    B, T = x.shape[:2]
    if isinstance(x, DTensor) and n_heads % sharding.shard_count(x, 2):
        x = x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                                           for p in x.placements])
    return x.reshape(B, T, n_heads, d_head)


class _MergeHeads(torch.autograd.Function):
    """(B, T, H, Dh) -> (B, T, H * Dh), whose backward splits the gradient's
    last axis into heads by :func:`_split_heads`: a gradient that arrives
    split over more shards than divide the heads (``wo``'s rows over
    ``"model"``) is gathered on that axis first, as the forward's split is."""

    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[2:]
        return x.reshape(*x.shape[:2], -1)

    @staticmethod
    def backward(ctx, g):
        return _split_heads(g, *ctx.heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return _MergeHeads.apply(x) if isinstance(x, DTensor) else x.reshape(*x.shape[:2], -1)


def _kv_heads_for(q_heads: range, rep: int, k_first: int, n_k: int):
    """The local K/V heads that the global query heads ``q_heads`` read (GQA
    ratio ``rep``), given the rank's K/V heads start at global head
    ``k_first``: a slice when the query heads take whole groups or share one
    K/V head, else one index per query head."""
    idx = [h // rep - k_first for h in q_heads]
    if min(idx) < 0 or max(idx) >= n_k:
        raise ValueError(f"query heads {q_heads} read K/V heads outside this rank's {k_first}..{k_first + n_k}")
    first, n = idx[0], idx[-1] - idx[0] + 1
    if len(q_heads) % n == 0 and idx == [first + j // (len(q_heads) // n) for j in range(len(q_heads))]:
        return slice(first, first + n)
    return torch.tensor(idx)


def _flash_attention_sharded(q: DTensor, k: DTensor, v: DTensor, prefix_len, causal: bool, attend=None):
    """K4 (or ``attend``, the same contract) on each rank's own batch rows
    and query heads of DTensors ``q`` (B, Tq, Hq, D), ``k``/``v`` (B, Tk,
    Hkv, D): the sequence axes are whole on every rank (``"seq"`` is never
    split), K/V are brought to ``q``'s batch split, and each rank reads the
    K/V heads its query heads need.  Runs under autograd (``kernels.ops``'
    Function through ``local_map``)."""
    mesh = q.device_mesh
    kv_pl = [pq if isinstance(pq, Shard) and pq.dim == 0 else pk for pq, pk in zip(q.placements, k.placements)]
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    Hq, Hkv = q.shape[2], k.shape[2]
    h0, b0 = sharding.shard_offset(q, 2), sharding.shard_offset(q, 0)
    hq = Hq // sharding.shard_count(q, 2)
    heads = _kv_heads_for(range(h0, h0 + hq), Hq // Hkv, sharding.shard_offset(k, 2), Hkv // sharding.shard_count(k, 2))
    b_loc = q.shape[0] // sharding.shard_count(q, 0)
    plen = None if prefix_len is None else prefix_len[b0:b0 + b_loc]

    # K/V whole on the ranks that split the query heads: each rank's gradient
    # covers its own heads' reads, so the ranks' gradients add up
    kv_grad = [Partial() if isinstance(pq, Shard) and pq.dim == 2 and isinstance(pk, Replicate) else pk
               for pq, pk in zip(q.placements, kv_pl)]

    def local(q, k, v):  # ``ops.flash_attention`` read at the call (a caller may wrap it)
        return (attend or ops.flash_attention)(q, k[:, :, heads], v[:, :, heads], plen, causal=causal)

    return local_map(local, out_placements=list(q.placements), in_placements=(list(q.placements), kv_pl, kv_pl),
                     in_grad_placements=(list(q.placements), kv_grad, kv_grad), device_mesh=mesh)(q, k, v)


def attn_prefill(
    cfg: ArchConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, T, d)
    positions: torch.Tensor,  # (B, T)
    *,
    causal: bool = True,
    prefix_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (attn_out (B,T,d), (k, v) each (B,T,Hkv,Dh)) — the KV cache.

    With ``cfg.prerope_kv_cache`` the cached K is pre-RoPE (decode rotates
    it at read time); attention math always uses roped K.
    """
    q, k, v, k_pre = _project_qkv(cfg, p, x, positions)
    if isinstance(q, DTensor):
        o = _flash_attention_sharded(q, k, v, prefix_len, causal)
    else:
        o = ops.flash_attention(q, k, v, prefix_len, causal=causal)
    out = _merge_heads(o) @ p["wo"]
    k_cache = k_pre if cfg.prerope_kv_cache else k
    return out, (k_cache, v)


def write_at(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """In place, per row: ``cache[b, start[b] : start[b] + T] = new[b]``.

    cache (B, S, ...), new (B, T, ...), start (B,) on the cache's device.
    The start clamps to ``[0, S - T]`` as ``jax.lax.dynamic_update_slice``
    clamps it, so an overhanging write lands on the last T slots instead of
    raising or being dropped.

    A DTensor ``cache`` (split over rows and slots) is written in its local
    form: each rank writes the rows and slots of its own block, from
    ``new`` brought to the cache's row split, so a slot lands on the one
    rank that holds it.  The local write has the same shapes whatever the
    data (no mask indexing, so it runs on meta tensors and reads nothing
    back to the host): one slot a row is scattered, a longer write selects
    each slot of the block from ``new`` or the cache.
    """
    if isinstance(cache, DTensor):
        return _write_at_sharded(cache, new, start)
    B, S = cache.shape[:2]
    T = new.shape[1]
    s0 = start.to(torch.int64).clamp(0, S - T)
    idx = s0[:, None] + torch.arange(T, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    cache[rows, idx] = new.to(cache.dtype)


def _write_at_sharded(cache: DTensor, new, start: torch.Tensor) -> None:
    S, T = cache.shape[1], new.shape[1]
    if isinstance(new, DTensor):
        new = new.redistribute(cache.device_mesh, sharding.split_only(cache)).to_local()
    local = cache.to_local()
    b0, s0 = sharding.shard_offset(cache, 0), sharding.shard_offset(cache, 1)
    b_loc, s_loc = local.shape[:2]
    if new.shape[0] != b_loc:
        new = new[b0:b0 + b_loc]
    first = start.to(torch.int64)[b0:b0 + b_loc].to(local.device).clamp(0, S - T)
    new = new.to(local.dtype)
    rows = torch.arange(b_loc, device=local.device)
    heads = (None,) * (local.ndim - 2)  # a row's (or slot's) mask over the trailing axes
    if T == 1:  # one slot a row: a row whose slot is elsewhere writes its own value back
        pos = first - s0
        slot = pos.clamp(0, s_loc - 1)
        mine = ((pos >= 0) & (pos < s_loc))[(slice(None),) + heads]
        local[rows, slot] = torch.where(mine, new[:, 0], local[rows, slot])
        return
    # every slot of the block takes new's token t = slot + s0 - first, where one is
    t = torch.arange(s_loc, device=local.device)[None, :] + s0 - first[:, None]
    have = ((t >= 0) & (t < T))[(slice(None), slice(None)) + heads]
    local.copy_(torch.where(have, new[rows[:, None], t.clamp(0, T - 1)], local))


def attn_decode(
    cfg: ArchConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d)
    cache: Tuple[torch.Tensor, torch.Tensor],  # (B, S, Hkv, Dh) x2, updated in place
    cache_len: torch.Tensor,  # (B,) tokens already in cache
) -> torch.Tensor:
    """One-token decode; writes the token's K/V at ``cache_len`` (clamped to
    the last slot when the cache is full, as the reference's
    ``dynamic_update_slice`` does) into ``cache`` in place and returns the
    attention output (B, 1, d)."""
    B = x.shape[0]
    q, k, v, k_pre = _project_qkv(cfg, p, x, cache_len[:, None])
    kc, vc = cache
    write_at(kc, k_pre if cfg.prerope_kv_cache else k, cache_len)
    write_at(vc, v, cache_len)
    kv_len = (cache_len + 1).to(torch.int32)
    if cfg.prerope_kv_cache:
        # rotate the whole cache at read time (position grid 0..S)
        S = kc.shape[1]
        pos_grid = torch.arange(S, dtype=torch.int32, device=kc.device)[None].expand(B, S)
        kc_read = rope(kc, pos_grid, cfg.rope_theta)
    else:
        kc_read = kc
    mesh = sharding.process_mesh()
    if mesh is None:
        o = ops.decode_attention(q[:, 0], kc_read, vc, kv_len)
    else:
        o = _decode_mha_sp(q[:, 0], kc_read, vc, kv_len, mesh)
    out = o.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return out.to(p["wo"].dtype) @ p["wo"]


def _seq_group(mesh, seq_axis):
    """The process group of the mesh axes ``seq_axis`` (one name, or a tuple
    taken as one flattened axis), or None where they hold one rank."""
    axes = (seq_axis,) if isinstance(seq_axis, str) else tuple(seq_axis)
    if int(np.prod([mesh.size(mesh.mesh_dim_names.index(a)) for a in axes])) == 1:
        return None
    return mesh.get_group(axes[0]) if len(axes) == 1 else mesh[axes]._flatten().get_group()


def _decode_mha_sp(q, kc, vc, kv_len, mesh):
    """Decode attention of q (B, Hq, D) against DTensor caches (B, S, Hkv, D)
    in their local form, each rank on its own rows.  Where the rules'
    ``"kv_seq_decode"`` axes split the cache's S evenly over more than one
    rank (the sequence-parallel decode): each rank masks its block's
    positions ``s0 + arange(S_loc)`` against ``kv_len``, computes a partial
    ``(m, l, acc)`` in f32, and the blocks combine by ``all_reduce(MAX)`` of
    ``m`` and ``all_reduce(SUM)`` of the rescaled ``l`` and ``acc`` over
    those axes' group.  Elsewhere the rank's rows are whole and K3 runs on
    them.  Both compute in f32 from the cache's values, as K3 does (the
    reference's einsums round the bf16 scores first)."""
    if not isinstance(kc, DTensor):
        raise TypeError("the process-group decode takes DTensor caches")
    spec = sharding.divisible(sharding.logical_to_spec(("batch", "kv_seq_decode", None, None)), kc.shape, mesh)
    group = None if spec[1] is None else _seq_group(mesh, spec[1])
    want = sharding.placements(spec, mesh)
    kc, vc = kc.redistribute(mesh, want), vc.redistribute(mesh, want)
    rows = sharding.split_only(kc)
    k_loc, v_loc = kc.to_local(), vc.to_local()
    b0, B = sharding.shard_offset(kc, 0), k_loc.shape[0]
    q_loc = q.redistribute(mesh, rows).to_local() if isinstance(q, DTensor) else q[b0:b0 + B]
    Hq, D = q_loc.shape[1], q_loc.shape[2]
    lens = kv_len[b0:b0 + B].to(k_loc.device)
    q_loc, k_loc, v_loc = q_loc.float(), k_loc.float(), v_loc.float()  # K3's arithmetic: f32 from the cache
    if group is None:
        o = ops.decode_attention(q_loc, k_loc, v_loc, lens).to(q.dtype)
    else:
        S_loc, Hkv = k_loc.shape[1], k_loc.shape[2]
        rep = Hq // Hkv
        scale = 1.0 / np.sqrt(D)
        qg = q_loc.reshape(B, Hkv, rep, D)
        s = torch.einsum("bkrd,bskd->bkrs", qg, k_loc) * scale
        pos = sharding.shard_offset(kc, 1) + torch.arange(S_loc, device=k_loc.device)
        mask = pos[None, None, None, :] < lens[:, None, None, None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m = s.amax(dim=-1, keepdim=True)
        pr = torch.exp(s - m)
        l = pr.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkrs,bskd->bkrd", pr, v_loc)
        m_glob = m.clone()
        dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - m_glob)
        l_glob = l * corr
        acc_glob = acc * corr
        dist.all_reduce(l_glob, group=group)
        dist.all_reduce(acc_glob, group=group)
        o = (acc_glob / torch.clamp_min(l_glob, 1e-30)).reshape(B, Hq, D).to(q.dtype)
    return DTensor.from_local(o, mesh, rows, run_check=False)


def memory_kv(cfg: ArchConfig, p, mem: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder memory (B, S, d) once into cross-attention K/V, each
    (B, S, Hkv, Dh): no RoPE."""
    k = mem @ p["wk"]
    v = mem @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return _split_heads(k, cfg.n_kv_heads, cfg.d_head), _split_heads(v, cfg.n_kv_heads, cfg.d_head)


def cross_attn_prefill(cfg: ArchConfig, p, x: torch.Tensor, mem_kv) -> torch.Tensor:
    """Decoder states (B, T, d) against the memory's K/V: every query sees
    every memory row (no mask, no RoPE), through K4's plain version (the
    reference's ``chunked_mha``; its query chunk bounds memory only), on
    DTensors in each rank's rows and heads; returns (B, T, d)."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = _split_heads(q, cfg.n_heads, cfg.d_head)
    k, v = mem_kv
    if isinstance(q, DTensor):
        o = _flash_attention_sharded(q, k, v, None, False, attend=flash_attention_plain)
    else:
        o = flash_attention_plain(q, k, v, causal=False)
    return _merge_heads(o) @ p["wo"]
