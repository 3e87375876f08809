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

The reference's sequence-parallel decode and sharding constraints reduce
over devices (``pmax``/``psum`` over the sequence shards); the port's mesh
(``launch.mesh``) shards only cache rows, whose bodies need no collective,
so they have no counterpart here yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
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
    q = q.reshape(B, T, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    q = rope(q, positions, cfg.rope_theta)
    k_pre = k
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v, k_pre


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
    o = ops.flash_attention(q, k, v, prefix_len, causal=causal)
    B, T, _, _ = q.shape
    out = o.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]
    k_cache = k_pre if cfg.prerope_kv_cache else k
    return out, (k_cache, v)


def write_at(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """In place, per row: ``cache[b, start[b] : start[b] + T] = new[b]``.

    cache (B, S, ...), new (B, T, ...), start (B,) on the cache's device.
    The start clamps to ``[0, S - T]`` as ``jax.lax.dynamic_update_slice``
    clamps it, so an overhanging write lands on the last T slots instead of
    raising or being dropped.
    """
    B, S = cache.shape[:2]
    T = new.shape[1]
    s0 = start.to(torch.int64).clamp(0, S - T)
    idx = s0[:, None] + torch.arange(T, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    cache[rows, idx] = new.to(cache.dtype)


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
    o = ops.decode_attention(q[:, 0], kc_read, vc, kv_len)
    out = o.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return out.to(p["wo"].dtype) @ p["wo"]


def memory_kv(cfg: ArchConfig, p, mem: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder memory (B, S, d) once into cross-attention K/V, each
    (B, S, Hkv, Dh): no RoPE."""
    B, S, _ = mem.shape
    k = mem @ p["wk"]
    v = mem @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k.reshape(B, S, cfg.n_kv_heads, cfg.d_head), v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)


def cross_attn_prefill(cfg: ArchConfig, p, x: torch.Tensor, mem_kv) -> torch.Tensor:
    """Decoder states (B, T, d) against the memory's K/V: every query sees
    every memory row (no mask, no RoPE), through K4's plain version (the
    reference's ``chunked_mha``; its query chunk bounds memory only);
    returns (B, T, d)."""
    B, T, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, T, cfg.n_heads, cfg.d_head)
    k, v = mem_kv
    o = flash_attention_plain(q, k, v, causal=False)
    return o.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]
