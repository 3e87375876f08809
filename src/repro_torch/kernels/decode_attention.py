"""K3: one-token GQA decode attention against the serving cache.

Replaces ``src/repro/kernels/decode_attention.py:decode_attention_pallas``.
This is the ``generate_with_kv`` hot loop: every generated token runs one
attention pass of a one-token query against the whole cached context.

Layouts: ``q (B, Hq, D)``; ``k``/``v`` in the serving cache's native
``(B, S, Hkv, D)`` layout (a layer slice of ``Caches.kv_k``), read through
strides — the reference moves the head axis first, which here would copy
the whole cache per layer per token.  ``kv_len (B,)`` masks each row to its
first ``kv_len[b]`` positions (clamped to S); a row with ``kv_len == 0``
outputs zeros.  The output has q's dtype.

``decode_attention_cuda`` launches ``csrc/decode_attention.cu`` (tile-wise
split-KV flash-decoding, then a small launch that merges the splits; its
head says what bounds it and how the design answers) and counts one launch
per call in ``.launches``; ``decode_attention_plain`` is the same function
in PyTorch, the CPU path and the kernel's oracle.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels._build import HEAD_DIMS, aligned16, check, load_library

__all__ = ["TILE", "decode_attention_plain", "decode_attention_cuda", "split_size"]

TILE = 64  # cache positions per tile of the kernel
_WAVES = 2  # blocks per SM the split size aims at
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_REP = 16


def decode_attention_plain(q, k, v, kv_len, *, scale=None):
    """f32 scores and softmax; the weights are cast to v's dtype before the
    value product, as the reference's plain decode does (``attention.py``
    ``_decode_mha_plain``)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    ct = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, Hkv, rep, D).to(ct)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k.to(ct)).to(torch.float32) * scale
    valid = torch.arange(S, device=q.device)[None, :] < kv_len.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    w = p / torch.where(l == 0, torch.ones_like(l), l)  # an empty row outputs 0
    o = torch.einsum("bkrs,bskd->bkrd", w.to(v.dtype), v)
    return o.reshape(B, Hq, D).to(q.dtype)


def split_size(S: int, B: int, Hkv: int, n_sm: int) -> int:
    """Cache positions per block of the split-KV pass: a multiple of the tile,
    so that the ``B * Hkv * ceil(S / split)`` blocks fill ``n_sm`` SMs about
    twice (fewer where rows are shorter than S: blocks past ``kv_len`` exit
    at once)."""
    per_row = -(-_WAVES * n_sm // (B * Hkv))  # blocks per (row, KV head)
    per_block = -(-S // per_row)
    return max(TILE, -(-per_block // TILE) * TILE)


@functools.lru_cache(maxsize=None)
def _n_sm(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_attention_cuda(q, k, v, kv_len, *, scale=None):
    """K3 on the card; same contract as :func:`decode_attention_plain`."""
    B, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or Hq // Hkv > _MAX_REP:
        raise ValueError(f"decode_attention: Hq={Hq} must be a multiple of Hkv={Hkv}, at most {_MAX_REP}x")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: dtypes q={q.dtype} k={k.dtype} v={v.dtype} not supported")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,) or not kv_len.is_contiguous():
        raise TypeError("decode_attention: kv_len must be a contiguous (B,) int32 tensor")
    for t in (q, k, v, kv_len):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("decode_attention: every input must be on one CUDA device")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: the head dim must be contiguous")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k, v = aligned16(k), aligned16(v)  # the cache as it is, unless its rows are misaligned
    dev = q.device
    split = split_size(S, B, Hkv, _n_sm(dev.index))
    n_splits = max(1, -(-S // split))
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    # one scratch allocation: (m, l) per (row, query head, split), then the
    # splits' unnormalized accumulators
    part = torch.empty(B * Hq * n_splits * (D + 2), dtype=torch.float32, device=dev)
    lib = load_library()
    check(lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(), part.data_ptr(),
        B, Hq, Hkv, S, D, n_splits,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        split, float(scale), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    ), "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
