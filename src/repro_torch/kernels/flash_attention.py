"""K4: prefill flash attention with causal / prefix-LM masks and GQA.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
Used by ``calculate_kv`` (``models.attention.attn_prefill``).

Layouts are the model's native token-major ones: ``q (B, Tq, Hq, D)``,
``k``/``v`` ``(B, Tk, Hkv, D)`` -> ``(B, Tq, Hq, D)`` in q's dtype; the
reference moves the head axis before its kernel, the port reads through
strides.  Query ``t`` sits at position ``t + Tk - Tq``; ``causal`` lets it see
keys at or before its position, ``prefix_len (B,)`` additionally opens the
first ``prefix_len[b]`` keys to every query (prefix-LM).

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (see its head
for the bound and the design: bf16 on the tensor cores, f32 on scalar FMAs)
and counts its launches in ``.launches``; ``flash_attention_plain`` is the
same function in PyTorch — the reference's q-chunked ``chunked_mha`` — the
CPU path and the kernel's oracle.  ``flash_attention_magnitude`` is the
scale of the rule the bf16 kernel is held to (``kernels.ops.BF16_TOL``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._build import HEAD_DIMS, aligned16, check, load_library

__all__ = ["flash_attention_plain", "flash_attention_cuda", "flash_attention_magnitude"]

Q_CHUNK = 1024  # queries per step of the plain version: bounds its score matrix
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q, k, v, prefix_len: Optional[torch.Tensor] = None, *, causal: bool = True, scale=None,
):
    """Memory-bounded attention: full Tk per q-chunk, f32 softmax, weights
    cast to v's dtype for the value product (as ``chunked_mha`` does)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k_pos = torch.arange(Tk, device=q.device)
    out = torch.empty((B, Tq, Hq, D), dtype=v.dtype, device=q.device)
    chunk = min(Q_CHUNK, Tq)
    for c0 in range(0, Tq, chunk):
        qc = q[:, c0:c0 + chunk]
        n = qc.shape[1]
        qg = qc.reshape(B, n, Hkv, rep, D)
        s = torch.einsum("bqkrd,btkd->bkrqt", qg, k).to(torch.float32) * scale
        if causal:
            q_pos = c0 + torch.arange(n, device=q.device) + (Tk - Tq)
            mask = k_pos[None, :] <= q_pos[:, None]  # (n, Tk)
            if prefix_len is not None:
                bidir = k_pos[None, None, :] < prefix_len.to(q.device)[:, None, None]
                mask = (mask[None] | bidir)[:, None, None]  # (B,1,1,n,Tk)
            else:
                mask = mask[None, None, None]
            s = torch.where(mask, s, torch.full_like(s, -1e30))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkrqt,btkd->bqkrd", w.to(v.dtype), v)
        out[:, c0:c0 + n] = o.reshape(B, n, Hq, D)
    return out.to(q.dtype)


def flash_attention_magnitude(
    q, k, v, prefix_len: Optional[torch.Tensor] = None, *, causal: bool = True, scale=None,
):
    """``sum_t w_t |v_t|`` per output element, in f32: the plain version over
    ``|v|``.  Rounding each weight ``w_t`` by at most a relative ``u`` moves
    the output by at most ``u`` times this."""
    return flash_attention_plain(q.float(), k.float(), v.float().abs(), prefix_len,
                                 causal=causal, scale=scale)


def flash_attention_cuda(
    q, k, v, prefix_len: Optional[torch.Tensor] = None, *, causal: bool = True, scale=None,
):
    """K4 on the card; same contract as :func:`flash_attention_plain`."""
    B, Tq, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q={q.dtype} k={k.dtype} v={v.dtype} not supported")
    if prefix_len is not None and (
        prefix_len.dtype != torch.int32 or tuple(prefix_len.shape) != (B,)
        or not prefix_len.is_contiguous()
    ):
        raise TypeError("flash_attention: prefix_len must be a contiguous (B,) int32 tensor")
    for t in (q, k, v) + (() if prefix_len is None else (prefix_len,)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: every input must be on one CUDA device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.dtype == torch.bfloat16:
        if not scale > 0:  # the kernel takes each row's max on the unscaled scores
            raise ValueError(f"flash_attention: the bf16 kernel needs a positive scale, not {scale}")
        q, k, v = aligned16(q), aligned16(k), aligned16(v)  # it copies 16-byte row chunks
    out = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=q.device)
    lib = load_library()
    check(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if prefix_len is None else prefix_len.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Tq, Tk, D,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
        int(causal), int(prefix_len is not None), float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
