"""K1/K2/K5/K6: fused KV delta (de)quantization for the codec.

``kv_dequant_tokens`` (K1) replaces
``src/repro/kernels/kvquant.py:kv_dequant_tokens_pallas`` (lossy levels) and
``kv_lossless_tokens`` (K2) replaces ``kvquant.py:kv_lossless_tokens_pallas``
(level 0).  Both emit whole token groups ``(B, G, g, C)`` — slot 0 the
anchor, slots 1..g-1 anchor + dequantized delta — in the cache's dtype, so
no separate anchor scatter touches device memory afterwards.  The leading
axis B folds (n_chunks, L, 2).

``kv_quant`` (K5) replaces ``kvquant.py:kv_quant_pallas``: the encoder's
delta, divide by the bin, round half to even, clip and bias, from grouped
f32 tokens ``(B, G, g, C)`` to ``(B, G, g-1, C)`` uint16 symbols — the lossy
levels' delta symbols of ``codec.encode_all_levels``.  ``kv_dequant`` (K6)
replaces ``kvquant.py:kv_dequant_pallas``: the delta-only reconstruction
``(d - qmax) * bin + anchor`` that the unfused ``codec.decode_chunk`` runs.

The CUDA kernels live in ``csrc/kvquant.cu`` (see its head for what bounds
them on the H100 and how the design answers it).  All four read and write
V channels at a time; :func:`vector_width` picks V for the tensors at hand
(the most that C, the pointers and one 16-byte store of the output allow),
and any contiguous input runs, a narrower V where it is misaligned.  Each ``*_cuda`` wrapper
checks its inputs, launches, and counts its launches in ``.launches``; each
``*_plain`` function is the same computation in PyTorch — the CPU path and
the kernel's oracle on the card.  ``kernels.ops`` picks between them by the
tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import check, load_library

__all__ = [
    "kv_quant_plain",
    "kv_quant_cuda",
    "kv_dequant_plain",
    "kv_dequant_cuda",
    "kv_dequant_tokens_plain",
    "kv_dequant_tokens_cuda",
    "kv_lossless_tokens_plain",
    "kv_lossless_tokens_cuda",
    "OUT_DTYPES",
    "vector_width",
]

OUT_DTYPES = (torch.float32, torch.bfloat16)


def vector_width(C: int, *tensors: torch.Tensor, out: Optional[torch.Tensor] = None) -> int:
    """The channels the kernels move per access: the largest V in (8, 4, 2, 1)
    that divides C and to whose access width, ``min(16, V * itemsize)``
    bytes, every tensor's base address (``out``'s too) is aligned (each
    access then is, since the kernels step through rows of C elements in
    multiples of V), and at which a thread stores its V elements of ``out``
    in one access of at most 16 bytes: 4 for an f32 output.  On an H100,
    two 16-byte stores a thread to one 32-byte span (V = 8 of f32) held K6
    at 61% of its bound, one 16-byte store (V = 4) reached 84%; K5 reading
    its f32 input in two 16-byte loads ran as fast as in one."""
    widest = 8 if out is None else 16 // out.element_size()
    tensors = tensors if out is None else (*tensors, out)
    for V in (8, 4, 2):
        if V <= widest and C % V == 0 and all(t.data_ptr() % min(16, V * t.element_size()) == 0 for t in tensors):
            return V
    return 1


def _check_inputs(name, d_sym, side, side_name, side_dtype, per_group):
    B, G, gm1, C = d_sym.shape
    want = (B, G, C)
    if d_sym.dtype != torch.uint16 or side.dtype != side_dtype:
        raise TypeError(
            f"{name}: d_sym must be uint16 and {side_name} {side_dtype}, got "
            f"{d_sym.dtype} and {side.dtype}"
        )
    if tuple(side.shape) != want or tuple(per_group.shape[:1]) != (B,):
        raise ValueError(f"{name}: {side_name} {tuple(side.shape)} does not match d_sym {tuple(d_sym.shape)}")
    for t in (d_sym, side, per_group):
        if not t.is_cuda or t.device != d_sym.device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_out_dtype(name, out_dtype):
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")


# ---------------------------------------------------------------------------
# K1: lossy levels
# ---------------------------------------------------------------------------


def kv_dequant_tokens_plain(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """(B, G, g-1, C) delta symbols + (B, G, C) f32 anchors + (B,) bins ->
    (B, G, g, C): ``[anchor; (d - qmax) * bin + anchor]``."""
    others = kv_dequant_plain(d_sym, anchors, bins, qmax=qmax, out_dtype=torch.float32)
    tokens = torch.cat([anchors[:, :, None, :], others], dim=2)
    return tokens.to(out_dtype)


def kv_dequant_tokens_cuda(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """K1 on the card; same contract as :func:`kv_dequant_tokens_plain`."""
    _check_out_dtype("kv_dequant_tokens", out_dtype)
    _check_inputs("kv_dequant_tokens", d_sym, anchors, "anchors", torch.float32, bins)
    if bins.dtype != torch.float32 or bins.ndim != 1:
        raise TypeError("kv_dequant_tokens: bins must be a (B,) float32 tensor")
    B, G, gm1, C = d_sym.shape
    out = torch.empty((B, G, gm1 + 1, C), dtype=out_dtype, device=d_sym.device)
    lib = load_library()
    check(lib.kv_dequant_tokens(
        d_sym.data_ptr(), anchors.data_ptr(), bins.data_ptr(), out.data_ptr(),
        B, G, gm1, C, int(qmax), int(out_dtype == torch.bfloat16), vector_width(C, d_sym, anchors, out=out),
        torch.cuda.current_stream(d_sym.device).cuda_stream,
    ), "kv_dequant_tokens")
    kv_dequant_tokens_cuda.launches += 1
    return out


kv_dequant_tokens_cuda.launches = 0


# ---------------------------------------------------------------------------
# K2: level 0 ("lossless after 8-bit")
# ---------------------------------------------------------------------------


def kv_lossless_tokens_plain(d_sym, a_sym, scales, *, out_dtype=torch.float32):
    """(B, G, g-1, C) integer-delta symbols (bias 254) + (B, G, C) anchor
    symbols (bias 128) + (B, G) scales -> (B, G, g, C): ``(a - 128) * s`` in
    slot 0, ``((d - 254) + (a - 128)) * s`` after it.  Bit-exact in f32 with
    ``quant.lossless_reconstruct``."""
    q_a = a_sym.to(torch.float32) - 128.0
    q_d = d_sym.to(torch.float32) - 254.0
    s = scales.to(torch.float32)[:, :, None]
    anchor = q_a * s
    others = (q_d + q_a[:, :, None, :]) * s[..., None]
    tokens = torch.cat([anchor[:, :, None, :], others], dim=2)
    return tokens.to(out_dtype)


def kv_lossless_tokens_cuda(d_sym, a_sym, scales, *, out_dtype=torch.float32):
    """K2 on the card; same contract (bit for bit) as :func:`kv_lossless_tokens_plain`."""
    _check_out_dtype("kv_lossless_tokens", out_dtype)
    _check_inputs("kv_lossless_tokens", d_sym, a_sym, "a_sym", torch.uint16, scales)
    if scales.dtype != torch.float32 or tuple(scales.shape) != tuple(d_sym.shape[:2]):
        raise TypeError("kv_lossless_tokens: scales must be a (B, G) float32 tensor")
    B, G, gm1, C = d_sym.shape
    out = torch.empty((B, G, gm1 + 1, C), dtype=out_dtype, device=d_sym.device)
    lib = load_library()
    check(lib.kv_lossless_tokens(
        d_sym.data_ptr(), a_sym.data_ptr(), scales.data_ptr(), out.data_ptr(),
        B, G, gm1, C, int(out_dtype == torch.bfloat16), vector_width(C, d_sym, a_sym, out=out),
        torch.cuda.current_stream(d_sym.device).cuda_stream,
    ), "kv_lossless_tokens")
    kv_lossless_tokens_cuda.launches += 1
    return out


kv_lossless_tokens_cuda.launches = 0


# ---------------------------------------------------------------------------
# K5: encode-side delta quantization
# ---------------------------------------------------------------------------


def kv_quant_plain(kv_grouped, bins, *, qmax: int):
    """(B, G, g, C) f32 grouped tokens + (B,) bins -> (B, G, g-1, C) uint16:
    ``clip(round((x[:, :, j] - x[:, :, 0]) / bin), -qmax, qmax) + qmax``,
    rounding half to even (``torch.round``, as ``jnp.round``)."""
    anchor = kv_grouped[:, :, :1, :]
    delta = kv_grouped[:, :, 1:, :] - anchor
    q = torch.clamp(torch.round(delta / bins[:, None, None, None]), -qmax, qmax) + qmax
    return q.to(torch.int32).to(torch.uint16)


def kv_quant_cuda(kv_grouped, bins, *, qmax: int):
    """K5 on the card; same contract (bit for bit) as :func:`kv_quant_plain`."""
    if kv_grouped.dtype != torch.float32 or bins.dtype != torch.float32:
        raise TypeError(f"kv_quant: kv and bins must be float32, got {kv_grouped.dtype} and {bins.dtype}")
    if kv_grouped.ndim != 4 or kv_grouped.shape[2] < 1 or tuple(bins.shape) != (kv_grouped.shape[0],):
        raise ValueError(f"kv_quant: kv {tuple(kv_grouped.shape)} and bins {tuple(bins.shape)} "
                         "do not form (B, G, g, C) and (B,)")
    for t in (kv_grouped, bins):
        if not t.is_cuda or t.device != kv_grouped.device:
            raise ValueError("kv_quant: every input must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kv_quant: inputs must be contiguous")
    B, G, g, C = kv_grouped.shape
    out = torch.empty((B, G, g - 1, C), dtype=torch.uint16, device=kv_grouped.device)
    check(load_library().kv_quant(
        kv_grouped.data_ptr(), bins.data_ptr(), out.data_ptr(), B, G, g - 1, C, int(qmax),
        vector_width(C, kv_grouped, out=out), torch.cuda.current_stream(kv_grouped.device).cuda_stream,
    ), "kv_quant")
    kv_quant_cuda.launches += 1
    return out


kv_quant_cuda.launches = 0


# ---------------------------------------------------------------------------
# K6: delta-only reconstruction
# ---------------------------------------------------------------------------


def kv_dequant_plain(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """(B, G, g-1, C) delta symbols + (B, G, C) f32 anchors + (B,) bins ->
    (B, G, g-1, C): ``(d - qmax) * bin + anchor``, a multiply and an add
    each rounded in f32."""
    d = d_sym.to(torch.float32) - float(qmax)
    return (d * bins[:, None, None, None] + anchors[:, :, None, :]).to(out_dtype)


def kv_dequant_cuda(d_sym, anchors, bins, *, qmax: int, out_dtype=torch.bfloat16):
    """K6 on the card; same contract (bit for bit) as :func:`kv_dequant_plain`."""
    _check_out_dtype("kv_dequant", out_dtype)
    _check_inputs("kv_dequant", d_sym, anchors, "anchors", torch.float32, bins)
    if bins.dtype != torch.float32 or bins.ndim != 1:
        raise TypeError("kv_dequant: bins must be a (B,) float32 tensor")
    B, G, gm1, C = d_sym.shape
    out = torch.empty((B, G, gm1, C), dtype=out_dtype, device=d_sym.device)
    check(load_library().kv_dequant(
        d_sym.data_ptr(), anchors.data_ptr(), bins.data_ptr(), out.data_ptr(),
        B, G, gm1, C, int(qmax), int(out_dtype == torch.bfloat16), vector_width(C, d_sym, anchors, out=out),
        torch.cuda.current_stream(d_sym.device).cuda_stream,
    ), "kv_dequant")
    kv_dequant_cuda.launches += 1
    return out


kv_dequant_cuda.launches = 0
