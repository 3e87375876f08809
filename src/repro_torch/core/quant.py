"""Quantization for the CacheGen KV codec.

Implements the paper's §5.2 quantization stage:

* **Anchors** (first token of each group) are kept at high precision:
  8-bit *vectorwise* quantization (per-anchor-token absmax over the channel
  vector), following LLM.int8-style vectorwise scaling.
* **Deltas** are quantized with *layer-group bin widths*: the transformer
  layers are split into three equal groups and the bin width grows from the
  earliest group to the last (paper §C.2 defaults 0.5 / 1.0 / 1.5), reflecting
  Insight 2 (early layers are more loss-sensitive).  The streaming *encoding
  level* scales all three bins by ``level_mult``.  The deltas' quantization
  and reconstruction are the kernels K5/K6 (``kernels.ops.kv_quant`` /
  ``kv_dequant``); this module gives their bins (:func:`effective_bins`).
* **Level 0 ("lossless-after-8bit")** reproduces the paper's lossless result:
  the KV is 8-bit quantized with a shared per-(layer, kv, group) scale and the
  *integer* symbol deltas are entropy coded — reconstruction is bit-exact with
  respect to the 8-bit quantization.

KV tensors are ``(L, 2, T, C)`` float32: layers × {K,V} × tokens × channels.
Symbols are held as ``int32`` tensors (the wire stores them as ``uint16``):
PyTorch has no arithmetic on ``uint16``.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so symbols match the reference exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import gop

__all__ = [
    "ANCHOR_ALPHABET",
    "lossless_delta_alphabet",
    "delta_alphabet",
    "layer_group_ids",
    "effective_bins",
    "quantize_anchors",
    "dequantize_anchors",
    "lossless_quantize",
    "lossless_reconstruct",
]

ANCHOR_ALPHABET = 256  # 8-bit anchors / 8-bit lossless base symbols


def delta_alphabet(qmax: int) -> int:
    return 2 * qmax + 1


def lossless_delta_alphabet() -> int:
    # int8 symbols are in [-127, 127]; integer deltas span [-254, 254].
    return 2 * 254 + 1


def layer_group_ids(n_layers: int, n_groups: int = 3) -> np.ndarray:
    """Paper §5.2: split layers into three equal-distance groups."""
    edges = np.linspace(0, n_layers, n_groups + 1)
    ids = np.searchsorted(edges[1:-1], np.arange(n_layers), side="right")
    return ids.astype(np.int32)


def effective_bins(
    n_layers: int,
    layer_group_bins: Tuple[float, float, float],
    level_mult: float,
    delta_scale: np.ndarray | None = None,
) -> np.ndarray:
    """Per-(layer, kv) effective bin width, shape (L, 2) float32.

    ``delta_scale`` is an optional per-(layer, kv) calibration (std of deltas
    measured offline) making the paper's absolute bin widths model-agnostic;
    ``None`` means raw value space (paper default).
    """
    gids = layer_group_ids(n_layers)
    base = np.asarray(layer_group_bins, dtype=np.float32)[gids]  # (L,)
    bins = np.broadcast_to(base[:, None], (n_layers, 2)).astype(np.float32)
    bins = bins * np.float32(level_mult)
    if delta_scale is not None:
        bins = bins * np.asarray(delta_scale, dtype=np.float32)
    return np.ascontiguousarray(bins)


def _wire_scale(scale: torch.Tensor) -> torch.Tensor:
    # Round to the wire precision (f16) *before* quantizing so that the
    # decoder, which only sees f16 scales, reconstructs exactly.
    return scale.to(torch.float16).to(torch.float32)


# ---------------------------------------------------------------------------
# Lossy path: 8-bit vectorwise anchors
# ---------------------------------------------------------------------------


def quantize_anchors(anchors: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorwise 8-bit quantization of anchor tokens.

    anchors: (L, 2, G, C) f32 -> symbols (L, 2, G, C) int32 in [1, 256),
    scales (L, 2, G) f32.
    """
    absmax = anchors.abs().amax(dim=-1)  # (L, 2, G)
    scale = _wire_scale(torch.clamp_min(absmax / 127.0, 1e-7))
    q = torch.clamp(torch.round(anchors / scale[..., None]), -127, 127)
    return (q + 128).to(torch.int32), scale


def dequantize_anchors(symbols: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    q = symbols.to(torch.float32) - 128.0
    return q * scales[..., None]


# ---------------------------------------------------------------------------
# Level 0: lossless after 8-bit quantization
# ---------------------------------------------------------------------------


def lossless_quantize(
    kv: torch.Tensor, layout: gop.GroupLayout
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """8-bit quantize with per-(layer, kv, group) shared scale, then take
    integer deltas within each group.

    Returns (anchor_symbols (L,2,G,C) int32 in [1,255],
             delta_symbols (L,2,T-G,C) int32 in [0, 509),
             scales (L,2,G) f32).
    Reconstruction via :func:`lossless_reconstruct` is bit-exact w.r.t. the
    8-bit quantization.
    """
    L, two, T, C = kv.shape
    dev = kv.device
    g_of_t = torch.as_tensor(layout.token_group_index, dtype=torch.long, device=dev)
    # per-group absmax over tokens-in-group x channels: a segment max from
    # zeros (every absmax is >= 0)
    absmax_tok = kv.abs().amax(dim=-1)  # (L,2,T)
    seg = kv.new_zeros((L, two, layout.n_groups))
    seg.scatter_reduce_(-1, g_of_t.expand(L, two, T), absmax_tok, "amax")
    scale = _wire_scale(torch.clamp_min(seg / 127.0, 1e-7))  # (L,2,G)
    scale_t = scale.index_select(-1, g_of_t)  # (L,2,T)
    q = torch.clamp(torch.round(kv / scale_t[..., None]), -127, 127).to(torch.int32)
    a_pos = torch.as_tensor(layout.anchor_positions, dtype=torch.long, device=dev)
    d_pos = torch.as_tensor(layout.delta_positions, dtype=torch.long, device=dev)
    g_idx = torch.as_tensor(layout.delta_group_index, dtype=torch.long, device=dev)
    q_anchor = q.index_select(-2, a_pos)  # (L,2,G,C)
    q_delta = q.index_select(-2, d_pos) - q_anchor.index_select(-2, g_idx)
    return q_anchor + 128, q_delta + 254, scale


def lossless_reconstruct(
    anchor_symbols: torch.Tensor,
    delta_symbols: torch.Tensor,
    scales: torch.Tensor,
    layout: gop.GroupLayout,
) -> torch.Tensor:
    """Exact inverse of :func:`lossless_quantize` back to dequantized floats."""
    dev = anchor_symbols.device
    q_anchor = anchor_symbols.to(torch.int32) - 128
    g_idx = torch.as_tensor(layout.delta_group_index, dtype=torch.long, device=dev)
    q_delta = delta_symbols.to(torch.int32) - 254
    q_other = q_delta + q_anchor.index_select(-2, g_idx)
    L, two, G, C = q_anchor.shape
    q = torch.zeros((L, two, layout.n_tokens, C), dtype=torch.int32, device=dev)
    q[..., torch.as_tensor(layout.anchor_positions, device=dev), :] = q_anchor
    q[..., torch.as_tensor(layout.delta_positions, device=dev), :] = q_other
    g_of_t = torch.as_tensor(layout.token_group_index, dtype=torch.long, device=dev)
    scale_t = scales.index_select(-1, g_of_t)  # (L,2,T)
    return q.to(torch.float32) * scale_t[..., None]
