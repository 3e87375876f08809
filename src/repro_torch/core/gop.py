"""Token-group ("group of pictures") structure for KV delta coding.

CacheGen §5.2: the context is split into groups of ``group_size`` contiguous
tokens.  The first token of each group is the *anchor*; every other token in
the group is represented by its *delta tensor* against the anchor.  Groups
never span chunk boundaries, which is what makes chunks independently
decodable (§5.3).

All functions here are shape-polymorphic over leading axes: KV tensors are
laid out ``(..., T, C)`` with ``T`` the token axis and ``C`` the flattened
channel axis (kv_heads * head_dim).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "GroupLayout",
    "make_layout",
    "split_anchors_deltas",
    "merge_anchors_deltas",
]


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Static description of the anchor/delta structure of one chunk."""

    n_tokens: int
    group_size: int

    @property
    def n_groups(self) -> int:
        return -(-self.n_tokens // self.group_size)

    @property
    def n_anchors(self) -> int:
        return self.n_groups

    @property
    def n_deltas(self) -> int:
        return self.n_tokens - self.n_anchors

    @property
    def anchor_positions(self) -> np.ndarray:
        return np.arange(self.n_groups) * self.group_size

    @property
    def delta_positions(self) -> np.ndarray:
        pos = np.arange(self.n_tokens)
        return pos[pos % self.group_size != 0]

    @property
    def delta_group_index(self) -> np.ndarray:
        """For each delta token, the index of its group (= its anchor)."""
        return self.delta_positions // self.group_size

    @property
    def token_group_index(self) -> np.ndarray:
        return np.arange(self.n_tokens) // self.group_size


def make_layout(n_tokens: int, group_size: int) -> GroupLayout:
    if n_tokens <= 0:
        raise ValueError(f"n_tokens must be positive, got {n_tokens}")
    if group_size <= 0:
        raise ValueError(f"group_size must be positive, got {group_size}")
    return GroupLayout(n_tokens=n_tokens, group_size=group_size)


def _index(positions: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(positions, dtype=torch.long, device=like.device)


def split_anchors_deltas(
    kv: torch.Tensor, layout: GroupLayout
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``(..., T, C)`` into anchors ``(..., G, C)`` and deltas.

    Deltas are ``x_t - x_anchor(t)`` for every non-anchor token, in token
    order: shape ``(..., T - G, C)``.
    """
    anchors = kv.index_select(-2, _index(layout.anchor_positions, kv))
    others = kv.index_select(-2, _index(layout.delta_positions, kv))
    deltas = others - anchors.index_select(-2, _index(layout.delta_group_index, kv))
    return anchors, deltas


def merge_anchors_deltas(
    anchors: torch.Tensor, deltas: torch.Tensor, layout: GroupLayout
) -> torch.Tensor:
    """Inverse of :func:`split_anchors_deltas` (up to quantization error)."""
    others = deltas + anchors.index_select(-2, _index(layout.delta_group_index, anchors))
    out_shape = anchors.shape[:-2] + (layout.n_tokens,) + anchors.shape[-1:]
    out = anchors.new_zeros(out_shape)
    out[..., _index(layout.anchor_positions, anchors), :] = anchors
    out[..., _index(layout.delta_positions, anchors), :] = others
    return out
