"""Context-compression baselines: H2O and an LLMLingua-style token pruner.

* ``h2o_select`` — Heavy-Hitter Oracle [131]: keep the tokens with the
  highest cumulative attention scores (plus a recent-token window).  As in
  the paper's evaluation, this is the *idealized* offline variant: the
  attention scores come from the full prefill (the context's own
  self-attention scores, :func:`attention_scores_for_h2o`).

* ``llmlingua_select`` — prompt-compression-style pruning in *text* space:
  drop the tokens whose next-token log-likelihood under the model is highest
  (most predictable = least informative), keeping a target fraction.
  This mirrors LLMLingua's perplexity-based token filtering [67] without the
  budget controller.

Both return kept-token indices; CacheGen composes with them by encoding the
*pruned* KV cache (paper §7.2 "CacheGen on H2O/LLMLingua").  The scores are
computed in f64 on the tensors' device; the selections are host numpy with
the reference's ``np.argsort``, so ties break as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["h2o_select", "llmlingua_select", "attention_scores_for_h2o"]


def attention_scores_for_h2o(kv_k, q_all) -> torch.Tensor:
    """Cumulative causal attention mass per token, averaged over layers and
    heads, in f64 on the inputs' device.

    ``kv_k`` and ``q_all`` are (L, T, H, D) post-rope keys and queries of
    one request."""
    k = torch.as_tensor(kv_k).to(torch.float64)
    q = torch.as_tensor(q_all).to(device=k.device, dtype=torch.float64)
    L, T, H, D = k.shape
    acc = torch.zeros(T, dtype=torch.float64, device=k.device)
    scale = 1.0 / math.sqrt(D)
    future = ~torch.ones((T, T), dtype=torch.bool, device=k.device).tril()
    for l in range(L):
        s = torch.einsum("qhd,khd->hqk", q[l], k[l]) * scale  # (H, Tq, Tk)
        s = s.masked_fill(future, -math.inf)
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        mass = p.sum(dim=1)  # (H, Tk): how much each token is attended
        for h in range(H):
            acc += mass[h]
    return acc / (L * H)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def h2o_select(scores, keep_ratio: float, recent_window: int = 32) -> np.ndarray:
    """Indices (sorted) of tokens kept by the heavy-hitter policy."""
    scores = _np(scores)
    T = scores.shape[0]
    n_keep = max(int(round(T * keep_ratio)), min(T, recent_window))
    keep = set(range(max(0, T - recent_window), T))  # always keep recent
    order = np.argsort(-scores)
    for idx in order:
        if len(keep) >= n_keep:
            break
        keep.add(int(idx))
    return np.asarray(sorted(keep), np.int64)


def llmlingua_select(token_logprobs, keep_ratio: float, protect_last: int = 16) -> np.ndarray:
    """Keep the least-predictable tokens (lowest logprob = most informative)."""
    token_logprobs = _np(token_logprobs)
    T = token_logprobs.shape[0]
    n_keep = max(int(round(T * keep_ratio)), min(T, protect_last))
    keep = set(range(max(0, T - protect_last), T))
    order = np.argsort(token_logprobs)  # ascending: least predictable first
    for idx in order:
        if len(keep) >= n_keep:
            break
        keep.add(int(idx))
    return np.asarray(sorted(keep), np.int64)
