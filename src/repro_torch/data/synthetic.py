"""Synthetic data substrate.

Two generators:

* :class:`MarkovLM` — a sparse order-1 Markov "language" with Zipfian branch
  probabilities.  Low entropy -> a tiny transformer learns real structure in
  a few hundred steps, which matters because the KV-codec claims (token-wise
  locality, channel-grouped entropy) are properties of *trained* models'
  caches.

* :class:`TopicRetrievalTask` — the LongChat-style probe ("What was the
  first topic we discussed?"): a long context containing topic segments,
  each introduced by a distinctive marker n-gram; the query asks for the
  first topic and accuracy = exact retrieval of the topic id token.  Context
  lengths are drawn to match the paper's Table 2 distributions (median /
  std / P95 per dataset preset).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["MarkovLM", "TopicRetrievalTask", "TABLE2_PRESETS", "sample_lengths"]

# Paper Table 2 context-length stats (median, std, p95) in tokens.
TABLE2_PRESETS: Dict[str, Tuple[float, float, float]] = {
    "longchat": (9400, 164, 9600),
    "triviaqa": (9300, 4497, 15000),
    "narrativeqa": (14000, 1916, 15000),
    "wikitext": (5900, 4548, 14800),
}


def sample_lengths(
    rng: np.random.Generator, preset: str, n: int, scale: float = 1.0
) -> np.ndarray:
    """Draw context lengths matching a Table 2 preset (optionally scaled
    down for CPU-sized experiments, preserving shape)."""
    med, std, p95 = TABLE2_PRESETS[preset]
    raw = rng.normal(med, std, size=n)
    raw = np.clip(raw, med - 2 * std, p95 * 1.02)
    return np.maximum((raw * scale).astype(np.int64), 16)


@dataclasses.dataclass
class MarkovLM:
    vocab_size: int
    branching: int = 8
    zipf_a: float = 1.3
    stickiness: float = 0.0  # P(repeat previous token) — local coherence,
    # mirroring natural text's burstiness (matters for KV token locality)
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, B = self.vocab_size, self.branching
        self.successors = rng.integers(0, V, size=(V, B))
        p = (1.0 / np.arange(1, B + 1) ** self.zipf_a)
        self.probs = p / p.sum()

    def sample(self, rng: np.random.Generator, n_tokens: int, start: Optional[int] = None) -> np.ndarray:
        out = np.empty(n_tokens, dtype=np.int32)
        tok = int(rng.integers(0, self.vocab_size)) if start is None else start
        branch = rng.choice(self.branching, size=n_tokens, p=self.probs)
        stay = (
            rng.uniform(size=n_tokens) < self.stickiness
            if self.stickiness > 0
            else np.zeros(n_tokens, bool)
        )
        for i in range(n_tokens):
            if not stay[i]:
                tok = int(self.successors[tok, branch[i]])
            out[i] = tok
        return out

    def batches(
        self, rng: np.random.Generator, batch: int, seq: int
    ) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            toks = np.stack([self.sample(rng, seq + 1) for _ in range(batch)])
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class TopicRetrievalTask:
    """LongChat-style first-topic retrieval over a synthetic language."""

    lm: MarkovLM
    n_topics: int = 8
    topic_span: int = 3  # marker + topic-id + marker2
    query_len: int = 4

    def __post_init__(self):
        V = self.lm.vocab_size
        # reserve the top of the vocab for markers / topic ids / query tokens
        self.marker = V - 1
        self.query_start = V - 2
        self.topic_ids = np.arange(V - 2 - self.n_topics, V - 2)

    def make_context(
        self, rng: np.random.Generator, n_tokens: int
    ) -> Tuple[np.ndarray, int]:
        """Returns (context tokens (n_tokens,), first_topic_id)."""
        n_seg = self.n_topics
        seg_len = max((n_tokens - self.query_len) // n_seg, self.topic_span + 4)
        topics = rng.permutation(self.topic_ids)[:n_seg]
        parts: List[np.ndarray] = []
        for t in topics:
            filler = self.lm.sample(rng, seg_len - self.topic_span)
            parts.append(np.array([self.marker, t, self.marker], dtype=np.int32))
            parts.append(filler)
        ctx = np.concatenate(parts)
        need = n_tokens - self.query_len
        if ctx.shape[0] < need:  # segment rounding shortfall -> pad with filler
            ctx = np.concatenate([ctx, self.lm.sample(rng, need - ctx.shape[0])])
        ctx = ctx[:need]
        query = np.full(self.query_len, self.query_start, dtype=np.int32)
        return np.concatenate([ctx, query]).astype(np.int32), int(topics[0])

    def training_batches(
        self, rng: np.random.Generator, batch: int, seq: int
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Mixed LM + retrieval batches: the answer token follows the query."""
        while True:
            toks = np.empty((batch, seq + 1), np.int32)
            for b in range(batch):
                ctx, topic = self.make_context(rng, seq)
                toks[b, :-1] = ctx
                toks[b, -1] = topic
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def answer_of(self, tokens: np.ndarray) -> int:
        """Ground truth for a generated context (first topic id)."""
        idx = np.argmax(tokens == self.marker)
        return int(tokens[idx + 1])
