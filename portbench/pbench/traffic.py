"""The one traffic generator: a mix is a JSON file of parameters under
``portbench/traffic/``, read by :class:`Traffic`, and :class:`Draw` makes
every input of a run from ``--seed``.

A mix is a closed loop of ``clients`` clients served in waves.  The pool
holds ``pool`` contexts whose lengths are spread evenly over
``[min, max]`` in steps of ``step`` tokens, the same lengths for every
seed; the seed draws their tokens.  Each wave sends every pool context
``clients / pool`` times, in an order drawn from the seed, and gives its
requests the levels of ``levels`` (level -> requests a wave), also in an
order drawn from the seed, and a fresh question of ``question_tokens``
tokens.  Every wave thus does the same amount of work on every seed; the
seed changes which context meets which level, and the tokens.

The token source is a frozen copy of the program's ``MarkovLM``
(``repro_torch/data/synthetic.py``): a sparse order-1 Markov language with
Zipfian branch probabilities.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["MarkovLM", "Traffic", "Draw", "Request"]

# SeedSequence streams of one seed: the language, the pool, each wave
_LANGUAGE, _POOL, _WAVE = 0, 1, 2


class MarkovLM:
    """Frozen copy of ``repro_torch.data.synthetic.MarkovLM.sample``."""

    def __init__(self, vocab_size: int, branching: int = 8, zipf_a: float = 1.3, seed=0):
        rng = np.random.default_rng(seed)
        self.vocab_size, self.branching = int(vocab_size), int(branching)
        self.successors = rng.integers(0, vocab_size, size=(vocab_size, branching))
        p = 1.0 / np.arange(1, branching + 1) ** zipf_a
        self.probs = p / p.sum()

    def sample(self, rng: np.random.Generator, n_tokens: int) -> np.ndarray:
        out = np.empty(n_tokens, dtype=np.int32)
        tok = int(rng.integers(0, self.vocab_size))
        branch = rng.choice(self.branching, size=n_tokens, p=self.probs)
        succ = self.successors
        for i in range(n_tokens):
            tok = int(succ[tok, branch[i]])
            out[i] = tok
        return out


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    clients: int
    pool: int
    ctx_min: int
    ctx_max: int
    ctx_step: int
    chunk_tokens: int
    levels: Dict[int, int]  # level -> requests of that level in every wave
    question_tokens: int
    answer_tokens: int
    calibration_tokens: int
    branching: int = 8
    zipf_a: float = 1.3

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        ctx = d["context_tokens"]
        lm = d.get("markov", {})
        t = cls(
            name=d["name"], clients=int(d["clients"]), pool=int(d["pool"]),
            ctx_min=int(ctx["min"]), ctx_max=int(ctx["max"]), ctx_step=int(ctx["step"]),
            chunk_tokens=int(d["chunk_tokens"]),
            levels={int(k): int(v) for k, v in d["levels"].items()},
            question_tokens=int(d["question_tokens"]), answer_tokens=int(d["answer_tokens"]),
            calibration_tokens=int(d["calibration_tokens"]),
            branching=int(lm.get("branching", 8)), zipf_a=float(lm.get("zipf_a", 1.3)),
        )
        t.validate()
        return t

    @classmethod
    def load(cls, path) -> "Traffic":
        return cls.from_dict(json.loads(Path(path).read_text()))

    def validate(self) -> None:
        if self.clients % self.pool:
            raise ValueError(f"traffic {self.name}: {self.clients} clients is no whole number of pools of {self.pool}")
        if sum(self.levels.values()) != self.clients:
            raise ValueError(f"traffic {self.name}: levels {self.levels} do not add up to {self.clients} clients")
        if not (0 < self.ctx_min <= self.ctx_max) or (self.ctx_max - self.ctx_min) % self.ctx_step:
            raise ValueError(f"traffic {self.name}: context range {self.ctx_min}..{self.ctx_max} step {self.ctx_step}")
        if self.calibration_tokens > self.ctx_min:
            raise ValueError(f"traffic {self.name}: calibration of {self.calibration_tokens} tokens "
                             f"exceeds the shortest context")
        if self.answer_tokens < 1 or self.question_tokens < 1:
            raise ValueError(f"traffic {self.name}: questions and answers need a token at least")

    @property
    def pool_lengths(self) -> List[int]:
        """Context lengths of the pool, evenly over the range in whole steps."""
        n_steps = (self.ctx_max - self.ctx_min) // self.ctx_step
        if self.pool == 1:
            return [self.ctx_min]
        return [self.ctx_min + self.ctx_step * round(i * n_steps / (self.pool - 1)) for i in range(self.pool)]

    @property
    def level_list(self) -> List[int]:
        return sorted(lvl for lvl, n in self.levels.items() for _ in range(n))

    def capacity(self) -> int:
        """Cache positions a request needs: its context, question and answer,
        and 32 of slack (as the program's launcher sizes its cache)."""
        return self.ctx_max + self.question_tokens + self.answer_tokens + 32


@dataclasses.dataclass
class Request:
    ctx: int  # pool index
    level: int
    question: np.ndarray  # (question_tokens,) int32
    served: Optional[List[int]] = None  # answer tokens as the program served them


class Draw:
    """Everything a run draws from its seed: the pool's tokens and, wave by
    wave, the requests."""

    def __init__(self, traffic: Traffic, vocab_size: int, seed: int):
        self.traffic = traffic
        self.seed = int(seed) % (1 << 64)
        self.lm = MarkovLM(vocab_size, traffic.branching, traffic.zipf_a,
                           seed=np.random.SeedSequence([self.seed, _LANGUAGE]))
        rng = np.random.default_rng([self.seed, _POOL])
        self.pool_tokens = [self.lm.sample(rng, n) for n in traffic.pool_lengths]

    def wave(self, index: int) -> List[Request]:
        t = self.traffic
        rng = np.random.default_rng([self.seed, _WAVE, index])
        ctxs = rng.permutation(np.repeat(np.arange(t.pool), t.clients // t.pool))
        levels = rng.permutation(np.array(t.level_list))
        return [Request(int(c), int(l), self.lm.sample(rng, t.question_tokens)) for c, l in zip(ctxs, levels)]
