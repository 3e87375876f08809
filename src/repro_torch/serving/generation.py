"""Continuous batched generation: output tokens join the serving engine.

The paper stops at TTFT — once the context's KV cache is loaded, CacheGen's
pipeline ends.  Production serving doesn't: the loaded cache exists to be
*decoded against*.  This module holds the per-session generation state that
lets a completed context load transition into a *generating* state on the
same shared :class:`~repro_torch.serving.engine.Engine` row instead of exiting.
Host-side and numpy only: the scheduler hands each step's logits over as
numpy (one ``.float().cpu().numpy()`` per stacked step, the reference's own
host sync), so greedy and seeded-sampling picks draw exactly as the
reference's do.

Split of responsibilities:

* :class:`GenerationSpec` — what the caller asked for: how many output
  tokens, the first input token (the argmax of the context prefill's last
  logits, i.e. the token the TTFT measurement produced), an optional
  per-output-token latency SLO, and an optional sampling seed (``None``
  means greedy argmax, which is what keeps continuous generation
  bit-identical to the ``Engine.generate_with_kv`` oracle).
* :class:`GenerationTask` — the scheduler-side state machine for one
  generating session: current input token, emitted tokens + their virtual
  timestamps, the cache row it occupies, and the virtual instant it is next
  ready to take a decode step.  The scheduler stacks every ready task into
  one ``Engine.decode_step_rows`` dispatch per step.

Suspension is lossless and bit-exact: a generating row snapshots through the
same ``kv_layout.RowSnapshot`` path as a loading row (the snapshot spans
context + emitted tokens), and ``current_token`` carries the next input
host-side, so a preempted generation resumes mid-stream with token-identical
output.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["GenerationSpec", "GenerationTask"]


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    """What to generate once a session's context load completes.

    ``n_tokens == 0`` (or a ``None`` spec on the request) means load-only —
    the session exits at TTFT exactly as before this subsystem existed.
    ``first_token`` is the first decode input: by convention the argmax of
    the context prefill's last-position logits, which the serving loader
    already produces as its TTFT artifact.  ``sample_seed=None`` selects
    greedy argmax decoding; an integer seed selects deterministic softmax
    sampling (seeded per request, so runs reproduce bit-for-bit).
    """

    n_tokens: int
    first_token: int
    gen_slo_s: Optional[float] = None  # per-output-token latency SLO (TPOT)
    sample_seed: Optional[int] = None  # None = greedy (oracle-identical)

    def __post_init__(self):
        if self.n_tokens < 0:
            raise ValueError(f"GenerationSpec: n_tokens {self.n_tokens} < 0")
        if self.gen_slo_s is not None and self.gen_slo_s <= 0:
            raise ValueError(f"GenerationSpec: gen_slo_s {self.gen_slo_s} <= 0")


class GenerationTask:
    """One session's generation-in-progress on a shared engine row.

    Tracks the host-side decode state: the next input token, the tokens
    emitted so far with their virtual emission times, and ``ready_t`` — the
    virtual instant this task can next participate in a stacked decode
    step.  ``cache_tokens`` (context + emitted) is the row's realized
    length: it is what ``Engine.save_row`` snapshots on preemption and what
    capacity validation checks against.
    """

    def __init__(
        self,
        spec: GenerationSpec,
        *,
        index: int,
        label: str,
        row: int,
        start_t: float,
        context_tokens: int,
        capacity: int,
    ):
        if context_tokens + spec.n_tokens > capacity:
            raise ValueError(
                f"generation for request {label!r}: {context_tokens} context "
                f"+ {spec.n_tokens} output tokens exceeds cache capacity "
                f"{capacity} — every generated token needs a KV slot"
            )
        self.spec = spec
        self.index = index
        self.label = label
        self.row = row
        self.start_t = float(start_t)
        self.ready_t = float(start_t)
        self.context_tokens = int(context_tokens)
        self.current_token = int(spec.first_token)
        self.tokens_out: List[int] = []
        self.token_ts: List[float] = []
        # gen-SLO enforcement (per-token): realized TPOT over the SLO bumps
        # slo_misses; tokens_since_resume gates preemption eligibility so a
        # freshly resumed task is not re-evicted for its pre-suspension
        # misses before it takes a single step
        self.slo_misses = 0
        self.tokens_since_resume = 0
        self._rng = (
            None
            if spec.sample_seed is None
            else np.random.default_rng(spec.sample_seed + index)
        )

    # ------------------------------------------------------------------

    @property
    def done(self) -> bool:
        return len(self.tokens_out) >= self.spec.n_tokens

    @property
    def realized_tokens(self) -> int:
        """Row tokens realized so far: context prefix + emitted output."""
        return self.context_tokens + len(self.tokens_out)

    def next_token(self, logits_row: np.ndarray) -> int:
        """Pick the next token from this row's last-position logits.

        Greedy argmax unless the spec carries a sampling seed, in which
        case a seeded host-side softmax sample (float64 for stable
        normalization across platforms).
        """
        if self._rng is None:
            return int(np.argmax(logits_row))
        z = np.asarray(logits_row, np.float64)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(p.shape[0], p=p))

    @property
    def slo_missed(self) -> bool:
        """Whether any emitted token's realized TPOT exceeded the spec's
        per-token SLO (suspension time between tokens included — queueing
        is latency the caller observed)."""
        return self.slo_misses > 0

    def record(self, token: int, emit_t: float) -> None:
        """Commit one emitted token: it becomes the next decode input.

        When the spec carries a ``gen_slo_s``, the token's realized TPOT —
        emission minus the previous emission (or the generation start for
        the first token), so suspension gaps count — is checked against it
        and misses accumulate in ``slo_misses``.
        """
        prev_t = self.token_ts[-1] if self.token_ts else self.start_t
        self.tokens_out.append(int(token))
        self.token_ts.append(float(emit_t))
        self.current_token = int(token)
        self.ready_t = float(emit_t)
        self.tokens_since_resume += 1
        if self.spec.gen_slo_s is not None and (
            float(emit_t) - prev_t > self.spec.gen_slo_s
        ):
            self.slo_misses += 1

    # ------------------------------------------------------------------
    # Preemption (row suspends via the engine's bit-exact RowSnapshot path)
    # ------------------------------------------------------------------

    def suspend(self, now_t: float) -> None:
        """Leave the engine: the row snapshot (taken by the scheduler) holds
        context + emitted KV; ``current_token`` carries the next input."""
        if self.done:
            raise ValueError(
                f"suspending generation for request {self.label!r}: "
                f"already emitted all {self.spec.n_tokens} tokens"
            )
        self.row = -1
        self.ready_t = float(now_t)

    def resume(self, row: int, resume_t: float) -> None:
        """Rejoin the engine on ``row`` (possibly a different one): the
        restored snapshot reads exactly as at suspension, so decoding
        continues bit-exactly from ``current_token``."""
        self.row = int(row)
        self.ready_t = float(resume_t)
        self.tokens_since_resume = 0
