"""How a run's ``correct`` is decided: what the timed path produced, held
against the plain reference (``reference.py``) computed again from the same
weights and tokens.

The window's last waves are judged (how many: the cell's ``check.waves``;
their rows' landed KV is kept as the program left it).  Two numbers, each
against the cell's limit:

* ``kv_off``, the load: every judged row's landed KV (positions ``[0, T)``
  of its cache row, which the question and the answer leave as the load
  wrote them) against the reference's lossy transform of the context's
  float32 KV at the request's level.  A value is off when it lies further
  from the reference's than one and a half times the move of one symbol
  (``reference.lossy_kv``'s step) and the bf16 rounding of the value.  The
  share of values off, per (row, layer, K or V), the largest.  bf16 and
  float32 KV differ before quantization by about one 8-bit step of an
  anchor, so single symbols often differ and are let pass; a wrong row,
  chunk, level or reconstruction moves most values by far more, and so
  does float8 before quantization.  ``kv_off_early``: the same over the
  first quarter of the layers.
* ``kv_off_stored``, the load alone on every layer: the same share, with
  the reference's lossy transform (and its calibration) applied to the
  context KV that the program computed and stored at set-up (``stored``),
  so that the stages before the store (the program's ``calculate_kv``) do
  not enter: store, fetch, unpack, K7, K1 or K2 and the insert.  The
  reference follows the program here from the program's own state; the
  stage this skips is held by ``kv_off`` or ``kv_off_early``.
* ``gap``, the answers: each judged wave's served tokens, judged by the
  reference's logits at their positions, the question and the earlier
  served tokens fed on top of the rows' landed KV as the program left it
  (the load, checked by ``kv_off`` on its own, is the start of this stage):
  the reference's best logit less the served token's, over the standard
  deviation of the reference's logits there; the largest.  The question's
  logits give the first token, the stacked decode steps the others; the
  question's MoE call holds all the wave's rows, as the program's does.

The control (``control=True``) puts the reference computed in float8 in
the program's place: its own lossy KV (from its own float8 context KV and
calibration) as the landed KV, and at each position of the same prompts,
served tokens and landed KV the token it puts first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pbench.reference import CodecSpec, Reference, calibrate_delta_scale, lossy_kv

__all__ = ["Landed", "judge"]

BF16_ROUND = 2.0 ** -8  # two bf16 half-ulps of a value
STEPS = 1.5  # symbol moves a landed value may lie from the reference's


@dataclasses.dataclass
class Landed:
    ctx: int
    level: int
    kv: torch.Tensor  # (L, 2, T, C) as the program's cache row holds it


class _Side:
    """One side's calibration and lossy transform (float32 or float8), of
    the context KVs it works out one context at a time (``exact``), so that
    a long pool fits beside the weights, or of the program's ``stored``
    ones."""

    def __init__(self, ref: Reference, pool_tokens, traffic, spec: CodecSpec, stored=None):
        self.ref, self.traffic, self.spec, self.pool, self.stored = ref, traffic, spec, pool_tokens, stored
        first = ref.context_kv(pool_tokens[0]) if stored is None else self._load(0)
        self.delta_scale = calibrate_delta_scale(first[:, :, :traffic.calibration_tokens], spec.group_size)
        self.bins = {lvl: torch.as_tensor(spec.bins(ref.L, lvl, self.delta_scale), device=ref.dev)
                     for lvl in range(1, len(spec.level_mults) + 1)}
        self._held = (0, first)

    def _load(self, ctx: int) -> torch.Tensor:
        return self.stored[ctx].to(self.ref.dev, torch.float32)

    def exact(self, ctx: int) -> torch.Tensor:
        if self._held[0] != ctx:
            self._held = (ctx, None)
            self._held = (ctx, self.ref.context_kv(self.pool[ctx]) if self.stored is None else self._load(ctx))
        return self._held[1]

    def lossy_layer(self, ctx: int, level: int, layer: int):
        """(2, T, C) float32 what a load of ``ctx`` at ``level`` lands in
        ``layer``, and (2, T, 1) how far one symbol moves each value."""
        kv = self.exact(ctx)[layer:layer + 1]
        bins = self.bins[level][layer:layer + 1] if level else None
        rebuilt, step = lossy_kv(kv, level, self.spec, self.delta_scale, self.traffic.chunk_tokens, bins)
        return rebuilt[0], step[0]


def off_share(got: torch.Tensor, want: torch.Tensor, step: torch.Tensor) -> float:
    """Largest over K and V of the share of values of ``got`` further from
    ``want`` than ``STEPS`` steps and the bf16 rounding of the value."""
    off = (got.to(torch.float32) - want).abs() > STEPS * step + BF16_ROUND * want.abs()
    return float(off.flatten(1).to(torch.float32).mean(dim=1).max())


def judge(arch, params, traffic, draw, waves, landed: Dict[int, Sequence[Landed]], control: bool = False,
          spec: Optional[CodecSpec] = None, stored: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, float]:
    """The cell's numbers for the program's outputs; with ``control`` also
    the numbers of the float8 reference in their place, under ``control``.
    ``landed`` maps each judged wave's index to its rows' landed KV;
    ``stored``, where given, holds each pool context's KV (L, 2, T, C) as
    the program stored it, for ``kv_off_stored``."""
    spec = spec or CodecSpec()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = _Side(Reference(arch, params), draw.pool_tokens, traffic, spec)
            low = _Side(Reference(arch, params, "fp8"), draw.pool_tokens, traffic, spec) if control else None
            own = _Side(ref.ref, draw.pool_tokens, traffic, spec, stored) if stored is not None else None
            sides = {"program": {}, "control": {}} if control else {"program": {}}
            early = max(1, ref.ref.L // 4)
            rows = sorted(((row.ctx, i, row) for i, rs in landed.items() for row in rs), key=lambda x: x[:2])
            for c, _, row in rows:
                for layer in range(ref.ref.L):
                    want, step = ref.lossy_layer(c, row.level, layer)
                    outs = {"program": row.kv[layer]}
                    if control:
                        outs["control"] = low.lossy_layer(c, row.level, layer)[0]
                    for name, got in outs.items():
                        off = off_share(got, want, step)
                        _top(sides[name], "kv_off", off)
                        if layer < early:
                            _top(sides[name], "kv_off_early", off)
                    if own is not None:
                        want, step = own.lossy_layer(c, row.level, layer)
                        for name, got in outs.items():
                            _top(sides[name], "kv_off_stored", off_share(got, want, step))
            Q = traffic.question_tokens
            gaps = {name: [] for name in sides}
            for i, rs in landed.items():
                reqs = waves[i].requests
                ctx = [(lambda kv: (lambda layer: kv[layer].to(torch.float32)))(row.kv) for row in rs]
                served = np.array([r.served for r in reqs], dtype=np.int64)  # (B, A)
                fed = np.concatenate([np.stack([r.question for r in reqs]), served[:, :-1]], axis=1)
                logits = ref.ref.answer_logits(ctx, Q, fed)  # (B, A, V)
                chosen = {"program": torch.as_tensor(served, device=logits.device)}
                if control:
                    chosen["control"] = low.ref.answer_logits(ctx, Q, fed).argmax(-1)
                best, std = logits.amax(-1), logits.std(-1)
                for name, tok in chosen.items():
                    picked = logits.gather(-1, tok[..., None])[..., 0]
                    gaps[name].append((best - picked) / std)  # (B, A)
                del logits
            for name, g in gaps.items():
                g = torch.cat(g)
                sides[name]["gap"] = float(g.max())
                sides[name]["gap_row"] = float(g.mean(dim=1).max())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    got = sides["program"]
    if control:
        got["control"] = sides["control"]
    return got


def _top(side: Dict[str, float], name: str, value: float) -> None:
    side[name] = max(side.get(name, 0.0), value)
