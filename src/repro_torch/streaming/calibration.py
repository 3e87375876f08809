"""Measured codec-throughput calibration for the streaming simulator.

The TTFT simulator charges ``nbytes / decode_bytes_per_s`` for every
bitstream chunk, so the constant directly shapes every simulated TTFT / SLO
number.  The default is meant to be the *measured* fused-decode throughput
of the port on this host, read back from a benchmark report; the same
report's ``stacked`` sections calibrate ``pipeline.ContentionModel``'s
per-session slowdown when N sessions share one engine.

The port reads only its own reports, ``BENCH_torch_codec.json`` and
``BENCH_torch_session.json``, never the reference package's
``BENCH_codec.json``/``BENCH_session.json`` (a JAX measurement is not the
port's rate).  Lookup order: ``$CACHEGEN_TORCH_BENCH_CODEC`` /
``$CACHEGEN_TORCH_BENCH_SESSION`` (explicit file), the file in the current
working directory, then the repository root next to this package.  A
report is trusted only when its ``host_backend`` (``"cuda"`` or ``"cpu"``)
matches the device the port runs on here: ``"cuda"`` when a card is
present, else ``"cpu"``.

No benchmark of the port writes these reports yet, so the defaults apply:
:data:`DEFAULT_DECODE_BYTES_PER_S` is a placeholder of the paper's
GPU-decoder order (GB/s), not a rate any card measured for the port.

Results are memoized per (candidate list, backend, file signature); the
signature includes each candidate's mtime and size, so a rewritten report is
picked up without an explicit reset.  :func:`clear_calibration_cache` drops
the memo entirely (tests).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "DEFAULT_DECODE_BYTES_PER_S",
    "BENCH_CODEC_FILENAME",
    "BENCH_SESSION_FILENAME",
    "bench_codec_candidates",
    "bench_session_candidates",
    "clear_calibration_cache",
    "measured_decode_bytes_per_s",
    "measured_contention_factors",
    "measured_generation_contention_factors",
    "measured_level_priorities",
    "measured_text_contention_factors",
    "sharded_contention_factors",
]

DEFAULT_DECODE_BYTES_PER_S = 4e9  # placeholder: not measured on any card
BENCH_CODEC_FILENAME = "BENCH_torch_codec.json"
BENCH_SESSION_FILENAME = "BENCH_torch_session.json"
_ENV_VAR = "CACHEGEN_TORCH_BENCH_CODEC"
_ENV_SESSION = "CACHEGEN_TORCH_BENCH_SESSION"


def _candidates(env_var: str, filename: str) -> List[str]:
    cands = []
    env = os.environ.get(env_var)
    if env:
        cands.append(env)
    cands.append(os.path.join(os.getcwd(), filename))
    repo_root = os.path.dirname(  # streaming/ -> repro_torch/ -> src/ -> repo
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    )
    cands.append(os.path.join(repo_root, filename))
    return cands


def bench_codec_candidates() -> List[str]:
    """Candidate paths for the port's codec throughput report."""
    return _candidates(_ENV_VAR, BENCH_CODEC_FILENAME)


def bench_session_candidates() -> List[str]:
    """Candidate paths for the port's session scenario report."""
    return _candidates(_ENV_SESSION, BENCH_SESSION_FILENAME)


def _backend() -> str:
    """The device a report must have been measured on to be trusted here."""
    return "cuda" if torch.cuda.is_available() else "cpu"


_MEMO: dict = {}


def clear_calibration_cache() -> None:
    """Forget every memoized measurement (the memo already keys on file
    mtime/size; this is the reset for what that signature cannot see)."""
    _MEMO.clear()


def _file_sig(path: str) -> Optional[Tuple[int, int]]:
    """(mtime_ns, size) of ``path``, or None if unreadable."""
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def _first_measurement(cands: Tuple[str, ...], backend: str, extract):
    """First candidate report yielding a usable value via ``extract``.

    Candidates that are unreadable, unparseable, from another backend, *or*
    parseable but missing/invalid for this extractor all fall through to the
    next candidate.
    """
    for p in cands:
        try:
            with open(p) as f:
                report = json.load(f)
            if report.get("host_backend") not in (None, backend):
                continue
            v = extract(report)
            if v is not None:
                return v
        except (OSError, KeyError, TypeError, ValueError):
            continue
    return None


def _measured(kind: str, cands: Tuple[str, ...], extract, empty):
    """Signature-checked memo around :func:`_first_measurement`: one live
    entry per key, replaced when the files' (mtime, size) signature moves."""
    backend = _backend()
    key = (kind, cands, backend)
    sig = tuple(_file_sig(p) for p in cands)
    hit = _MEMO.get(key)
    if hit is not None and hit[0] == sig:
        return hit[1]
    v = _first_measurement(cands, backend, extract)
    value = empty if v is None else v
    _MEMO[key] = (sig, value)
    return value


def _slowdowns(rates: Dict[int, float]) -> Optional[Dict[int, float]]:
    """Aggregate throughput at M concurrent requests -> per-session slowdown
    ``M * thpt(1) / thpt(M)``, clamped to >= 1.0 (a measured super-linear
    blip must not make the cost model charge less than the uncontended
    rate); None without a usable M = 1 point."""
    base = rates.get(1)
    if not base or base <= 0:
        return None
    return {m: max(1.0, m * base / r) for m, r in sorted(rates.items()) if r > 0}


def measured_decode_bytes_per_s(
    default: float = DEFAULT_DECODE_BYTES_PER_S,
    path: Optional[str] = None,
) -> float:
    """Fused-decode bytes/s from the port's codec report, else ``default``."""
    cands = tuple([path] if path else bench_codec_candidates())

    def extract(report):
        v = float(report["fused"]["bytes_per_s"])
        return v if v > 0 else None

    return float(_measured(("decode", float(default)), cands, extract, float(default)))


def measured_contention_factors(path: Optional[str] = None) -> Dict[int, float]:
    """Per-session decode slowdown at M concurrent sessions, from the
    report's ``stacked`` section; ``{}`` when not measured."""
    cands = tuple([path] if path else bench_codec_candidates())

    def extract(report):
        return _slowdowns({int(m): float(row["stacked"]["bytes_per_s"])
                           for m, row in report["stacked"].items()})

    return dict(_measured("contention", cands, extract, {}))


def measured_text_contention_factors(path: Optional[str] = None) -> Dict[int, float]:
    """Per-session TEXT-recompute slowdown at M concurrent sessions, from
    the report's ``stacked_prefill`` section; ``{}`` when not measured."""
    cands = tuple([path] if path else bench_codec_candidates())

    def extract(report):
        return _slowdowns({int(m): float(row["batched"]["tokens_per_s"])
                           for m, row in report["stacked_prefill"].items()})

    return dict(_measured("text_contention", cands, extract, {}))


def measured_generation_contention_factors(path: Optional[str] = None) -> Dict[int, float]:
    """Per-session generation-step slowdown at M generating rows, from the
    report's ``stacked_decode_step`` section; ``{}`` when not measured."""
    cands = tuple([path] if path else bench_codec_candidates())

    def extract(report):
        return _slowdowns({int(m): float(row["batched"]["tokens_per_s"])
                           for m, row in report["stacked_decode_step"].items()})

    return dict(_measured("gen_contention", cands, extract, {}))


def measured_level_priorities(path: Optional[str] = None) -> Dict[int, float]:
    """Per-level keep priority: each stored level's share of the levels
    Algorithm 1 picked across the session report's scenarios.  TEXT (level
    ``-1``) occupies no store space and is left out; ``{}`` when no report
    exists."""
    cands = tuple([path] if path else bench_session_candidates())

    def extract(report):
        counts: Dict[int, int] = {}
        for sc in report["scenarios"]:
            for lvl, n in (sc.get("levels") or {}).items():
                if int(lvl) >= 0:
                    counts[int(lvl)] = counts.get(int(lvl), 0) + int(n)
        total = sum(counts.values())
        if total <= 0:
            return None
        return {lvl: c / total for lvl, c in sorted(counts.items())}

    return dict(_measured("level_priorities", cands, extract, {}))


def sharded_contention_factors(n_shards: int, path: Optional[str] = None) -> Dict[int, float]:
    """Effective decode slowdown per live-session count on an S-shard mesh.

    The row-sharded engine (``serving.mesh_engine.ShardedEngine``) splits
    its cache rows over ``n_shards`` contention domains, so N live sessions
    see the measured single-device curve at the even-spread per-shard width
    ``ceil(N / S)``.  Returns the measured curve's support re-read through
    that mapping; at ``n_shards=1`` this is exactly
    :func:`measured_contention_factors`.
    """
    if n_shards < 1:
        raise ValueError(f"sharded_contention_factors needs n_shards >= 1, got {n_shards}")
    from repro_torch.streaming.pipeline import ContentionModel  # lazy: avoid cycle

    base = measured_contention_factors(path)
    cm = ContentionModel(base)
    return {int(m): cm.factor_sharded(int(m), n_shards) for m in sorted(base)}
