"""One run of one cell: set-up, the measured window, the check.

Set-up (counted in ``setup_s``):
  1. the weights, drawn on the device from the seed (``weights.py``);
  2. the pool of contexts, drawn from the seed (``traffic.py``);
  3. each pool context through ``Engine.calculate_kv``;
  4. ``codec.profile`` on the first ``calibration_tokens`` of the pool's
     first context, under ``CodecConfig(precision=11)`` (the serving
     launcher's);
  5. every pool context stored through ``KVStore.store_kv`` in chunks of
     ``chunk_tokens``, at the levels the mix sends;
  6. the two calibrations the program would run at construction pinned:
     ``ContentionModel({})`` and an explicit ``decode_bytes_per_s``;
  7. one wave of the window's shapes (a wave of its own draw), untimed.

The window is a closed loop of the mix's clients served in waves, each wave
three steps on the program's own entries:
  1. load: one ``ConcurrentScheduler.run`` over the wave's requests, each a
     ``ServeSession`` pinned to its level (``fixed_level``, no TEXT) over a
     ``LocalTransport`` of the store: fetch, blob validation, unpack, K7,
     K1 or K2, ``insert_runs``;
  2. question: one ``Engine.prefill_extend_rows`` over the wave's rows, its
     greedy tokens read to the host (every request's first token);
  3. generation: ``answer_tokens - 1`` greedy ``Engine.decode_step_rows``
     steps stacked over the wave's rows, each step's tokens read to the host.
A request's time to first token runs from its wave's start to its first
token on the host.  Waves start while the window's ``seconds`` have not
passed; the window ends when its last wave does.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pbench.check import Landed, judge
from pbench.tracing import DeviceTrace, K7Calls, Spans
from pbench.traffic import Draw, Request, Traffic
from pbench.weights import make_params

__all__ = ["WaveRecord", "RunRecord", "run_cell", "verdict", "WARMUP_WAVE"]

WARMUP_WAVE = 1 << 32  # the warm-up wave's own draw, never a window's
SLO_S = 10.0  # a pinned level has no decision for the SLO to move
LINK_GBPS = 100.0  # the virtual clock's link; LocalTransport reads the store directly
DECODE_BYTES_PER_S = 300e6  # pinned, as the serving launcher pins it
CODEC_PRECISION = 11


@dataclasses.dataclass
class WaveRecord:
    t0: int  # ns, the wave's start (its requests' send time)
    t_loaded: int
    t_first: int  # every request's first token on the host
    t_steps: List[int]  # each later token on the host
    requests: List[Request]
    ctx_lens: List[int]
    ok: List[bool]
    wall_decode_s: float  # the scheduler's own decode-and-insert timer

    @property
    def n_answer(self) -> int:
        return 1 + len(self.t_steps)


@dataclasses.dataclass
class RunRecord:
    arch: dict
    traffic: Traffic
    waves: List[WaveRecord]
    window: Tuple[int, int]  # ns
    setup_s: float
    spans: Spans
    device: Optional[List[Tuple[str, int, int]]] = None  # traced runs only
    k7_calls: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _arch_config(arch: dict):
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in arch.items() if k in fields})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(arch: dict, traffic: Traffic, seed: int, seconds: float, trace: bool, device, t_start_ns: int,
             judged_waves: int, limits: Dict[str, float], judge_fn=judge) -> dict:
    """Run the cell once.  Returns the record, the numbers compared and the
    device's peak memory; see the module docstring for what it runs."""
    from repro_torch.core import codec
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_layout import caches_to_codec_kv
    from repro_torch.serving.scheduler import ConcurrentScheduler, SessionRequest
    from repro_torch.serving.session import ServeSession
    from repro_torch.streaming import BandwidthTrace, CacheGenStreamer, KVStore, LocalTransport, NetworkModel
    from repro_torch.streaming.pipeline import ContentionModel

    dev = torch.device(device)
    torch.set_grad_enabled(False)
    laps: Dict[str, float] = {}
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        _sync(dev)
        now = time.perf_counter()
        laps[name] = round(laps.get(name, 0.0) + now - t_lap[0], 3)
        t_lap[0] = now

    cfg = _arch_config(arch)
    params = make_params(cfg, seed, dev)
    draw = Draw(traffic, cfg.vocab_size, seed)
    lap("weights and draw")
    engine = Engine(cfg, params, cache_capacity=traffic.capacity(), device=dev)
    levels = sorted(traffic.levels)
    store = None
    # the context KV as stored, on the host, where a limit judges the load from it
    stored = [] if "kv_off_stored" in limits else None
    for i, toks in enumerate(draw.pool_tokens):
        _, caches = engine.calculate_kv({"tokens": torch.as_tensor(toks[None], device=dev)})
        kv = caches_to_codec_kv(caches, 0, len(toks))
        del caches
        lap("calculate_kv")
        if store is None:
            tables = codec.profile([kv[:, :, :traffic.calibration_tokens]],
                                   codec.CodecConfig(precision=CODEC_PRECISION), device=dev)
            store = KVStore(tables)
            lap("profile")
        store.store_kv(f"ctx{i}", kv, chunk_tokens=traffic.chunk_tokens, levels=levels, tokens=toks.tolist())
        if stored is not None:
            stored.append(kv.to("cpu", torch.bfloat16))  # the caches' bf16 values, exactly
        del kv
        lap("store_kv")
    streamer = CacheGenStreamer(store, cfg)
    transport = LocalTransport(store)
    net = NetworkModel(BandwidthTrace.constant(LINK_GBPS))
    sessions = {
        lvl: ServeSession(streamer, engine, slo_s=SLO_S, recompute_s=lambda n, p: 0.0,
                          decode_bytes_per_s=DECODE_BYTES_PER_S, allow_text=False, fixed_level=lvl,
                          transport=transport)
        for lvl in levels
    }
    sched = ConcurrentScheduler(engine, contention=ContentionModel({}))
    spans = Spans()
    Q = traffic.question_tokens

    def serve_wave(reqs: List[Request], n_steps: int, spans: Spans):
        C = len(reqs)
        t0 = time.time_ns()
        with spans("load"):
            res = sched.run([
                SessionRequest(sessions[r.level], f"ctx{r.ctx}", draw.pool_tokens[r.ctx][None], net,
                               transport=transport)
                for r in reqs
            ])
        t_loaded = time.time_ns()
        ok = [s.status == "ok" for s in res.sessions]
        wall_decode_s = res.wall_decode_s
        caches = res.caches
        del res
        q = torch.as_tensor(np.stack([r.question for r in reqs]), device=dev).long()
        with spans("question"):
            logits, caches = engine.prefill_extend_rows(q, caches, [Q] * C)
            tok = torch.argmax(logits[:, -1], dim=-1)
            host = [tok.cpu()]
        t_first = time.time_ns()
        active = torch.ones(C, dtype=torch.bool, device=dev)
        t_steps = []
        for _ in range(n_steps):
            with spans("step"):
                logits, caches = engine.decode_step_rows(tok[:, None], caches, active)
                tok = torch.argmax(logits[:, 0], dim=-1)
                host.append(tok.cpu())
            t_steps.append(time.time_ns())
        served = torch.stack(host, dim=1).tolist()
        for r, s in zip(reqs, served):
            r.served = s
        rec = WaveRecord(t0, t_loaded, t_first, t_steps, reqs, [len(draw.pool_tokens[r.ctx]) for r in reqs], ok,
                         wall_decode_s)
        return rec, caches

    # the window's shapes once, untimed: every pool context and level, the
    # question, and a few steps (a step's shapes do not change with its index)
    _, caches = serve_wave(draw.wave(WARMUP_WAVE), min(traffic.answer_tokens - 1, 4), Spans())
    del caches
    lap("warm-up wave")
    print(f"set-up s: {laps}", file=sys.stderr, flush=True)

    # the rows' landed KV of the waves before the last that are judged, kept
    # as the next wave starts (the last wave's stays in its cache); every
    # wave loads the same context tokens, so the slots are made once
    n_ctx = sum(len(draw.pool_tokens[r.ctx]) for r in draw.wave(0))
    C_kv = cfg.n_kv_heads * cfg.d_head
    slots = [torch.empty((cfg.n_layers, 2, n_ctx, C_kv), dtype=torch.bfloat16, device=dev)
             for _ in range(judged_waves - 1)]
    kept: Dict[int, int] = {}  # wave index -> slot

    def keep(i: int, rec: WaveRecord, caches) -> None:
        j = i % len(slots)
        off = 0
        for b, T in enumerate(rec.ctx_lens):
            slots[j][:, 0, off:off + T] = caches.kv_k[:, b, :T].flatten(2)
            slots[j][:, 1, off:off + T] = caches.kv_v[:, b, :T].flatten(2)
            off += T
        kept.pop(next((w for w, s in kept.items() if s == j), None), None)
        kept[i] = j

    k7 = K7Calls()
    # the device trace needs a card; a traced run elsewhere has no device metrics
    dtrace = DeviceTrace() if trace and dev.type == "cuda" else None
    if dtrace is not None:
        k7.install()
        dtrace.start()
    waves: List[WaveRecord] = []
    caches = None
    w0 = time.time_ns()
    setup_s = (w0 - t_start_ns) / 1e9
    while not waves or time.time_ns() - w0 < seconds * 1e9:
        if slots and waves:
            keep(len(waves) - 1, waves[-1], caches)
        caches = None  # the last wave's rows free before the next wave's
        rec, caches = serve_wave(draw.wave(len(waves)), traffic.answer_tokens - 1, spans)
        waves.append(rec)
    _sync(dev)
    w1 = time.time_ns()
    t_w1 = time.perf_counter()
    if dtrace is not None:
        dtrace.stop()
        k7.remove()
    t_traced = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the judged waves' landed KV, then the program's state freed
    def rows(rec: WaveRecord, k, v) -> List[Landed]:
        out, off = [], 0
        for b, (r, T) in enumerate(zip(rec.requests, rec.ctx_lens)):
            out.append(Landed(r.ctx, r.level, torch.stack([k(b, off, T), v(b, off, T)], dim=1)))
            off += T
        return out

    landed = {i: rows(waves[i], lambda b, o, T, j=j: slots[j][:, 0, o:o + T], lambda b, o, T, j=j: slots[j][:, 1, o:o + T])
              for i, j in sorted(kept.items())}
    last = len(waves) - 1
    landed[last] = rows(waves[last], lambda b, o, T: caches.kv_k[:, b, :T].flatten(2).clone(),
                        lambda b, o, T: caches.kv_v[:, b, :T].flatten(2).clone())
    slots.clear()
    del caches, sched, sessions, streamer, transport, store, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    record = RunRecord(arch, traffic, waves, (w0, w1), setup_s, spans,
                       device=dtrace.events if dtrace is not None else None, k7_calls=k7.calls)
    t_judge = time.perf_counter()
    numbers = judge_fn(arch, params, traffic, draw, waves, landed, stored=stored)
    print(f"after the window s: trace {t_traced - t_w1:.3f}, "
          f"check {time.perf_counter() - t_judge:.3f}", file=sys.stderr, flush=True)
    failed = sum(not ok for w in waves for ok in w.ok)
    numbers["failed_requests"] = float(failed)
    checks, correct = verdict(numbers, limits)
    return {"record": record, "checks": checks, "numbers": numbers, "correct": bool(correct), "peak": int(peak),
            "attempted": sum(len(w.requests) for w in waves), "failed": failed}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """Each limited number beside its limit, and whether all are within."""
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return checks, bool(correct)
