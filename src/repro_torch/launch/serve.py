"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Brings up the engine for an architecture (``.tiny()`` unless
``--full-width``), stores one context through the CacheGen streamer, then
serves a request loop.  Each request is a live closed-loop
:class:`~repro_torch.serving.session.ServeSession`: per chunk it measures
realized throughput from the trace-driven fetch, picks the next streaming
configuration (Algorithm 1), decodes fetched bitstreams through the fused
batched path and recomputes TEXT chunks for real, then generates.
``--check-sim`` cross-checks every session's per-chunk decisions against
the offline simulator on the same trace.

``--concurrency N`` (N > 1) serves the requests in waves of N concurrent
context loads on the one shared engine
(:class:`~repro_torch.serving.scheduler.ConcurrentScheduler`): each request
keeps its own trace, policy and clock, while decodes, cache insertions and
TEXT recomputes are batched across requests and per-session compute charges
are stretched by the contention model.

``--arrivals`` switches from closed waves to *open-loop* serving: requests
arrive over virtual time (``poisson:RATE`` draws seeded exponential
inter-arrivals at RATE requests/s; ``trace:FILE`` reads one ascending
arrival time per line) and the
:class:`~repro_torch.serving.scheduler.ContinuousScheduler` admits each the
moment one of ``--rows`` cache rows frees, so TTFT includes queueing delay.
``--preempt`` lets a waiting arrival evict a live session whose in-flight
fetch is known to land past its SLO deadline (plus ``--preempt-margin``);
``--generate N`` keeps each request on its row after its load and decodes N
tokens inside the scheduler's event loop, stacking every ready row into one
``Engine.decode_step_rows`` step.

``--store tiered`` swaps the flat context-keyed store for the
content-addressed :class:`~repro_torch.streaming.storage.TieredKVStore`
(chain-hashed chunks, a ``--hot-bytes``-bounded hot tier over a cold tier,
``--store-dir`` for an on-disk cold tier; per-tier counters are printed at
exit).  ``--transport`` picks the fetch path: ``sim`` (default, paced
against the request's trace, so ``--check-sim`` holds), ``local`` (direct
store reads) or ``tcp`` (an in-process
:class:`~repro_torch.streaming.transport.TcpStoreServer` and a paced socket
per fetch; over a tiered store the frames carry the hash keys).
``--hedge-after S`` duplicates a fetch still in flight after S seconds.
``--fault-*`` injects seeded faults (in flight via ``FaultyTransport`` on
sim/local and server-side on tcp; ``--fault-missing`` behind the store),
``--retry N`` arms the session's ``RetryPolicy``, and byte-range resume
keeps verified prefixes unless ``--no-resume``.

The port against the reference launcher (``repro.launch.serve``):

* The same flags, checks and printed lines, plus two of the port's own.
  ``--device`` picks the device (default: the CUDA card; with none, the
  port's "no CUDA device" error, never a silent CPU run).
  ``--full-width`` serves the published config instead of ``.tiny()``; the
  reference has no such flag and always serves ``.tiny()``.
* Weights: the reference draws them from ``jax.random.PRNGKey(0)``, which
  torch cannot reproduce; with no ``params`` the port draws
  ``lm.init_params(cfg, torch.Generator(device).manual_seed(0), device)``.
  So the two CLIs print other tokens and sizes for the same flags; pass the
  reference's draw as ``params`` (``models/convert.params_from_numpy``) to
  compare them.
* Families: the dense, MoE and vlm families, as the reference (smollm-360m,
  qwen2-moe-a2.7b, granite-moe-3b-a800m, paligemma-3b, ...).  A vlm
  context is the model's image prefix (``n_prefix_tokens`` rows of patch
  embeddings drawn from the context's generator after its tokens, as the
  reference draws them) before the ``--ctx-len`` text tokens; its KV rows
  are not 1:1 with text tokens, so the tiered store hashes their bytes, and
  no chunk may be recomputed as TEXT.
* Cache capacity: the reference sizes the cache at ``--ctx-len + 32 +
  --generate`` rows, where ``.tiny()``'s 8 image rows fit in the slack; at
  ``--full-width`` paligemma-3b's 256 do not, so there the port sizes it
  from the cached rows (image rows included).  Without ``--full-width``
  (and for every family but vlm) the two sizes are the same.
* :func:`run` prints the lines and returns what it printed as data (see its
  docstring); :func:`main` is the command line.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import registry
from repro_torch.core import codec as kvcodec
from repro_torch.data import MarkovLM
from repro_torch.models import lm as lm_mod
from repro_torch.serving.engine import Engine
from repro_torch.serving.generation import GenerationSpec
from repro_torch.serving.kv_layout import caches_to_codec_kv
from repro_torch.serving.scheduler import (
    ConcurrentScheduler,
    ContinuousScheduler,
    PreemptionPolicy,
    SessionRequest,
)
from repro_torch.serving.session import ServeSession
from repro_torch.streaming import (
    TEXT,
    BandwidthTrace,
    CacheGenStreamer,
    DirectoryBackend,
    FaultPlan,
    FaultyTransport,
    KVStore,
    LocalTransport,
    NetworkModel,
    RetryPolicy,
    SimTransport,
    TcpStoreServer,
    TcpTransport,
    TieredKVStore,
    with_faulty_backend,
)
from repro_torch.streaming.pipeline import ContentionModel

__all__ = ["build_parser", "main", "run"]


def _parse_arrivals(spec: str, n: int, seed: int):
    """``poisson:RATE`` (seeded exponential inter-arrivals) or
    ``trace:FILE`` (one ascending arrival time per line) -> n arrival
    instants on the virtual clock."""
    kind, _, val = spec.partition(":")
    if kind == "poisson":
        try:
            rate = float(val)
        except ValueError:
            raise SystemExit(f"--arrivals poisson:RATE needs a number, got {val!r}")
        if not rate > 0:  # also rejects nan
            raise SystemExit(f"--arrivals poisson rate must be > 0, got {rate}")
        rng = np.random.default_rng(seed)
        return np.cumsum(rng.exponential(1.0 / rate, size=n)).tolist()
    if kind == "trace":
        with open(val) as f:
            ts = [float(line) for line in f if line.strip()]
        if len(ts) < n:
            raise SystemExit(
                f"--arrivals trace:{val} has {len(ts)} arrivals, need {n}"
            )
        ts = ts[:n]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise SystemExit(f"--arrivals trace:{val} times must be ascending")
        return ts
    raise SystemExit("--arrivals must be poisson:RATE or trace:FILE")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--ctx-len", type=int, default=300)
    ap.add_argument("--slo-ms", type=float, default=250)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--fixed-level", type=int, default=None,
                    help="pin one encoding level (no adaptation baseline)")
    ap.add_argument("--max-run-tokens", type=int, default=None,
                    help="double-buffer granularity for fetch/decode overlap")
    ap.add_argument("--check-sim", action="store_true",
                    help="cross-check session decisions against the simulator")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="serve requests in waves of N concurrent context "
                         "loads batched on the shared engine")
    ap.add_argument("--arrivals", default=None, metavar="SPEC",
                    help="open-loop serving instead of closed waves: "
                         "'poisson:RATE' draws seeded exponential "
                         "inter-arrivals at RATE requests/s on the virtual "
                         "clock; 'trace:FILE' reads one ascending arrival "
                         "time (seconds) per line.  Requests are admitted "
                         "to the --rows row pool as rows free up, so TTFT "
                         "includes queueing delay from arrival")
    ap.add_argument("--rows", type=int, default=None,
                    help="--arrivals: row-pool capacity (concurrent context "
                         "loads resident on the engine; default: "
                         "--concurrency)")
    ap.add_argument("--preempt", action="store_true",
                    help="--arrivals: let a waiting arrival preempt a live "
                         "session whose in-flight fetch is known to land "
                         "past its SLO deadline — the fetch is cancelled "
                         "and the session's realized rows suspend into a "
                         "snapshot until a row frees again")
    ap.add_argument("--preempt-margin", type=float, default=0.0, metavar="S",
                    help="extra SLO overshoot (seconds) a pending fetch "
                         "must incur before its session is preemptible")
    ap.add_argument("--arrival-seed", type=int, default=0,
                    help="seed for poisson:RATE arrival draws")
    ap.add_argument("--generate", type=int, default=0, metavar="N",
                    help="--arrivals: decode N output tokens per request on "
                         "the shared engine after its context load lands — "
                         "continuous batching: ready generating rows stack "
                         "into one decode_step_rows dispatch per virtual "
                         "step and contend with in-flight loads (0 = "
                         "load-only)")
    ap.add_argument("--gen-slo", type=float, default=None, metavar="S",
                    help="--generate: per-output-token latency SLO in "
                         "seconds (TPOT); EDF admission orders waiters by "
                         "start + SLO deadline")
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="--generate: seeded softmax sampling instead of "
                         "greedy argmax (greedy stays bit-identical to the "
                         "generate_with_kv oracle)")
    ap.add_argument("--gen-step-ms", type=float, default=2.0,
                    help="--generate: uncontended virtual cost of one "
                         "stacked decode step (milliseconds)")
    ap.add_argument("--store", choices=("flat", "tiered"), default="flat",
                    help="storage layout: flat = context-keyed, keeps "
                         "everything forever; tiered = content-addressed "
                         "(chain-hashed token prefixes dedup across "
                         "contexts) with a capacity-bounded hot tier over "
                         "cold, level-aware LRU eviction, and cold-read "
                         "penalties fed to the throughput estimator")
    ap.add_argument("--hot-bytes", type=int, default=None, metavar="N",
                    help="--store tiered: hot-tier capacity in bytes "
                         "(default: never evict; 0 = everything cold)")
    ap.add_argument("--store-dir", default=None, metavar="DIR",
                    help="--store tiered: directory for the cold tier "
                         "(default: in-memory cold backend)")
    ap.add_argument("--transport", choices=("sim", "local", "tcp"),
                    default="sim",
                    help="fetch path: sim = trace-paced async reads "
                         "(simulator-differential), local = direct store "
                         "reads, tcp = real socket link to an in-process "
                         "store server")
    ap.add_argument("--hedge-after", type=float, default=None, metavar="S",
                    help="issue a duplicate (hedged) fetch for any chunk "
                         "still in flight after S seconds; the loser is "
                         "cancelled")
    ap.add_argument("--tcp-pace-gbps", type=float, default=0.2,
                    help="--transport tcp: server-side link pacing")
    ap.add_argument("--fault-drop", type=float, default=0.0, metavar="P",
                    help="probability a fetch attempt is dropped (link dies)")
    ap.add_argument("--fault-stall", type=float, default=0.0, metavar="P",
                    help="probability a fetch attempt stalls (Pareto tail)")
    ap.add_argument("--fault-corrupt", type=float, default=0.0, metavar="P",
                    help="probability a fetched payload is bit-flipped")
    ap.add_argument("--fault-truncate", type=float, default=0.0, metavar="P",
                    help="probability a fetch delivers a valid byte prefix "
                         "then severs (resumable with --retry)")
    ap.add_argument("--fault-missing", type=float, default=0.0, metavar="P",
                    help="probability a (chunk, level) entry is missing "
                         "from the store")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic fault plan")
    ap.add_argument("--fault-stall-scale", type=float, default=0.2,
                    metavar="S", help="injected stall scale (seconds)")
    ap.add_argument("--retry", type=int, default=0, metavar="N",
                    help="fault tolerance: total fetch attempts per chunk "
                         "level (0 = legacy crash-through on any failure)")
    ap.add_argument("--retry-backoff", type=float, default=0.02, metavar="S",
                    help="--retry: initial exponential backoff (seconds)")
    ap.add_argument("--retry-timeout", type=float, default=None, metavar="S",
                    help="--retry: per-attempt timeout (virtual seconds on "
                         "sim, wall seconds on local/tcp)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="--retry: fail the session once retries are "
                         "exhausted instead of falling back to coarser "
                         "levels / TEXT recompute")
    ap.add_argument("--no-resume", action="store_true",
                    help="--retry: discard verified byte prefixes and "
                         "refetch whole blobs on retry (the whole-blob "
                         "baseline)")
    ap.add_argument("--replan-factor", type=float, default=None, metavar="F",
                    help="sim transport: cancel an in-flight chunk whose "
                         "realized duration exceeds F x the live-estimate "
                         "prediction, salvage the verified prefix, and "
                         "re-decide the remainder (mid-chunk re-planning)")
    # the port's own flags: the reference launcher has neither
    ap.add_argument("--device", default=None,
                    help="port only: torch device to serve on (default: the "
                         "CUDA card; with no card the launcher raises "
                         "rather than run on the CPU; pass 'cpu' for that)")
    ap.add_argument("--full-width", action="store_true",
                    help="port only: serve the architecture's published "
                         "config instead of its .tiny() reduction (the "
                         "reference launcher always serves .tiny())")
    return ap


def _check(args) -> None:
    if args.concurrency < 1:
        raise SystemExit("--concurrency must be >= 1")
    if args.generate < 0:
        raise SystemExit("--generate must be >= 0")
    if args.generate and args.arrivals is None:
        raise SystemExit(
            "--generate requires --arrivals (continuous batching lives in "
            "the open-loop scheduler); closed waves still generate post-hoc "
            "via --gen"
        )


def run(argv: Optional[List[str]] = None, *, params=None, device=None) -> Dict[str, Any]:
    """Parse ``argv`` (default ``sys.argv[1:]``), serve, print the
    reference's lines, and return what was printed as data:

    ``lines`` (every printed line), ``cfg``, ``engine``, ``store`` (the
    clean store), ``streamer``, ``tokens`` (the (1, T) context, numpy),
    ``first_token`` (argmax of the prefill's last logits), ``sessions``
    (every request's ``SessionResult``, in request order), ``generated``
    (request index -> the ``--gen`` tokens ``describe`` printed; failed
    requests have none), ``sim_match`` (request index -> bool, with
    ``--check-sim``), ``waves`` (the ``SchedulerResult`` of each wave of a
    ``--concurrency`` > 1 run), ``open_loop`` (the ``ContinuousResult`` of an
    ``--arrivals`` run), ``tier_counters`` (tiered store), ``tcp_server``
    (the server's counters) and ``tcp_client`` (the client's
    ``tier_stats()``) — ``None`` where they do not apply.

    ``params`` are the model's weights on ``device`` (default: drawn from a
    torch generator seeded 0); ``device`` overrides ``--device``.
    """
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    _check(args)

    cfg = registry.get(args.arch)
    if not args.full_width:
        cfg = cfg.tiny()
    if cfg.family not in lm_mod.ATTENTION_FAMILIES:
        raise SystemExit(
            f"--arch {args.arch}: serve driver supports attention families "
            "(KV-cache streaming); see DESIGN.md §Arch-applicability"
        )
    dev = resolve_device(device if device is not None else args.device)
    lines: List[str] = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = lm_mod.init_params(cfg, gen, dev)
    n_cached = args.ctx_len + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    capacity = (n_cached if args.full_width else args.ctx_len) + 32 + args.generate
    engine = Engine(cfg, params, cache_capacity=capacity, device=dev)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    tokens = lm.sample(rng, args.ctx_len)[None]
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(1, cfg.n_prefix_tokens, cfg.frontend_dim)),
            dtype=torch.float32, device=dev,
        )
    logits, caches = engine.calculate_kv(batch)
    kv = caches_to_codec_kv(caches, 0, n_cached)
    tables = kvcodec.profile([kv], kvcodec.CodecConfig(precision=11), device=dev)
    if args.store == "tiered":
        store = TieredKVStore(
            tables,
            hot_bytes=args.hot_bytes,
            cold=DirectoryBackend(args.store_dir) if args.store_dir else None,
        )
    else:
        store = KVStore(tables)
    streamer = CacheGenStreamer(store, cfg)
    store.store_kv(
        "ctx", kv, chunk_tokens=max(args.ctx_len // 4, 50),
        # canonical token-chain hashing when the KV rows are 1:1 with
        # text tokens; a vlm's prefix rows aren't, so hash KV bytes there
        tokens=tokens[0].tolist() if tokens.shape[1] == n_cached else None,
    )
    say(f"[serve] context stored: {store.storage_bytes('ctx')/1e3:.1f} KB all levels")

    fault_plan = None
    if (args.fault_drop or args.fault_stall or args.fault_corrupt
            or args.fault_truncate or args.fault_missing):
        fault_plan = FaultPlan(
            seed=args.fault_seed,
            drop_p=args.fault_drop,
            stall_p=args.fault_stall,
            corrupt_p=args.fault_corrupt,
            truncate_p=args.fault_truncate,
            missing_p=args.fault_missing,
            stall_scale_s=args.fault_stall_scale,
        )
        say(f"[serve] fault plan armed: {fault_plan}")
    # storage faults live behind the readers; in-flight faults wrap the
    # transport (sim/local) or run server-side (tcp)
    serve_store = (
        with_faulty_backend(store, fault_plan)
        if fault_plan is not None and args.fault_missing > 0
        else store
    )
    inflight_faults = fault_plan is not None and bool(
        args.fault_drop or args.fault_stall or args.fault_corrupt
        or args.fault_truncate
    )
    # the first decode input of every generation: the prefill's last
    # argmax, on the device, read once
    first = torch.argmax(logits[:, -1], -1).to(torch.int32)
    out: Dict[str, Any] = dict(
        lines=lines, cfg=cfg, engine=engine, store=store, streamer=streamer,
        tokens=tokens, first_token=int(first[0]),
        sessions=[], generated={}, sim_match={}, waves=[], open_loop=None,
        tier_counters=None, tcp_server=None, tcp_client=None,
    )

    tcp_server = None
    transport = None  # sim: a SimTransport is built per request below
    try:
        if args.transport == "local":
            transport = LocalTransport(serve_store)
            if inflight_faults:
                transport = FaultyTransport(transport, fault_plan)
        elif args.transport == "tcp":
            tcp_server = TcpStoreServer(
                serve_store, pace_gbps=args.tcp_pace_gbps,
                fault_plan=fault_plan if inflight_faults else None,
            )
            transport = TcpTransport.for_server(
                tcp_server,
                # content-addressed protocol: the client sends hash keys
                # when the store has them, and the server reads by (hash,
                # level)
                hash_lookup=getattr(serve_store, "try_hash", None),
            )
            say(f"[serve] tcp store server on {tcp_server.address} "
                f"paced at {args.tcp_pace_gbps} Gbps")

        def mk_transport(net):
            """Per-request fetch path with the fault plan applied."""
            if transport is not None:
                return transport
            if serve_store is store and not inflight_faults:
                return None  # default: SessionTask builds a clean SimTransport
            t = SimTransport(serve_store, net)
            return FaultyTransport(t, fault_plan) if inflight_faults else t

        retry_policy = None
        if args.retry >= 1:
            retry_policy = RetryPolicy(
                max_attempts=args.retry,
                backoff_s=args.retry_backoff,
                timeout_s=None if args.transport != "sim" else args.retry_timeout,
                wall_timeout_s=args.retry_timeout if args.transport != "sim" else None,
                degrade=not args.no_degrade,
            )
            say(f"[serve] retry policy armed: {retry_policy}")

        recompute_s = lambda t, p: 0.02 * t / 64  # noqa: E731
        session = ServeSession(
            streamer,
            engine,
            slo_s=args.slo_ms / 1e3,
            recompute_s=recompute_s,
            decode_bytes_per_s=300e6,
            allow_text=(cfg.family != "vlm"),
            fixed_level=args.fixed_level,
            max_run_tokens=args.max_run_tokens,
            hedge_after_s=args.hedge_after,
            transport=transport,
            retry_policy=retry_policy,
            resume_fetch=not args.no_resume,
            replan_factor=args.replan_factor,
        )

        def close_server():
            counters = getattr(serve_store, "tier_counters", None)
            if callable(counters):
                c = counters()
                out["tier_counters"] = c
                say(
                    f"[serve] tiered store: hot_hits={c['hot_hits']} "
                    f"cold_hits={c['cold_hits']} misses={c['misses']} "
                    f"demotions={c['demotions']} evictions={c['evictions']} "
                    f"dedup_chunks={c['dedup_chunks']} "
                    f"hot={c['hot_used_bytes']/1e3:.1f}/"
                    f"{min(c['hot_capacity_bytes'], 1 << 40)/1e3:.1f} KB "
                    f"unique={c['unique_bytes']/1e3:.1f} KB"
                )
            if tcp_server is None:
                return
            tcp_server.close()
            out["tcp_server"] = dict(
                n_connections=tcp_server.n_connections,
                n_dropped_connections=tcp_server.n_dropped_connections,
                n_malformed=tcp_server.n_malformed,
                n_injected_faults=tcp_server.n_injected_faults,
                last_errors=list(tcp_server.last_errors),
            )
            if fault_plan is not None:
                say(
                    f"[serve] tcp server: conns={tcp_server.n_connections} "
                    f"dropped={tcp_server.n_dropped_connections} "
                    f"malformed={tcp_server.n_malformed} "
                    f"injected={tcp_server.n_injected_faults}"
                )
            stats = getattr(transport, "tier_stats", None)
            if callable(stats):
                s = stats()
                out["tcp_client"] = s
                say(
                    f"[serve] tcp client: connects={s.get('n_connects', 0)} "
                    f"reconnects={s.get('n_reconnects', 0)} "
                    f"pool_reuses={s.get('n_pool_reuses', 0)}"
                )

        names = {TEXT: "TEXT"}

        def describe(r, res, extra=""):
            out["sessions"].append(res)
            fault = ""
            if retry_policy is not None or fault_plan is not None:
                fault = (
                    f" retries={res.n_retries} degrades={res.n_degrades} "
                    f"faults={res.fault_counts}"
                )
                if retry_policy is not None:
                    fault += (
                        f" salvaged={res.salvaged_bytes/1e3:.1f}KB "
                        f"resumes={res.n_resumes} "
                        f"replans={res.n_mid_chunk_replans}"
                    )
            if res.failed:
                say(
                    f"[req {r}] FAILED ({res.failure}) "
                    f"configs={[names.get(c, f'L{c}') for c in res.configs]}"
                    + fault + extra
                )
                return
            gen = engine.generate_with_kv(res.caches, first, args.gen)
            out["generated"][r] = gen[0].tolist()
            hedge = (
                f" hedged={res.n_hedged} dup={res.duplicate_bytes/1e3:.1f}KB"
                if args.hedge_after is not None else ""
            )
            say(
                f"[req {r}] configs={[names.get(c, f'L{c}') for c in res.configs]} "
                f"ttft={res.ttft_s*1e3:.1f} ms ok={not res.slo_violated} "
                f"runs={res.n_runs} wall_decode={res.wall_decode_s*1e3:.1f} ms "
                f"tokens={gen[0].tolist()}" + hedge + fault + extra
            )

        def check_sim(r, res, trace, prior):
            if not args.check_sim:
                return ""
            plan = streamer.stream(
                "ctx", NetworkModel(trace, rtt_s=0.002), slo_s=args.slo_ms / 1e3,
                decode_bytes_per_s=300e6, recompute_s=recompute_s,
                prior_throughput_gbps=prior, allow_text=(cfg.family != "vlm"),
                fixed_level=args.fixed_level, hedge_after_s=args.hedge_after,
            )
            out["sim_match"][r] = res.configs == plan.result.configs
            return f" sim_match={out['sim_match'][r]}"

        if args.arrivals is not None:
            arrivals = _parse_arrivals(args.arrivals, args.requests, args.arrival_seed)
            traces = [
                BandwidthTrace.sampled(rng, 6, 0.05, 0.05, 2.0)
                for _ in range(args.requests)
            ]
            gen_spec = None
            if args.generate:
                # first decode input = the context prefill's TTFT token
                gen_spec = GenerationSpec(
                    n_tokens=args.generate,
                    first_token=out["first_token"],
                    gen_slo_s=args.gen_slo,
                    sample_seed=args.sample_seed,
                )
            scheduler = ContinuousScheduler(
                engine,
                rows=args.rows if args.rows is not None else args.concurrency,
                preemption=(
                    PreemptionPolicy(margin_s=args.preempt_margin)
                    if args.preempt else None
                ),
                gen_step_s=args.gen_step_ms / 1e3,
            )
            nets = [NetworkModel(tr, rtt_s=0.002) for tr in traces]
            loop = scheduler.run([
                SessionRequest(
                    session, "ctx", tokens, net,
                    prior_throughput_gbps=float(tr.gbps[0]), start_t=arr,
                    transport=mk_transport(net),
                    generation=gen_spec,
                )
                for tr, net, arr in zip(traces, nets, arrivals)
            ])
            out["open_loop"] = loop
            for r, (res, tl) in enumerate(zip(loop.sessions, loop.timeline)):
                extra = (
                    f" arrival={tl.arrival_t*1e3:.0f}ms wait={tl.queue_wait_s*1e3:.0f}ms"
                    + (f" preempted={tl.n_preemptions}x" if tl.n_preemptions else "")
                )
                if tl.n_tokens_out:
                    extra += (
                        f" gen={tl.n_tokens_out}tok"
                        f" tpot_mean={tl.mean_tpot_s*1e3:.2f}ms"
                    )
                describe(r, res, extra)
            ttfts = sorted(s.ttft_s for s in loop.sessions)
            p = lambda q: ttfts[min(int(q * len(ttfts)), len(ttfts) - 1)]  # noqa: E731
            resume = ""
            if retry_policy is not None:
                resume = (
                    f" salvaged={sum(s.salvaged_bytes for s in loop.sessions)/1e3:.1f}KB"
                    f" fetch_resumes={sum(s.n_resumes for s in loop.sessions)}"
                    f" replans={sum(s.n_mid_chunk_replans for s in loop.sessions)}"
                )
            say(
                f"[open-loop rows={loop.n_rows}] ttft p50={p(0.5)*1e3:.1f} ms "
                f"p95={p(0.95)*1e3:.1f} ms preemptions={loop.n_preemptions} "
                f"resumes={loop.n_resumes} rounds={loop.n_rounds} "
                f"decode_batches={loop.n_decode_batches} "
                f"peak_rows={max(n for _, n in loop.occupancy)} "
                f"failed={loop.n_failed}" + resume
            )
            if loop.n_gen_tokens:
                tpots = sorted(
                    d for tl in loop.timeline for d in tl.tpot_s
                )
                pq = lambda q: tpots[min(int(q * len(tpots)), len(tpots) - 1)]  # noqa: E731
                agg = (
                    loop.n_gen_tokens / loop.wall_gen_s if loop.wall_gen_s > 0
                    else float("nan")
                )
                peak_gen = max((n for _, n in loop.gen_occupancy), default=0)
                say(
                    f"[generation tokens={loop.n_gen_tokens}] "
                    f"tpot mean={sum(tpots)/len(tpots)*1e3:.2f} ms "
                    f"p95={pq(0.95)*1e3:.2f} ms "
                    f"agg {agg:.1f} tok/s steps={loop.n_gen_steps} "
                    f"peak_gen_rows={peak_gen}"
                )
            close_server()
            return out

        if args.concurrency == 1:
            for r in range(args.requests):
                trace = BandwidthTrace.sampled(rng, 6, 0.05, 0.05, 2.0)
                prior = float(trace.gbps[0])
                net = NetworkModel(trace, rtt_s=0.002)
                res = session.run(
                    "ctx",
                    tokens,
                    net,
                    prior_throughput_gbps=prior,
                    transport=mk_transport(net),
                )
                describe(r, res, check_sim(r, res, trace, prior))
            close_server()
            return out

        if args.check_sim:
            # the offline simulator has no contention model, so comparing its
            # decisions is only meaningful with contention charging disabled
            # (factor 1 at any N); without --check-sim, waves use the measured
            # contention model and decisions legitimately diverge from the
            # uncontended simulator under load
            scheduler = ConcurrentScheduler(
                engine, contention=ContentionModel({1: 1.0, 2: 1.0})
            )
        else:
            scheduler = ConcurrentScheduler(engine)
        served = 0
        while served < args.requests:
            wave = min(args.concurrency, args.requests - served)
            traces = [BandwidthTrace.sampled(rng, 6, 0.05, 0.05, 2.0) for _ in range(wave)]
            nets = [NetworkModel(tr, rtt_s=0.002) for tr in traces]
            res_wave = scheduler.run([
                SessionRequest(
                    session, "ctx", tokens, net,
                    prior_throughput_gbps=float(tr.gbps[0]),
                    transport=mk_transport(net),
                )
                for tr, net in zip(traces, nets)
            ])
            out["waves"].append(res_wave)
            for i, res in enumerate(res_wave.sessions):
                describe(served + i, res,
                         check_sim(served + i, res, traces[i], float(traces[i].gbps[0])))
            resume = ""
            if retry_policy is not None:
                resume = (
                    f" salvaged={sum(s.salvaged_bytes for s in res_wave.sessions)/1e3:.1f}KB"
                    f" fetch_resumes={sum(s.n_resumes for s in res_wave.sessions)}"
                    f" replans={sum(s.n_mid_chunk_replans for s in res_wave.sessions)}"
                )
            say(
                f"[wave of {wave}] decode_batches={res_wave.n_decode_batches} "
                f"text_batches={res_wave.n_text_batches} runs={res_wave.n_runs} "
                f"wall_total={res_wave.wall_total_s*1e3:.1f} ms failed={res_wave.n_failed}"
                + resume
            )
            served += wave
        close_server()
    finally:
        if tcp_server is not None:
            tcp_server.close()
        if transport is not None:
            transport.close()
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
