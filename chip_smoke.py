#!/usr/bin/env python3
"""Drive the PyTorch port's load-then-generate path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. env     torch / CUDA versions and the card's name and power limit.
2. build   compile the four CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels each kernel against its plain PyTorch version on the card, at the
           smollm-360m main-path shapes plus ragged cases, under the bf16
           rule of ``kernels.ops.BF16_TOL`` (K2 and K5 bit for bit, K6 bit
           for bit in f32); planted faults (K3 skipping one split or masking
           one key short, K4 skipping one key tile for the last query rows,
           K6 one group's anchor off by one bin) must fail that rule; K5 on
           exact half-bin deltas (half to even) and clipped ones; kernel,
           plain and library-yardstick times (CUDA events) and the least
           time the card could take (bytes over 3.35 TB/s vs flops over
           989 TFLOP/s).
4. serve   smollm-360m at full width (random bf16 weights from a seed):
           four requests go through ``calculate_kv`` (K4), their KV is
           profiled and encoded at every level in 1536-token chunks (K5),
           one ``decode_chunk_runs`` call rebuilds all four requests' runs at
           mixed levels (K1 + K2, bf16 out) and is held to the unfused
           ``decode_chunk`` (K6), ``insert_runs`` lands them in a 4-row cache
           and ``generate_with_kv`` produces 32 tokens (K3).
5. text    one request loads chunk 0 from its bitstream (``decode_to_cache``),
           recomputes chunk 1 as TEXT (``prefill_extend``) and generates.
6. store   CacheGen's offline + online flow on the same model and tables:
           a 6144-token context (``calculate_kv``) is stored as four
           1536-token chunks at every level (``CacheGenStreamer.
           store_from_caches`` -> ``KVStore.store_kv``, K5); ``stream()``
           plans it under a bandwidth dip with an SLO (Algorithm 1, stated
           rates); the plan must hold two levels and a TEXT chunk; it is
           materialized fused (K1/K2, TEXT through K4) and ``fused=False``
           (K6), the two caches compared chunk by chunk, and each generates
           32 tokens (K3).  The plan Algorithm 1 gives from the card's own
           rates (serve phase) is printed beside it.

The kernels' launch counters are zeroed before phase 4 and read after phase
5, and zeroed again before phase 6 and read after it; the run fails if a
kernel of either path was not launched in it.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Needs one CUDA card; exits 2 with no result when there is none.
"""
import contextlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import codec, quant  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_SIZE,
    decode_attention_cuda,
    decode_attention_plain,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain  # noqa: E402
from repro_torch.kernels.kvquant import (  # noqa: E402
    kv_dequant_cuda,
    kv_dequant_plain,
    kv_dequant_tokens_cuda,
    kv_dequant_tokens_plain,
    kv_lossless_tokens_cuda,
    kv_lossless_tokens_plain,
    kv_quant_cuda,
    kv_quant_plain,
)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.kv_layout import caches_to_codec_kv  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    TEXT,
    BandwidthTrace,
    CacheGenStreamer,
    KVStore,
    NetworkModel,
)

SEED = 0
CONTEXTS = (3072, 3000, 2048, 1536)
CHUNK = 1536
CAPACITY = 4096
GEN_TOKENS = 32
TEXT_TOKENS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
# phase 6: four chunks, and the stated scenario Algorithm 1 plans under.  The
# link's nominal rate (the prior estimate) is LINK_GBPS, but it dips to
# DIP_GBPS for the first DIP_S seconds, so chunk 0 (level 0, from the prior)
# lands late; the throughput measured on it rules out the finer levels for
# chunk 1, and once chunk 1 is in, the recompute of the two remaining chunks
# fits the SLO, so both go as TEXT.  The decisions depend on these constants
# alone, not on the chunks' byte counts: the dip moves under 1 KB, and at
# LINK_GBPS every chunk lands within milliseconds.
STORE_CHUNKS = 4
SLO_S = 3.2
DIP_S, DIP_GBPS, LINK_GBPS = 1.0, 1e-6, 100.0
RECOMPUTE_S_PER_CHUNK = 0.9  # 3 chunks (2.7 s) miss the 2.2 s left, 2 (1.8 s) fit
DECODE_BYTES_PER_S = 1e9


class Phase:
    """Prints a phase's banner and records its wall time with CUDA events
    (after a synchronize) into ``times``."""

    def __init__(self, name, times):
        self.name, self.times = name, times

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        torch.cuda.synchronize()
        self.a = torch.cuda.Event(enable_timing=True)
        self.b = torch.cuda.Event(enable_timing=True)
        self.a.record()

    def __exit__(self, *exc):
        self.b.record()
        torch.cuda.synchronize()
        self.times[self.name] = self.a.elapsed_time(self.b)
        return False


class Laps:
    """Host wall time between successive ``lap`` calls, each taken after the
    device's queued work has finished, to split a phase into its steps."""

    def __init__(self, device):
        self.device = device
        self.ms = {}
        self.t = time.perf_counter()

    def lap(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.ms[name] = round(1e3 * (now - self.t), 1)
        self.t = now


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def drive_main_path(cfg, dev, gen, phase=lambda name: contextlib.nullcontext(),
                    lengths=CONTEXTS, chunk=CHUNK, capacity=CAPACITY):
    """Phases 4 and 5: the port's entry points as a user calls them.

    ``phase(name)`` gives the context manager that times each phase.
    ``lengths``/``chunk``/``capacity`` default to the main-path sizes; the
    port's tests run the same function at a tiny size on the CPU (with the
    kernels' plain versions) to rehearse it without a card.
    """
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    C = Hkv * D
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]

    # ---------------------------------------------------------------- 4 serve
    with phase("serve"):
        laps = Laps(dev)
        gen.manual_seed(SEED)
        params = lm.init_params(cfg, gen, dev)
        engine = Engine(cfg, params, cache_capacity=capacity, device=dev)
        contexts = [torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev) for T in lengths]
        laps.lap("init")
        firsts, exact, kvs = [], [], []
        for ctx in contexts:
            logits, caches = engine.calculate_kv({"tokens": ctx})
            require(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
            firsts.append(int(torch.argmax(logits[0, -1])))
            exact.append(caches)
            kvs.append(caches_to_codec_kv(caches, 0, ctx.shape[1]))
        laps.lap("calculate_kv x4")
        ct = codec.profile([kvs[0]], codec.CodecConfig(), device=dev)
        laps.lap("profile")
        blobs = [[codec.encode_all_levels(kv[:, :, s:s + chunk], ct, chunk_idx=j)
                  for j, s in enumerate(range(0, kv.shape[2], chunk))] for kv in kvs]
        laps.lap("encode_all_levels")
        n_tokens = sum(lengths)
        fp16 = codec.kv_nbytes_fp16(L, n_tokens, C)
        for lvl in range(ct.config.n_levels):
            size = sum(len(c[lvl]) for req in blobs for c in req)
            print(f"level {lvl}: {size} bytes for {n_tokens} tokens ({fp16 / size:.2f}x smaller than fp16)")
        # request 3 has one chunk, so the mixed-level run is request 2's
        levels = [[0, 0], [1, 1], [0, 2], [4]]
        runs = [[blobs[r][j][lvl] for j, lvl in enumerate(lv)] for r, lv in enumerate(levels)]
        kv_run, spans = codec.decode_chunk_runs(runs, ct, out_dtype=torch.bfloat16)
        laps.lap("decode_chunk_runs")
        require([n for _, n in spans] == list(lengths), f"spans {spans}")
        # the fused decode against the unfused oracle, chunk by chunk
        for (off, _), run, lv in zip(spans, runs, levels):
            for blob, lvl in zip(run, lv):
                oracle = codec.decode_chunk(blob, ct)
                got = kv_run[:, :, off:off + oracle.shape[2]]
                if lvl == 0:
                    require(torch.equal(got, oracle.to(torch.bfloat16)), "level-0 decode is not bit-exact")
                else:
                    x = ops.bf16_ulp_excess(got, oracle, **k1_tol)
                    require(x <= 1, f"level-{lvl} decode is {x:.3g} times its tolerance off the oracle")
                off += oracle.shape[2]
        laps.lap("decode_chunk oracle checks")
        caches = engine.insert_runs(engine.empty_caches(len(lengths)), kv_run, list(range(len(lengths))),
                                    [0] * len(lengths), [n for _, n in spans])
        laps.lap("insert_runs")
        require(caches.length.tolist() == list(lengths), f"cache lengths {caches.length.tolist()}")
        for r, (off, n) in enumerate(spans):
            require(torch.equal(caches.kv_k[:, r, :n], kv_run[:, 0, off:off + n].reshape(L, n, Hkv, D)),
                    f"row {r} does not hold its run")
            err = (kv_run[:, :, off:off + n].float() - kvs[r]).abs().max().item()
            print(f"request {r}: levels {levels[r]}  max |decoded - exact KV| {err:.4f}")
        first = torch.tensor(firsts, device=dev)
        laps.lap("checks")
        gen_cg = engine.generate_with_kv(caches, first, GEN_TOKENS)
        laps.lap(f"generate_with_kv {GEN_TOKENS} tokens, batch {len(lengths)}")
        ref_caches = engine.empty_caches(len(lengths))
        for r, c in enumerate(exact):
            ref_caches.kv_k[:, r] = c.kv_k[:, 0]
            ref_caches.kv_v[:, r] = c.kv_v[:, 0]
        ref_caches = ref_caches._replace(length=torch.tensor(lengths, dtype=torch.int32, device=dev))
        gen_ref = engine.generate_with_kv(ref_caches, first, GEN_TOKENS)
        laps.lap("generate from the exact caches")
        require(gen_cg.shape == (len(lengths), GEN_TOKENS), f"generated {gen_cg.shape}")
        require(((gen_cg >= 0) & (gen_cg < cfg.padded_vocab_size)).all(), "token ids out of range")
        for r in range(len(lengths)):
            print(f"request {r}: token agreement with the exact cache {(gen_cg[r] == gen_ref[r]).mean():.2%} "
                  "(random weights: informational)")
        print("serve steps ms:", laps.ms)

    # ----------------------------------------------------------------- 5 text
    with phase("text"):
        c1 = engine.decode_to_cache(engine.empty_caches(1),
                                    codec.decode_chunks([blobs[0][0][1]], ct, out_dtype=torch.bfloat16), 0)
        logits, c1 = engine.prefill_extend(contexts[0][:, chunk:2 * chunk], c1)
        require(bool(torch.isfinite(logits).all()), "TEXT recompute logits are not finite")
        require(c1.length.tolist() == [2 * chunk], f"length after TEXT {c1.length.tolist()}")
        err = (c1.kv_k[:, 0, chunk:2 * chunk].float() - exact[0].kv_k[:, 0, chunk:2 * chunk].float()).abs().max()
        out = engine.generate_with_kv(c1, torch.argmax(logits[:, -1], dim=-1), TEXT_TOKENS)
        print(f"TEXT chunk K vs exact prefill: max abs diff {err.item():.4f}; generated {out[0].tolist()}")

    # this device's own rates, for the plan Algorithm 1 gives from them
    wire = sum(len(b) for run in runs for b in run)
    return {
        "params": params,
        "tables": ct,
        "decode_bytes_per_s": wire / (laps.ms["decode_chunk_runs"] / 1e3),
        "prefill_s_per_token": laps.ms["calculate_kv x4"] / 1e3 / sum(lengths),
    }


def drive_store_path(cfg, dev, gen, served, phase=lambda name: contextlib.nullcontext(),
                     chunk=CHUNK, n_chunks=STORE_CHUNKS, gen_tokens=GEN_TOKENS):
    """Phase 6: store -> stream -> materialize -> generate_with_kv.

    ``served`` is what :func:`drive_main_path` returns: the model's weights,
    the profiled tables and the serve phase's measured rates.  The port's
    tests run it at a tiny size on the CPU, as they do the main path.
    """
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    n_ctx = n_chunks * chunk
    k1_tol = ops.BF16_TOL["kv_dequant_tokens"]
    with phase("store"):
        laps = Laps(dev)
        engine = Engine(cfg, served["params"], cache_capacity=n_ctx + gen_tokens, device=dev)
        gen.manual_seed(SEED + 6)
        tokens = torch.randint(0, cfg.vocab_size, (1, n_ctx), generator=gen, device=dev)
        logits, exact = engine.calculate_kv({"tokens": tokens})
        require(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
        laps.lap(f"calculate_kv {n_ctx} tokens")
        store = KVStore(served["tables"])
        streamer = CacheGenStreamer(store, cfg)
        metas = streamer.store_from_caches("ctx", exact, n_ctx, chunk_tokens=chunk)
        laps.lap("store_from_caches")
        require([(m.start, m.end) for m in metas] == [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)],
                f"chunks {[(m.start, m.end) for m in metas]}")
        for lvl in range(served["tables"].config.n_levels):
            print(f"stored level {lvl}: {store.total_bytes('ctx', lvl)} bytes for {n_ctx} tokens")
        net = NetworkModel(BandwidthTrace.steps(DIP_S, [DIP_GBPS, LINK_GBPS]))
        own = streamer.stream(
            "ctx", net, slo_s=SLO_S, decode_bytes_per_s=served["decode_bytes_per_s"],
            recompute_s=lambda n, p: served["prefill_s_per_token"] * n, prior_throughput_gbps=LINK_GBPS)
        print(f"plan from this device's own rates (decode {served['decode_bytes_per_s']:.4g} B/s, "
              f"recompute {served['prefill_s_per_token'] * chunk:.4g} s per chunk): "
              f"configs {own.result.configs}, TTFT {own.result.ttft_s:.4f} s (informational)")
        plan = streamer.stream(
            "ctx", net, slo_s=SLO_S, decode_bytes_per_s=DECODE_BYTES_PER_S,
            recompute_s=lambda n, p: RECOMPUTE_S_PER_CHUNK * n / chunk, prior_throughput_gbps=LINK_GBPS)
        configs = plan.result.configs
        laps.lap("stream x2")
        print(f"plan from the stated rates: configs {configs}, TTFT {plan.result.ttft_s:.4f} s "
              f"(SLO {SLO_S} s)")
        for t in plan.result.timelines:
            print(f"  chunk {t.chunk_idx}: config {t.config}  {t.nbytes:.0f} bytes  fetch "
                  f"{t.fetch_start:.4f}-{t.fetch_end:.4f} s  compute {t.compute_start:.4f}-{t.compute_end:.4f} s")
        require(len({c for c in configs if c != TEXT}) >= 2 and TEXT in configs,
                f"the plan {configs} does not hold two levels and a TEXT chunk")
        fused = streamer.materialize(plan, engine, tokens)
        laps.lap("materialize fused")
        unfused = streamer.materialize(plan, engine, tokens, fused=False)
        laps.lap("materialize fused=False")
        for c in (fused, unfused):
            require(c.length.tolist() == [n_ctx], f"materialized length {c.length.tolist()}")
        for m, cfg_i in zip(metas, configs):
            sl = slice(m.start, m.end)
            a = torch.stack([fused.kv_k[:, 0, sl], fused.kv_v[:, 0, sl]])
            b = torch.stack([unfused.kv_k[:, 0, sl], unfused.kv_v[:, 0, sl]])
            want = torch.stack([exact.kv_k[:, 0, sl], exact.kv_v[:, 0, sl]]).float()
            diff = (a.float() - b.float()).abs().max().item()
            if cfg_i == 0:
                require(torch.equal(a, b), f"chunk {m.chunk_idx}: level-0 materialize modes differ")
            elif cfg_i != TEXT:
                x = ops.bf16_ulp_excess(a, b, **k1_tol)
                require(x <= 1, f"chunk {m.chunk_idx}: level-{cfg_i} modes are {x:.3g} times K1's rule apart")
            print(f"chunk {m.chunk_idx} ({'TEXT' if cfg_i == TEXT else f'level {cfg_i}'}): fused vs fused=False "
                  f"max abs diff {diff:.4g}; fused vs exact KV {(a.float() - want).abs().max().item():.4f}")
        laps.lap("checks")
        first = torch.argmax(logits[:, -1], dim=-1)
        outs = [engine.generate_with_kv(c, first, gen_tokens) for c in (fused, unfused)]
        laps.lap(f"generate_with_kv {gen_tokens} tokens x2")
        for o in outs:
            require(o.shape == (1, gen_tokens), f"generated {o.shape}")
            require(((o >= 0) & (o < cfg.padded_vocab_size)).all(), "token ids out of range")
        print(f"token agreement fused vs fused=False {(outs[0] == outs[1]).mean():.2%} (informational)")
        print("store steps ms:", laps.ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_ms = {}

    def time_ms(fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, *kernel_names, iters=5):
        """Mean device time per call of the named kernels, from the profiler's
        CUDA trace; None where the trace holds no device time for them."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                 if any(k in e.key for k in kernel_names))
        return us / iters / 1e3 if us else None

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    gen = torch.Generator(device=dev)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def randint(lo, hi, *shape, dtype=torch.uint16):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)

    # ------------------------------------------------------------------ 1 env
    with Phase("env", phase_ms):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
        print(smi)
        print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")

    # ---------------------------------------------------------------- 2 build
    with Phase("build", phase_ms):
        t0 = time.perf_counter()
        _build.load_library()
        print(f"built and loaded the kernel library in {time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------------------- 3 kernels
    cfg = registry.get("smollm-360m")
    L, Hq, Hkv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    C, g = Hkv * D, codec.CodecConfig().group_size
    G = -(-CHUNK // g)
    report, excess, controls = {}, {}, {}
    with Phase("kernels", phase_ms):
        gen.manual_seed(SEED + 7)

        # K1: the serve phase's lossy chunks (4 chunks x L x 2), bf16 out;
        # ragged: a 1464-token chunk (G = 147) and f32 out
        def k1_case(B, Gc, out_dtype):
            d = randint(0, 255, B, Gc, g - 1, C)
            a = randn(B, Gc, C, dtype=torch.float32)
            bins = torch.rand(B, generator=gen, device=dev) * 0.2 + 0.01
            got = kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=out_dtype)
            want = kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=out_dtype)
            err = (got.float() - want.float()).abs().max().item()
            if out_dtype == torch.bfloat16:
                x = ops.bf16_ulp_excess(got, want, **ops.BF16_TOL["kv_dequant_tokens"])
                require(x <= 1, f"K1 bf16 is {x:.3g} times its tolerance off ({err})")
                excess["kv_dequant_tokens"] = max(excess.get("kv_dequant_tokens", 0.0), x)
            else:
                require(err <= 2e-5, f"K1 f32 error {err} > 2e-5")
            return (d, a, bins), err

        (d, a, bins), e1 = k1_case(4 * L * 2, G, torch.bfloat16)
        _, e2 = k1_case(L * 2, 147, torch.float32)
        _, e3 = k1_case(L * 2, 147, torch.bfloat16)
        B = d.shape[0]
        nb = d.numel() * 2 + a.numel() * 4 + bins.numel() * 4 + B * G * g * C * 2
        report["kv_dequant_tokens"] = dict(
            max_abs_err=max(e1, e2, e3),
            ms=time_ms(lambda: kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=torch.bfloat16)),
            device_ms=device_ms(lambda: kv_dequant_tokens_cuda(d, a, bins, qmax=127, out_dtype=torch.bfloat16),
                                "dequant_tokens_kernel"),
            plain_ms=time_ms(lambda: kv_dequant_tokens_plain(d, a, bins, qmax=127, out_dtype=torch.bfloat16)),
            library_ms=None,
            bound=bound(nb, 3 * d.numel()),
            shape=f"d_sym {tuple(d.shape)} uint16 -> bf16",
        )

        # K2: the serve phase's level-0 chunks (3 x L x 2); ragged G = 52
        def k2_case(B, Gc, out_dtype):
            d = randint(0, 509, B, Gc, g - 1, C)
            a = randint(1, 256, B, Gc, C)
            s = (torch.rand(B, Gc, generator=gen, device=dev) * 0.05 + 1e-3).half().float()
            got = kv_lossless_tokens_cuda(d, a, s, out_dtype=out_dtype)
            want = kv_lossless_tokens_plain(d, a, s, out_dtype=out_dtype)
            require(torch.equal(got, want), f"K2 is not bit-exact ({out_dtype})")
            return (d, a, s), (got.float() - want.float()).abs().max().item()

        (d, a, s), e1 = k2_case(3 * L * 2, G, torch.bfloat16)
        _, e2 = k2_case(L * 2, 52, torch.float32)
        B = d.shape[0]
        nb = d.numel() * 2 + a.numel() * 2 + s.numel() * 4 + B * G * g * C * 2
        report["kv_lossless_tokens"] = dict(
            max_abs_err=max(e1, e2),
            ms=time_ms(lambda: kv_lossless_tokens_cuda(d, a, s, out_dtype=torch.bfloat16)),
            device_ms=device_ms(lambda: kv_lossless_tokens_cuda(d, a, s, out_dtype=torch.bfloat16),
                                "lossless_tokens_kernel"),
            plain_ms=time_ms(lambda: kv_lossless_tokens_plain(d, a, s, out_dtype=torch.bfloat16)),
            library_ms=None,
            bound=bound(nb, 2 * a.numel() + 3 * d.numel()),
            shape=f"d_sym {tuple(d.shape)} uint16 -> bf16",
        )

        # K3: 4 rows of the 4096-slot cache at the first generated token's
        # lengths; ragged lengths {0, 1, 2999, 4096}.  Timed over 8 layer
        # slices (168 MB of K/V) so every launch reads its cache from HBM.
        sdpa = torch.nn.functional.scaled_dot_product_attention
        gqa_ok = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
        Bd = len(CONTEXTS)
        kc = randn(8, Bd, CAPACITY, Hkv, D)
        vc = randn(8, Bd, CAPACITY, Hkv, D)
        q = randn(Bd, Hq, D)
        lens_main = torch.tensor([t + 1 for t in CONTEXTS], dtype=torch.int32, device=dev)
        tol3 = ops.BF16_TOL["decode_attention"]
        kf, vf = kc[0].float(), vc[0].float()
        err3 = 0.0
        for lens in (torch.tensor([0, 1, 2999, 4096], dtype=torch.int32, device=dev), lens_main):
            got = decode_attention_cuda(q, kc[0], vc[0], lens)
            want = decode_attention_plain(q.float(), kf, vf, lens)
            if lens is not lens_main:
                require(not got[0].float().any(), "K3: a row with kv_len 0 must output 0")
            x = ops.bf16_ulp_excess(got, want, **tol3)
            require(x <= 1, f"K3 is {x:.3g} times its tolerance off its plain version")
            err3 = max(err3, (got.float() - want).abs().max().item())
            excess["decode_attention"] = max(excess.get("decode_attention", 0.0), x)
        # planted faults the rule must catch, on the main lengths (want is
        # theirs): the split of keys 1024..1151 skipped, and one key masked off
        cut = lambda x: torch.cat([x[:, :1024], x[:, 1024 + SPLIT_SIZE:]], dim=1)  # noqa: E731
        faults = {
            "split skipped": decode_attention_plain(q.float(), cut(kf), cut(vf), lens_main - SPLIT_SIZE),
            "kv_len - 1": decode_attention_plain(q.float(), kf, vf, lens_main - 1),
        }
        controls["decode_attention"] = {n: ops.bf16_ulp_excess(f.bfloat16(), want, **tol3)
                                        for n, f in faults.items()}
        require(min(controls["decode_attention"].values()) > 1,
                f"K3's rule misses a planted fault: {controls['decode_attention']}")
        del kf, vf, faults
        it = itertools.count()

        def k3():
            i = next(it) % 8
            return decode_attention_cuda(q, kc[i], vc[i], lens_main)

        def k3_lib():
            i = next(it) % 8
            mask = (torch.arange(CAPACITY, device=dev)[None, :] < lens_main[:, None])[:, None, None, :]
            return sdpa(q[:, :, None], kc[i].transpose(1, 2), vc[i].transpose(1, 2),
                        attn_mask=mask, enable_gqa=True)

        n_tok = int(lens_main.sum())
        nb = q.numel() * 2 * 2 + n_tok * Hkv * D * 2 * 2 + Bd * 4
        report["decode_attention"] = dict(
            max_abs_err=err3,
            ms=time_ms(k3, iters=40),
            device_ms=device_ms(k3, "split_kernel", "combine_kernel", iters=16),
            plain_ms=time_ms(lambda: decode_attention_plain(q, kc[0], vc[0], lens_main)),
            library_ms=time_ms(k3_lib, iters=40) if gqa_ok else None,
            bound=bound(nb, 4 * Hq * D * n_tok),
            shape=f"q {tuple(q.shape)} vs cache {tuple(kc[0].shape)} bf16, kv_len {lens_main.tolist()}",
        )

        # K4: one request's 3072-token prefill; ragged T = 3000; prefix-LM
        tol4 = ops.BF16_TOL["flash_attention"]

        def k4_case(B, T, prefix=None):
            qq, kk, vv = randn(B, T, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)
            plen = None if prefix is None else torch.tensor(prefix, dtype=torch.int32, device=dev)
            got = flash_attention_cuda(qq, kk, vv, plen)
            want = flash_attention_plain(qq.float(), kk.float(), vv.float(), plen)
            x = ops.bf16_ulp_excess(got, want, **tol4)
            require(x <= 1, f"K4 is {x:.3g} times its tolerance off its plain version (T={T}, prefix={prefix})")
            excess["flash_attention"] = max(excess.get("flash_attention", 0.0), x)
            return (qq, kk, vv), want, (got.float() - want).abs().max().item()

        (qq, kk, vv), want, e1 = k4_case(1, CONTEXTS[0])
        T = CONTEXTS[0]
        # planted fault: the last 64 query rows skip the 32-key tile at 1024
        cut = lambda x: torch.cat([x[:, :1024], x[:, 1024 + 32:]], dim=1).float()  # noqa: E731
        bad = want.clone()
        bad[:, T - 64:] = flash_attention_plain(qq[:, T - 64:].float(), cut(kk), cut(vv))
        controls["flash_attention"] = {"tile skipped": ops.bf16_ulp_excess(bad.bfloat16(), want, **tol4)}
        require(controls["flash_attention"]["tile skipped"] > 1,
                f"K4's rule misses a planted fault: {controls['flash_attention']}")
        del want, bad
        _, _, e2 = k4_case(1, 3000)
        _, _, e3 = k4_case(2, 1024, [100, 700])
        pairs = T * (T + 1) // 2
        nb = (qq.numel() * 2 + kk.numel() + vv.numel()) * 2
        report["flash_attention"] = dict(
            max_abs_err=max(e1, e2, e3),
            ms=time_ms(lambda: flash_attention_cuda(qq, kk, vv)),
            device_ms=device_ms(lambda: flash_attention_cuda(qq, kk, vv), "flash_kernel"),
            plain_ms=time_ms(lambda: flash_attention_plain(qq, kk, vv), iters=3, warmup=1),
            library_ms=time_ms(lambda: sdpa(qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                                            is_causal=True, enable_gqa=True)) if gqa_ok else None,
            bound=bound(nb, 4 * D * Hq * pairs),
            shape=f"q {tuple(qq.shape)} k/v {tuple(kk.shape)} bf16 causal",
        )
        # K5: the store's shape, (L * 2, 154, 10, 320) f32 grouped tokens,
        # at each lossy level's bins (a random delta scale); ragged G = 147;
        # then planted deltas of exactly k + 1/2 bins, which rintf rounds to
        # even and roundf away from zero, and deltas past +-qmax bins
        cc = codec.CodecConfig()
        qmax = cc.delta_qmax
        dscale = (torch.rand(L, 2, generator=gen, device=dev) + 0.5).cpu().numpy()
        level_bins = [torch.as_tensor(quant.effective_bins(L, cc.layer_group_bins, m, dscale), device=dev).reshape(-1)
                      for m in cc.level_mults]

        def k5_case(Gc, bins):
            kv = torch.randn(L * 2, Gc, g, C, generator=gen, device=dev).cumsum(dim=2)  # token-correlated
            got = kv_quant_cuda(kv, bins, qmax=qmax)
            require(torch.equal(got, kv_quant_plain(kv, bins, qmax=qmax)),
                    f"K5 is not bit-exact with its plain version (G={Gc})")
            return kv

        for bins in level_bins:
            kv5 = k5_case(G, bins)
        k5_case(147, level_bins[0])
        halves = [k + 0.5 for k in range(-8, 8)]
        clipped = [qmax + 0.5, qmax + 40.0, -qmax - 0.5, -1e6]
        t = torch.tensor([halves[j % len(halves)] for j in range(C)])
        u = torch.tensor([clipped[j % len(clipped)] for j in range(C)])
        kv = torch.full((2, 1, g, C), 3.0)
        kv[0, 0, 1:] += t * 0.25  # bin 0.25: every value and delta exact in f32
        kv[1, 0, 1:] += u * 0.25
        bins = torch.full((2,), 0.25, device=dev)
        got = kv_quant_cuda(kv.to(dev), bins, qmax=qmax)
        want = torch.tensor([[max(-qmax, min(qmax, round(x))) + qmax for x in row.tolist()] for row in (t, u)])
        require(torch.equal(got[:, 0].int().cpu(), want[:, None, :].expand(2, g - 1, C).int()),
                "K5 does not round half to even or clip as the reference does")
        require(torch.equal(got, kv_quant_plain(kv.to(dev), bins, qmax=qmax)), "K5 planted ties: kernel != plain")
        B = kv5.shape[0]
        nb = kv5.numel() * 4 + B * 4 + B * G * (g - 1) * C * 2
        report["kv_quant"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: kv_quant_cuda(kv5, level_bins[0], qmax=qmax)),
            device_ms=device_ms(lambda: kv_quant_cuda(kv5, level_bins[0], qmax=qmax), "quant_kernel"),
            plain_ms=time_ms(lambda: kv_quant_plain(kv5, level_bins[0], qmax=qmax)),
            library_ms=None,
            bound=bound(nb, 6 * B * G * (g - 1) * C),
            shape=f"kv {tuple(kv5.shape)} f32 -> uint16, 4 levels' bins, ties and clips planted",
        )
        del kv5

        # K6: the store's shape, f32 out (the unfused decode's) and bf16;
        # ragged G = 147; planted fault: one group's anchor off by one bin
        tol6 = ops.BF16_TOL["kv_dequant"]

        def k6_case(Gc, out_dtype):
            d = randint(0, 2 * qmax + 1, L * 2, Gc, g - 1, C)
            a = randn(L * 2, Gc, C, dtype=torch.float32)
            bins = level_bins[1]
            got = kv_dequant_cuda(d, a, bins, qmax=qmax, out_dtype=out_dtype)
            want = kv_dequant_plain(d, a, bins, qmax=qmax, out_dtype=out_dtype)
            if out_dtype == torch.float32:
                require(torch.equal(got, want), f"K6 f32 is not bit-exact with its plain version (G={Gc})")
            else:
                x = ops.bf16_ulp_excess(got, want, **tol6)
                require(x <= 1, f"K6 bf16 is {x:.3g} times its tolerance off (G={Gc})")
                excess["kv_dequant"] = max(excess.get("kv_dequant", 0.0), x)
            return (d, a, bins), want, (got.float() - want.float()).abs().max().item()

        (d6, a6, b6), _, e1 = k6_case(G, torch.float32)
        errs6 = [e1] + [k6_case(Gc, dt)[2] for Gc, dt in ((147, torch.float32), (G, torch.bfloat16),
                                                          (147, torch.bfloat16))]
        want = kv_dequant_plain(d6, a6, b6, qmax=qmax, out_dtype=torch.bfloat16)
        a_bad = a6.clone()
        a_bad[3, 5] += b6[3]
        bad = kv_dequant_plain(d6, a_bad, b6, qmax=qmax, out_dtype=torch.bfloat16)
        controls["kv_dequant"] = {"anchor off by one bin": ops.bf16_ulp_excess(bad, want, **tol6)}
        require(controls["kv_dequant"]["anchor off by one bin"] > 1,
                f"K6's rule misses a planted fault: {controls['kv_dequant']}")
        del want, a_bad, bad
        B = d6.shape[0]
        nb = d6.numel() * 2 + a6.numel() * 4 + B * 4 + d6.numel() * 4
        report["kv_dequant"] = dict(
            max_abs_err=max(errs6),
            ms=time_ms(lambda: kv_dequant_cuda(d6, a6, b6, qmax=qmax, out_dtype=torch.float32)),
            device_ms=device_ms(lambda: kv_dequant_cuda(d6, a6, b6, qmax=qmax, out_dtype=torch.float32),
                                "dequant_kernel"),
            plain_ms=time_ms(lambda: kv_dequant_plain(d6, a6, b6, qmax=qmax, out_dtype=torch.float32)),
            library_ms=None,
            bound=bound(nb, 3 * d6.numel()),
            shape=f"d_sym {tuple(d6.shape)} uint16 -> f32",
        )
        del d6, a6

        for name, r in report.items():
            if name in excess:
                print(f"{name}: worst error {excess[name]:.3f} of the tolerance {ops.BF16_TOL[name]}; "
                      f"planted faults {controls.get(name, 'none')}")
            print(f"{name}: {r['shape']}  max_abs_err {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms  "
                  f"(device time {r['device_ms']} ms)  "
                  f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']}  "
                  f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it reached)")
        del kc, vc

    # --------------------------------------------------------- 4 serve, 5 text
    ops.reset_launch_counts()
    served = drive_main_path(cfg, dev, gen, phase=lambda name: Phase(name, phase_ms))
    paths = {"serve + text": ops.launch_counts()}

    # --------------------------------------------------------------- 6 store
    ops.reset_launch_counts()
    drive_store_path(cfg, dev, gen, served, phase=lambda name: Phase(name, phase_ms))
    paths["store"] = ops.launch_counts()

    # ------------------------------------------------------------ 7 summary
    for path, counts in paths.items():
        print(f"launches on the {path} path:", counts)
        for name, n in counts.items():
            require(n > 0, f"kernel {name} was not launched on the {path} path")
    counts = {name: sum(c[name] for c in paths.values()) for name in ops.KERNELS}
    print("phase ms:", {k: round(v, 1) for k, v in phase_ms.items()})
    meta = {
        "kv_dequant_tokens": ("kvquant.cu", "src/repro/kernels/kvquant.py:116"),
        "kv_lossless_tokens": ("kvquant.cu", "src/repro/kernels/kvquant.py:166"),
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:85"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:109"),
        "kv_quant": ("kvquant.cu", "src/repro/kernels/kvquant.py:209"),
        "kv_dequant": ("kvquant.cu", "src/repro/kernels/kvquant.py:76"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
