"""Batched serving with CacheGen context loading.

Port of ``examples/serve_batched.py`` onto ``repro_torch``.  Simulates a
serving node receiving a stream of requests that reuse a pool of long
contexts (RAG-style).  For every request the engine either
  * recomputes prefill from text (cold / CacheGen-off), or
  * fetches the context's KV bitstream via CacheGen over a fluctuating link,
then generates a batched response.  Reports per-request TTFT (simulated
network + measured decode) and answer quality for both paths.  The weights
come from a torch generator seeded 0 (the reference's lines, other values).

Usage:  PYTHONPATH=src python examples/torch/serve_batched.py [--requests 8] [--device cpu]
(the CUDA card unless ``--device`` names another).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import registry
from repro_torch.core import codec as kvcodec
from repro_torch.data import MarkovLM, TopicRetrievalTask
from repro_torch.models import build
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_layout import caches_to_codec_kv
from repro_torch.streaming import BandwidthTrace, CacheGenStreamer, KVStore, NetworkModel
from repro_torch.streaming.adaptation import TEXT


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--contexts", type=int, default=3)
    ap.add_argument("--ctx-len", type=int, default=400)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get("smollm-360m").tiny()
    model = build(cfg)
    params = model.init_params(torch.Generator(dev).manual_seed(0), dev)
    engine = Engine(cfg, params, cache_capacity=args.ctx_len + 32, device=dev)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=4)
    task = TopicRetrievalTask(lm=lm)
    rng = np.random.default_rng(1)

    # -- context pool: prefill once, store encoded (the paper's store_kv) ----
    ctxs = [task.make_context(rng, args.ctx_len)[0] for _ in range(args.contexts)]
    kvs = []
    for ctx in ctxs:
        _, caches = engine.calculate_kv({"tokens": torch.as_tensor(ctx[None], device=dev)})
        kvs.append(caches_to_codec_kv(caches, 0, args.ctx_len))
    tables = kvcodec.profile(kvs, kvcodec.CodecConfig(precision=11), device=dev)
    store = KVStore(tables)
    streamer = CacheGenStreamer(store, cfg)
    for i, kv in enumerate(kvs):
        store.store_kv(f"ctx{i}", kv, chunk_tokens=100)
    print(f"[pool] {args.contexts} contexts stored "
          f"({store.total_bytes('ctx0', 1)/1e3:.1f} KB each @ level 1)")

    # -- request loop ---------------------------------------------------------
    names = {TEXT: "TEXT"}
    for r in range(args.requests):
        cid = int(rng.integers(0, args.contexts))
        trace = BandwidthTrace.sampled(rng, 6, 0.05, 0.05, 2.0)
        net = NetworkModel(trace, rtt_s=0.002)
        t0 = time.perf_counter()
        plan = streamer.stream(
            f"ctx{cid}", net, slo_s=0.25, decode_bytes_per_s=300e6,
            recompute_s=lambda toks, pre: 0.02 * toks / 100,
            prior_throughput_gbps=float(trace.gbps[0]),
        )
        mat = streamer.materialize(plan, engine, ctxs[cid][None], batch=1)
        wall = time.perf_counter() - t0
        logits, caches_ref = engine.calculate_kv({"tokens": torch.as_tensor(ctxs[cid][None], device=dev)})
        first = torch.argmax(logits[:, -1], -1).to(torch.int32)
        gen_cg = engine.generate_with_kv(mat, first, args.gen)
        gen_ref = engine.generate_with_kv(caches_ref, first, args.gen)
        agree = float((gen_cg == gen_ref).mean())
        cfgs = [names.get(c, f"L{c}") for c in plan.result.configs]
        print(
            f"[req {r}] ctx{cid} configs={cfgs} ttft_sim={plan.result.ttft_s*1e3:6.1f} ms "
            f"(SLO ok={not plan.result.slo_violated}) wall={wall:.2f}s agree={agree:.0%}"
        )


if __name__ == "__main__":
    main()
