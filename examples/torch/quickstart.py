"""Quickstart: encode a KV cache with CacheGen, stream it, generate.

Port of ``examples/quickstart.py`` onto ``repro_torch``:
  1. builds a tiny llama-family model (smollm-360m reduced config),
  2. prefills a long synthetic context -> KV cache (K4 on the card),
  3. profiles codec tables + stores multi-level bitstreams (K5),
  4. streams them over a fluctuating simulated link with a TTFT SLO,
  5. decodes (K1/K2) and generates (K3) — comparing against the
     uncompressed cache.

The weights come from a torch generator seeded 0, so the tokens and sizes
differ from the reference example's; the lines are the same.

Usage:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(the CUDA card unless ``--device`` names another).
"""
import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import registry
from repro_torch.core import codec as kvcodec
from repro_torch.data import MarkovLM
from repro_torch.models import build
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_layout import caches_to_codec_kv
from repro_torch.streaming import BandwidthTrace, CacheGenStreamer, KVStore, NetworkModel
from repro_torch.streaming.adaptation import TEXT


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get("smollm-360m").tiny()
    model = build(cfg)
    params = model.init_params(torch.Generator(dev).manual_seed(0), dev)
    engine = Engine(cfg, params, cache_capacity=640, device=dev)

    # -- a long context ------------------------------------------------------
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=3)
    rng = np.random.default_rng(0)
    T = 600
    tokens = lm.sample(rng, T)[None]
    print(f"[1] context: {T} tokens")

    # -- calculate_kv (paper interface) --------------------------------------
    logits, caches = engine.calculate_kv({"tokens": torch.as_tensor(tokens, device=dev)})
    kv = caches_to_codec_kv(caches, 0, T)
    raw = kvcodec.kv_nbytes_fp16(*[kv.shape[i] for i in (0, 2, 3)])
    print(f"[2] KV cache: {tuple(kv.shape)} = {raw/1e6:.2f} MB fp16")

    # -- offline: profile tables + store every level --------------------------
    tables = kvcodec.profile([kv], kvcodec.CodecConfig(precision=11), device=dev)
    store = KVStore(tables)
    streamer = CacheGenStreamer(store, cfg)
    store.store_kv("ctx", kv, chunk_tokens=150)
    for lvl in range(tables.config.n_levels):
        tot = store.total_bytes("ctx", lvl)
        print(f"[3] level {lvl}: {tot/1e6:.3f} MB  ({raw/tot:.2f}x vs fp16)")

    # -- online: stream under a bandwidth drop with a 200 ms SLO --------------
    net = NetworkModel(BandwidthTrace.steps(0.03, [2.0, 2.0, 0.2, 0.1, 1.0]))
    plan = streamer.stream(
        "ctx", net, slo_s=0.2, decode_bytes_per_s=400e6,
        recompute_s=lambda toks, pre: 0.02 * toks / 150, prior_throughput_gbps=2.0,
    )
    names = {TEXT: "TEXT"}
    print(f"[4] per-chunk configs: {[names.get(c, f'L{c}') for c in plan.result.configs]}"
          f"  TTFT={plan.result.ttft_s*1e3:.1f} ms (SLO 200 ms, "
          f"violated={plan.result.slo_violated})")

    # -- generate_with_kv (paper interface) -----------------------------------
    mat = streamer.materialize(plan, engine, tokens, batch=1)
    first = torch.argmax(logits[:, -1], -1).to(torch.int32)
    gen_ref = engine.generate_with_kv(caches, first, 16)
    gen_cg = engine.generate_with_kv(mat, first, 16)
    agree = float((gen_ref == gen_cg).mean())
    print(f"[5] greedy tokens (exact cache):    {gen_ref[0].tolist()}")
    print(f"    greedy tokens (CacheGen cache): {gen_cg[0].tolist()}")
    print(f"    agreement: {agree:.2%}")


if __name__ == "__main__":
    main()
