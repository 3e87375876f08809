"""End-to-end behaviour of the port's CacheGen system, on the port alone.

The port of ``tests/test_system.py``: train a tiny model (``repro_torch.
training.Trainer``, checkpointed) -> prefill real contexts -> profile codec
tables -> store multi-level bitstreams -> stream under an adverse bandwidth
trace with SLO adaptation -> materialize (mixed codec/text chunks) ->
generate, with the reference's three assertions: the trained KV cache has
token locality, the pipeline keeps TTFT within the SLO, greedy agreement
and level-1 compression against fp16, and the trainer recovers from
preemption.  Everything runs on the CPU through the kernels' plain
versions; the weights come from a torch generator, so the numbers are the
port's own, held to the reference's bounds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import codec as kvcodec
from repro_torch.data import MarkovLM
from repro_torch.models import build
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_layout import caches_to_codec_kv
from repro_torch.streaming import BandwidthTrace, CacheGenStreamer, KVStore, NetworkModel
from repro_torch.training import AdamWConfig, Trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = tmp_path_factory.mktemp("sys")
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), prerope_kv_cache=True)
    model = build(cfg)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=2, stickiness=0.6)

    def batch_fn(step):
        rng = np.random.default_rng(500 + step)
        toks = np.stack([lm.sample(rng, 49) for _ in range(8)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    ck = CheckpointManager(str(d / "ckpt"), keep=2)
    tr = Trainer(model=model, opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=10), batch_fn=batch_fn, ckpt=ck,
                 ckpt_every=25, log_every=10, log_fn=lambda s: None, device="cpu")
    state = tr.init_or_restore(0)
    state, hist = tr.run(state, 50)
    assert hist["loss"][-1] < hist["loss"][0], "training diverged"
    params = state.params
    eng = Engine(cfg, params, cache_capacity=160, device="cpu")
    rng = np.random.default_rng(0)
    tokens = np.stack([lm.sample(rng, 120) for _ in range(2)])
    return cfg, params, eng, tokens, tr, ck


def test_trained_kv_has_token_locality(system):
    """Insight 1 (paper Fig. 3: consecutive-token deltas have lower variance
    than raw values) holds on the trained model's real KV cache."""
    cfg, params, eng, tokens, *_ = system
    _, caches = eng.calculate_kv({"tokens": torch.as_tensor(tokens[:1])})
    kv = caches_to_codec_kv(caches, 0, tokens.shape[1]).numpy()
    d1 = np.diff(kv, axis=2)
    ratio = float(np.mean(kv.var(axis=2) / np.maximum(d1.var(axis=2), 1e-12)))
    assert ratio > 1.0, ratio


def test_full_cachegen_pipeline_quality(system):
    cfg, params, eng, tokens, *_ = system
    T = tokens.shape[1]
    logits, caches = eng.calculate_kv({"tokens": torch.as_tensor(tokens[:1])})
    kv = caches_to_codec_kv(caches, 0, T)
    ctab = kvcodec.profile([kv], kvcodec.CodecConfig(precision=10), device="cpu")
    store = KVStore(ctab)
    streamer = CacheGenStreamer(store, cfg)
    store.store_kv("ctx", kv, chunk_tokens=40)

    # bandwidth collapses mid-stream: expect level escalation or text
    net = NetworkModel(BandwidthTrace.steps(0.004, [1.0, 1.0, 0.02, 0.02, 0.5]))
    plan = streamer.stream("ctx", net, slo_s=0.5, decode_bytes_per_s=200e6, recompute_s=lambda t, p: 0.03,
                           prior_throughput_gbps=1.0)
    assert plan.result.ttft_s <= 0.5 * 1.05

    mat = streamer.materialize(plan, eng, tokens[:1], batch=1)
    assert int(mat.length[0]) == T
    first = torch.argmax(logits[:, -1], -1)
    gen_ref = eng.generate_with_kv(caches, first, 10)
    gen = eng.generate_with_kv(mat, first, 10)
    assert (gen_ref == gen).mean() >= 0.5

    # compression vs fp16 must be real on trained KV at the default level
    fp16 = kvcodec.kv_nbytes_fp16(kv.shape[0], T, kv.shape[3])
    total_l1 = store.total_bytes("ctx", 1)
    assert total_l1 < fp16 / 2.0, (total_l1, fp16)


def test_preemption_recovery_end_to_end(system):
    cfg, params, eng, tokens, tr, ck = system
    latest = ck.latest_step()
    assert latest is not None and latest >= 50
    state = tr.init_or_restore(0)
    assert int(state.step) == latest
    state, _ = tr.run(state, latest + 3)
    assert int(state.step) == latest + 3
