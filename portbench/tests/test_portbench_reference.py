"""The plain reference against the port's CPU path at small sizes in
float32: the context's KV, the codec's lossy transform, its calibration,
and the logits of a wave's question and stacked steps (the MoE's capacity
drops included)."""

import numpy as np
import pytest
import torch

from _tiny import tiny
from pbench.cell import _arch_config
from pbench.reference import CodecSpec, Reference, calibrate_delta_scale, lossy_kv
from pbench.weights import make_params

torch.set_grad_enabled(False)


def _model(workload, **arch):
    a, _ = tiny(workload, f32=True)
    a.update(arch)
    cfg = _arch_config(a)
    return a, cfg, make_params(cfg, 11, "cpu")


def _tokens(n, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("workload,arch", [
    ("smollm360m-gen-c32", {}),
    ("qwen2moe-gen-c8", {}),
    # 1,024 tokens over 8 experts at this factor: a capacity of 128 slots, half the slots dropped
    ("qwen2moe-gen-c8", {"capacity_factor": 0.25}),
])
def test_context_kv_matches_the_program(workload, arch):
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_layout import caches_to_codec_kv

    a, cfg, params = _model(workload, **arch)
    toks = _tokens(1024, cfg.vocab_size, 1)
    _, caches = Engine(cfg, params, cache_capacity=1024, device="cpu").calculate_kv({"tokens": torch.as_tensor(toks[None])})
    got = caches_to_codec_kv(caches, 0, 1024)
    want = Reference(a, params).context_kv(toks, q_block=256)
    assert _rel(got, want) < 1e-4


def test_lossy_transform_is_the_codecs_and_calibration_its_profiles():
    from repro_torch.core import codec

    a, cfg, params = _model("smollm360m-gen-c32")
    kv = Reference(a, params).context_kv(_tokens(200, cfg.vocab_size, 2))
    tables = codec.profile([kv[:, :, :128]], codec.CodecConfig(precision=11), device="cpu")
    ds = calibrate_delta_scale(kv[:, :, :128], 10)
    np.testing.assert_array_equal(ds, tables.delta_scale)
    spec = CodecSpec()
    for level in range(5):
        # chunks of 48 tokens, the last one short
        dec = torch.cat([codec.decode_chunk(codec.encode_chunk(kv[:, :, s:s + 48], tables, level), tables)
                         for s in range(0, 200, 48)], dim=2)
        mine, step = lossy_kv(kv, level, spec, ds, 48)
        assert torch.equal(dec, mine), level
        assert (step > 0).all() and step.shape == (kv.shape[0], 2, 200, 1)


@pytest.mark.parametrize("workload", ["smollm360m-gen-c32", "qwen2moe-gen-c8"])
def test_wave_logits_match_the_program(workload):
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_layout import alloc_caches

    a, cfg, params = _model(workload)
    B, Q, A = 3, 8, 5
    lens = [96, 130, 111]
    eng = Engine(cfg, params, cache_capacity=160, device="cpu")
    ref = Reference(a, params)
    # the engine's own row caches are bf16 whatever the model's dtype; f32 here
    caches = alloc_caches(cfg, B, 160, dtype=torch.float32, device="cpu")
    ctx = []
    for b, T in enumerate(lens):
        toks = _tokens(T, cfg.vocab_size, 10 + b)
        _, c = eng.calculate_kv({"tokens": torch.as_tensor(toks[None])})
        caches.kv_k[:, b], caches.kv_v[:, b] = c.kv_k[:, 0], c.kv_v[:, 0]
        kv = ref.context_kv(toks)
        ctx.append((lambda kv: (lambda l: kv[l]))(kv))
    caches = caches._replace(length=torch.tensor(lens, dtype=torch.int32))
    q = np.stack([_tokens(Q, cfg.vocab_size, 20 + b) for b in range(B)])
    logits, caches = eng.prefill_extend_rows(torch.as_tensor(q).long(), caches, [Q] * B)
    got = [logits[:, -1]]
    fed = _tokens(B * (A - 1), cfg.vocab_size, 30).reshape(B, A - 1)
    for s in range(A - 1):
        logits, caches = eng.decode_step_rows(torch.as_tensor(fed[:, s:s + 1]).long(), caches, torch.ones(B, dtype=torch.bool))
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)
    want = ref.answer_logits(ctx, Q, np.concatenate([q, fed], axis=1))
    assert want.shape == got.shape
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
