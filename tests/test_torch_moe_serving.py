"""The MoE family through the port's engine and scheduler, against the
reference's, on ``qwen2-moe-a2.7b.tiny()`` in f32 with the reference's
weights and the same stored bytes (``_torch_session_world.build_world``).

The codec, the cache layout and the schedulers do not look at the FFN; what
changes is the model under them, whose TEXT recompute now depends on the
other rows of its batched call (capacity is set per call).  So the checks
are the engine's load-then-generate path and one ``ConcurrentScheduler``
wave that recomputes TEXT chunks in batched calls: configs, timelines,
counters, caches (level 0 bit for bit, lossy within 2e-5, TEXT within
1e-4) and greedy tokens equal the reference's
(``_torch_session_world.assert_same_scheduled``); and the simulator's
recompute price (``Engine.prefill_flops``) at the published widths.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import codec as jcodec
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import registry
from repro_torch.core import codec
from repro_torch.serving.engine import Engine

from _torch_session_world import TEXT, assert_same_scheduled, build_world, ideal, run_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return build_world("qwen2-moe-a2.7b")


@pytest.mark.parametrize("levels", [(0, 0, 0), (1, 3, 0)], ids=["level-0", "mixed"])
def test_decode_to_cache_then_generate_matches_reference(world, levels):
    """The stored chunks decoded into one cache (``decode_to_cache`` per
    run, the reference's blobs on both sides) and 8 greedy tokens from it."""
    port, ref = world["sides"]
    metas = world["metas"][:len(levels)]

    def load(side, decode):
        caches = side.eng.empty_caches(1)
        for m, lvl in zip(metas, levels):
            kv = decode([side.store.get_kv("ctx", m.chunk_idx, lvl)], side.tables)
            caches = side.eng.decode_to_cache(caches, kv, m.start)
        return caches

    c = load(port, lambda blobs, t: codec.decode_chunks(blobs, t, out_dtype=torch.float32))
    jc = load(ref, lambda blobs, t: jcodec.decode_chunks(blobs, t, out_dtype=jnp.float32))
    n = metas[-1].end
    assert int(c.length[0]) == int(np.asarray(jc.length)[0]) == n
    for got, want in ((c.kv_k, jc.kv_k), (c.kv_v, jc.kv_v)):
        got, want = got.numpy()[:, :, :n], np.asarray(want)[:, :, :n]
        if set(levels) == {0}:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    got = port.eng.generate_with_kv(c, torch.as_tensor(world["first"]), 8)
    want = ref.eng.generate_with_kv(jc, jnp.asarray(world["first"]), 8)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_wave_with_text_batches_matches_reference(world):
    """Four requests on four traces, no priors: levels and TEXT chunks mix,
    and TEXT chunks of several requests go through batched, width-masked
    ``prefill_extend_rows`` calls."""
    u = world["u"]
    traces = [("constant", (400 * u,)), ("steps", (0.2, [1.0 * u, 0.55 * u])),
              ("steps", (0.15, [2.0 * u, 0.4 * u, 2.0 * u, 0.4 * u])), ("constant", (3 * u,))]

    def scenario(side):
        return side.sched.ConcurrentScheduler(side.eng, contention=ideal(side)).run(
            [side.request(world["tokens"], tr, prior=False) for tr in traces])

    out, jout = run_both(world, scenario)
    assert_same_scheduled(world, out, jout)
    texts = [sum(c == TEXT for c in s.configs) for s in out.sessions]
    assert out.n_text_batches >= 1 and sum(texts) > out.n_text_batches
    assert any(c != TEXT for s in out.sessions for c in s.configs)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_prefill_flops_matches_reference(arch):
    """The simulator's recompute price counts ``moe_topk + n_shared_experts``
    expert FFNs a token, as the reference's does, at the published widths."""
    for n, prefix in ((768, 0), (768, 2304), (1, 3071)):
        got = Engine.prefill_flops(types.SimpleNamespace(cfg=registry.get(arch)), n, prefix)
        want = JEngine.prefill_flops(types.SimpleNamespace(cfg=jregistry.get(arch)), n, prefix)
        assert got == want > 0
