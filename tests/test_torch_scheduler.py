"""The port's ``ConcurrentScheduler`` and the engine's batch-of-requests
entry points against the reference's, on ``smollm-360m.tiny()`` in f32 with
the reference's weights and the same stored bytes.

The cases are those of ``tests/test_scheduler.py``: N = 1 equals
``ServeSession``; N > 1 on the same store and traces makes the reference's
decisions on the same virtual timelines with the same batching counters,
and holds the same caches (level-0 chunks bit-exact, lossy within 2e-5,
TEXT within 1e-4) and greedy tokens (``_torch_session_world.
assert_same_scheduled``); ``prefill_extend_rows`` and
``prefill_extend_gather`` equal single-row ``prefill_extend``, at the
capacity edge too; foreign engines and bad tokens are refused; and
``ContentionModel``'s per-shard readings equal the reference's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import codec as jcodec
from repro_torch.core import codec

from _torch_session_world import (
    T_CTX,
    TEXT,
    assert_caches_equal,
    assert_same,
    assert_same_scheduled,
    build_world,
    ideal,
    is_port,
    run_both,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return build_world()


def _traces(u):
    """``tests/test_scheduler.py::_traces``'s four shapes, as ``(name, args)``."""
    return [
        ("constant", (400 * u,)),
        ("steps", (0.2, [1.0 * u, 0.55 * u])),
        ("steps", (0.15, [2.0 * u, 0.4 * u, 2.0 * u, 0.4 * u])),
        ("constant", (3 * u,)),
    ]


# ---------------------------------------------------------------------------
# N = 1: the scheduler equals ServeSession
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["levels_and_text", "pure_decode", "no_text"])
def test_scheduler_n1_matches_session(world, case):
    u = world["u"]
    trace, kw = {
        "levels_and_text": (("steps", (0.2, [1.0 * u, 0.55 * u])), {}),
        "pure_decode": (("constant", (3 * u,)), dict(fixed_level=0)),
        "no_text": (("steps", (0.15, [2.0 * u, 0.4 * u] * 2)), dict(allow_text=False)),
    }[case]

    def scenario(side):
        net = side.network(trace)
        solo = side.sched_session(**kw).run("ctx", world["tokens"], net,
                                            prior_throughput_gbps=float(net.trace.gbps[0]))
        out = side.sched.ConcurrentScheduler(side.eng, contention=ideal(side)).run(
            [side.request(world["tokens"], trace, **kw)])
        return solo, out

    (solo, out), (jsolo, jout) = run_both(world, scenario)
    assert_same_scheduled(world, out, jout)
    assert_same(world, solo, jsolo)
    s = out.sessions[0]
    assert [t.nbytes for t in s.timelines] == [t.nbytes for t in solo.timelines]
    assert s.ttft_s == solo.ttft_s
    assert_caches_equal(s, solo)


# ---------------------------------------------------------------------------
# N > 1: the same decisions, timelines, counters and caches as the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("contention", ["ideal", "serialized"])
@pytest.mark.parametrize("priors", [True, False], ids=["prior", "no_prior"])
def test_scheduler_n3_matches_reference(world, contention, priors):
    traces = _traces(world["u"])[:3]

    def scenario(side):
        model = ideal(side) if contention == "ideal" else side.pipeline.ContentionModel({})
        return side.sched.ConcurrentScheduler(side.eng, contention=model).run(
            [side.request(world["tokens"], tr, prior=priors) for tr in traces])

    out, jout = run_both(world, scenario)
    assert_same_scheduled(world, out, jout)


def test_scheduler_level0_batched_equals_sequential(world):
    """Four level-0 loads stack their decodes (fewer decode calls than
    runs) and each row equals the request run alone, bit for bit."""
    traces = _traces(world["u"])

    def scenario(side):
        return side.sched.ConcurrentScheduler(side.eng, contention=ideal(side)).run(
            [side.request(world["tokens"], tr, fixed_level=0) for tr in traces])

    out, jout = run_both(world, scenario)
    assert_same_scheduled(world, out, jout)
    assert out.n_runs > out.n_decode_batches >= 1
    port = world["sides"][0]
    for s, tr in zip(out.sessions, traces):
        net = port.network(tr)
        seq = port.sched_session(fixed_level=0).run("ctx", world["tokens"], net,
                                                    prior_throughput_gbps=float(net.trace.gbps[0]))
        assert all(c == 0 for c in s.configs) and int(s.caches.length[0]) == T_CTX
        assert_caches_equal(s, seq)


def test_scheduler_mix_of_five_matches_reference(world):
    """Five requests, no priors: levels, TEXT and stacked decodes mix."""
    traces = (_traces(world["u"]) * 2)[:5]

    def scenario(side):
        return side.sched.ConcurrentScheduler(side.eng, contention=ideal(side)).run(
            [side.request(world["tokens"], tr, prior=False) for tr in traces])

    out, jout = run_both(world, scenario)
    assert_same_scheduled(world, out, jout)
    configs = [c for s in out.sessions for c in s.configs]
    assert TEXT in configs and any(c != TEXT for c in configs)
    assert out.n_text_batches >= 1


@pytest.mark.parametrize("text_curve", [False, True], ids=["decode_priced", "text_free"])
def test_contention_steers_decisions_like_reference(world, text_curve):
    """A serialized engine sheds TEXT chunks unless the TEXT curve is free
    (``test_contention_pushes_adaptation_off_text`` and
    ``test_text_factor_steers_decisions_separately``): the port's four
    sessions decide as the reference's."""
    u = world["u"]
    trace = ("steps", (0.2, [1.0 * u, 0.55 * u]))

    def scenario(side):
        model = side.pipeline.ContentionModel({}, text_factors={1: 1.0, 8: 1.0} if text_curve else {})
        return side.sched.ConcurrentScheduler(side.eng, contention=model).run(
            [side.request(world["tokens"], trace) for _ in range(4)])

    out, jout = run_both(world, scenario)
    assert_same_scheduled(world, out, jout)


def test_scheduler_rejects_foreign_engine_and_bad_tokens(world):
    for side in world["sides"]:
        sched = side.sched.ConcurrentScheduler(side.eng, contention=ideal(side))
        trace = ("constant", (3 * world["u"],))
        other = side.session.ServeSession(side.streamer, object.__new__(type(side.eng)), slo_s=1.0,
                                          recompute_s=lambda t, p: 1.0, decode_bytes_per_s=1e9)
        with pytest.raises(ValueError, match="share the scheduler's Engine"):
            sched.run([side.sched.SessionRequest(other, "ctx", world["tokens"], side.network(trace))])
        with pytest.raises(ValueError, match=r"tokens must be \(1, T\)"):
            sched.run([side.request(np.zeros((2, T_CTX), np.int32), trace)])
        with pytest.raises(ValueError, match="at least one request"):
            sched.run([])


# ---------------------------------------------------------------------------
# engine: width-masked and gathered TEXT recompute
# ---------------------------------------------------------------------------


def _decode(side, chunks):
    """Level-0 chunks decoded by the side's own codec, f32."""
    blobs = side.store.get_run("ctx", [(c, 0) for c in chunks])
    if is_port(side):
        return codec.decode_chunks(blobs, side.tables, out_dtype=torch.float32)
    return jcodec.decode_chunks(blobs, side.tables, out_dtype=jnp.float32)


def _as_tokens(side, toks):
    return torch.as_tensor(toks) if is_port(side) else jnp.asarray(toks, jnp.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("mode", ["masked", "gather"])
def test_prefill_extend_rows_and_gather_match_single_row(world, mode):
    """Both coalesced TEXT recomputes equal single-row ``prefill_extend``
    and leave the inactive row untouched; the port's equal the reference's."""
    tokens = world["tokens"]

    def scenario(side):
        eng = side.eng
        kv0 = _decode(side, [0, 1])
        ref = eng.decode_to_cache(eng.empty_caches(1), kv0, 0)
        ref_logits, ref = eng.prefill_extend(_as_tokens(side, tokens[:, 40:60]), ref)
        caches = eng.empty_caches(3)
        for row in (0, 2):
            caches = eng.insert_runs(caches, kv0, rows=[row], starts=[0], run_tokens=[40])
        before = _np(caches.kv_k[:, 1]).copy()
        if mode == "masked":
            toks = np.zeros((3, 20), np.int32)
            toks[0] = toks[2] = tokens[0, 40:60]
            logits, caches = eng.prefill_extend_rows(_as_tokens(side, toks), caches,
                                                     np.asarray([20, 0, 20], np.int32))
            lgs = (logits[0:1], logits[2:3])
        else:
            toks = np.stack([tokens[0, 40:60]] * 2)
            logits, caches = eng.prefill_extend_gather(_as_tokens(side, toks), caches, [0, 2])
            lgs = (logits[0:1], logits[1:2])
        assert [int(x) for x in caches.length] == [60, 0, 60]
        for row, lg in zip((0, 2), lgs):
            np.testing.assert_allclose(_np(caches.kv_k[:, row, :60]), _np(ref.kv_k[:, 0, :60]), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(_np(lg), _np(ref_logits), atol=1e-4, rtol=1e-4)
        assert np.array_equal(_np(caches.kv_k[:, 1]), before), f"{mode}: row 1 dirtied"
        return _np(caches.kv_k), _np(caches.kv_v), _np(logits)

    got, want = run_both(world, scenario)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("width", [8, 10, 0])
def test_prefill_extend_rows_partial_width_at_capacity_edge(world, width):
    """A partial-width chunk whose padded window overhangs the capacity
    lands its committed tokens at their true offset (the shifted window),
    keeps every other position, and a width-0 row at the same offset keeps
    its K/V and length bit for bit."""
    tokens = world["tokens"]
    tc = 16

    def scenario(side):
        eng = side.eng
        start = eng.capacity - 10  # window [cap - 10, cap + 6) overhangs

        def sentinel(batch, length):
            c = eng.empty_caches(batch)
            if is_port(side):
                c.kv_k[:, 0] = 7.0
                c.kv_v[:, 0] = 7.0
                return c._replace(length=torch.tensor(length, dtype=torch.int32))
            return c._replace(kv_k=c.kv_k.at[:, 0].set(7.0), kv_v=c.kv_v.at[:, 0].set(7.0),
                              length=jnp.asarray(length, jnp.int32))

        toks = np.zeros((2, tc), np.int32)
        toks[0] = tokens[0, :tc]
        _, out = eng.prefill_extend_rows(_as_tokens(side, toks), sentinel(2, [start, 0]),
                                         np.asarray([width, 0], np.int32))
        assert [int(x) for x in out.length] == [start + width, 0]
        k = _np(out.kv_k)
        if width:
            _, ref = eng.prefill_extend(_as_tokens(side, toks[:1, :width]), sentinel(1, [start]))
            np.testing.assert_allclose(k[:, 0, start:start + width], _np(ref.kv_k[:, 0, start:start + width]),
                                       atol=1e-5, rtol=1e-5)
        rest = np.concatenate([k[:, 0, :start], k[:, 0, start + width:]], axis=1)
        assert np.array_equal(rest, np.full_like(rest, 7.0))
        assert not k[:, 1].any()
        return k, _np(out.kv_v)

    got, want = run_both(world, scenario)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_prefill_extend_gather_rejects_rows_out_of_range(world):
    for side in world["sides"]:
        with pytest.raises(ValueError, match="out of range"):
            side.eng.prefill_extend_gather(_as_tokens(side, np.zeros((1, 4), np.int32)),
                                           side.eng.empty_caches(2), [2])


# ---------------------------------------------------------------------------
# contention: the per-shard readings
# ---------------------------------------------------------------------------


_MODELS = {
    "serialized": dict(),
    "measured_points": dict(factors={1: 1.0, 2: 1.5, 4: 3.0}),
    "split_curves": dict(factors={1: 1.0, 4: 3.0}, text_factors={1: 1.0, 4: 2.0}, gen_factors={4: 1.6}),
}


@pytest.mark.parametrize("model", list(_MODELS))
def test_contention_sharded_readings_match_reference(world, model):
    port, ref = (side.pipeline.ContentionModel(**_MODELS[model]) for side in world["sides"])
    for n_active in range(0, 11):
        for n_shards in (0, 1, 2, 3, 4, 8):
            for name in ("factor_sharded", "text_factor_sharded", "gen_factor_sharded"):
                got = getattr(port, name)(n_active, n_shards)
                assert got == getattr(ref, name)(n_active, n_shards), (name, n_active, n_shards)
            assert port.factor_sharded(n_active, 1) == port.factor(n_active)
            assert port.text_factor_sharded(n_active, 1) == port.text_factor(n_active)
            assert port.gen_factor_sharded(n_active, 1) == port.gen_factor(n_active)


def test_engine_cache_rows_is_one_shard(world):
    port = world["sides"][0].eng
    assert port.n_shards == 1
    assert [port.cache_rows(n) for n in (1, 2, 5)] == [1, 2, 5]
