"""The port's live adaptive session (``ServeSession`` over ``SimTransport``)
against the reference's, on ``smollm-360m.tiny()`` in f32 with the
reference's weights and the same stored bytes.

Per case both packages run the same scenario; their results must make the
same per-chunk decisions on the same virtual timelines (every
``ChunkTimeline`` field), reach the same TTFT and counters, hold the same
cache (level-0 chunks bit-exact, lossy chunks within 2e-5) and generate the
same greedy tokens from it (``_torch_session_world.assert_same``).  The
cases are those of ``tests/test_session.py`` and the ``SimTransport`` cases
of ``tests/test_transport.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_session_world import CHUNK, R_SLOW, T_CTX, TEXT, assert_same, build_world, run_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return build_world()


def _traces(u):
    """``tests/test_session.py``'s four trace shapes."""
    return {
        "flat": ("constant", (400 * u,)),
        "falling": ("steps", (0.2, [1.0 * u, 0.55 * u])),
        "oscillating": ("steps", (0.15, [2.0 * u, 0.4 * u, 2.0 * u, 0.4 * u])),
        "collapsed": ("constant", (0.002 * u,)),
    }


def _sampled(side, seed, u):
    return side.net.NetworkModel(side.net.BandwidthTrace.sampled(np.random.default_rng(seed), 8, 0.2,
                                                                 0.05 * u, 5.0 * u))


def _pair(world, make_net, *, slo_s, rc, prior=None, transport=None, **kw):
    """Plan (``stream``) and live session of each package on the same inputs;
    the session's decisions must equal its own package's plan too."""
    def scenario(side):
        plan = side.streamer.stream("ctx", make_net(side), slo_s=slo_s, decode_bytes_per_s=1e9, recompute_s=rc,
                                    prior_throughput_gbps=prior,
                                    **{k: v for k, v in kw.items() if k != "max_run_tokens"})
        res = side.serve(slo_s=slo_s, rc=rc, **kw).run(
            "ctx", world["tokens"], make_net(side), prior_throughput_gbps=prior,
            transport=transport(side) if transport else None)
        assert res.configs == plan.result.configs
        assert abs(res.ttft_s - plan.result.ttft_s) < 1e-9
        return res

    res, jres = run_both(world, scenario)
    assert_same(world, res, jres)
    return res


R_MID = lambda t, p: 0.04 * t / CHUNK  # noqa: E731


@pytest.mark.parametrize("name", ["flat", "falling", "oscillating", "collapsed"])
@pytest.mark.parametrize("rc", [R_SLOW, R_MID], ids=["gpu_busy", "gpu_idle"])
def test_session_matches_reference_on_trace_matrix(world, name, rc):
    trace = _traces(world["u"])[name]
    prior = float(world["sides"][0].network(trace).trace.gbps[0])
    _pair(world, lambda side: side.network(trace), slo_s=1.25, rc=rc, prior=prior)


@pytest.mark.parametrize("seed", range(3))
def test_session_matches_reference_on_sampled_traces(world, seed):
    u = world["u"]
    prior = float(_sampled(world["sides"][0], seed, u).trace.gbps[0])
    _pair(world, lambda side: _sampled(side, seed, u), slo_s=1.0, rc=lambda t, p: 0.05 * t / CHUNK, prior=prior)


@pytest.mark.parametrize("hedge", [None, 0.05])
def test_session_matches_reference_with_stragglers_and_hedging(world, hedge):
    u = world["u"]
    res = _pair(world, lambda side: side.network(("constant", (30 * u,)), straggler_p=0.5, straggler_scale_s=0.5,
                                                 seed=7),
                slo_s=2.0, rc=R_SLOW, prior=30 * u, allow_text=False, hedge_after_s=hedge)
    assert (res.n_hedged > 0) == (hedge is not None)


def test_session_hedged_sim_transport_matches_reference(world):
    """``tests/test_transport.py``'s hedging case through an explicit
    ``SimTransport``: the winning hedges and the cancelled losers' bytes
    (``duplicate_bytes``) are the reference's."""
    u = world["u"]
    kw = dict(straggler_p=0.6, straggler_scale_s=0.6, seed=21)
    make = lambda side: side.network(("constant", (1.5 * u,)), **kw)  # noqa: E731
    res = _pair(world, make, slo_s=5.0, rc=R_SLOW, prior=1.5 * u, allow_text=False, hedge_after_s=0.08,
                transport=lambda side: side.tr.SimTransport(side.store, make(side)))
    assert res.n_hedged > 0 and 0.0 < res.duplicate_bytes <= res.total_bytes


@pytest.mark.parametrize("max_run_tokens", [None, 2 * CHUNK, CHUNK])
def test_session_level0_any_run_size_matches_reference_and_oracle(world, max_run_tokens):
    u = world["u"]
    res = _pair(world, lambda side: side.network(("constant", (100 * u,))), slo_s=30.0, rc=R_SLOW,
                prior=100 * u, fixed_level=0, max_run_tokens=max_run_tokens)
    port = world["sides"][0]
    plan = port.streamer.stream("ctx", port.network(("constant", (100 * u,))), slo_s=30.0, decode_bytes_per_s=1e9,
                                recompute_s=R_SLOW, prior_throughput_gbps=100 * u, fixed_level=0)
    ref = port.streamer.materialize(plan, port.eng, world["tokens"], fused=False)
    assert set(res.configs) == {0} and res.n_runs == (1 if max_run_tokens is None else -(-T_CTX // max_run_tokens))
    assert torch.equal(res.caches.kv_k[:, :, :T_CTX], ref.kv_k[:, :, :T_CTX])
    assert torch.equal(res.caches.kv_v[:, :, :T_CTX], ref.kv_v[:, :, :T_CTX])


def test_session_text_interleave_matches_reference(world):
    """Falling trace and an idle GPU: the head streams, the tail is
    recomputed as TEXT on top of it, in runs of two chunks."""
    u = world["u"]
    res = _pair(world, lambda side: side.network(("steps", (0.2, [1.0 * u, 0.55 * u]))), slo_s=1.25,
                rc=lambda t, p: 0.15 * 1.25 * t / CHUNK, max_run_tokens=2 * CHUNK)
    assert TEXT in res.configs and any(c != TEXT for c in res.configs), res.configs


def test_session_bf16_serving_cache_matches_reference(world):
    """The default (bf16) serving cache: lossy levels under a falling trace,
    in runs of two chunks."""
    u = world["u"]

    def scenario(side):
        return side.serve(bf16=True, slo_s=1.1, allow_text=False, max_run_tokens=2 * CHUNK).run(
            "ctx", world["tokens"], side.network(("steps", (0.1, [0.9 * u, 0.3 * u]))), prior_throughput_gbps=0.9 * u)

    res, jres = run_both(world, scenario)
    assert res.caches.kv_k.dtype == torch.bfloat16 and len(set(res.configs)) > 1
    assert_same(world, res, jres)


@pytest.mark.parametrize("bad", [(0, 2), (1, 1)], ids=["wrong_level", "wrong_chunk"])
def test_session_rejects_mismatched_blob_like_reference(world, bad):
    """A store returning the wrong bitstream for chunk 0 at level 1 fails
    loudly in both packages: ``validate_blob`` raises before any decode."""
    u = world["u"]
    msgs = []
    for side in world["sides"]:
        store = side.copy_store()
        store.backend.put("ctx", 0, 1, side.store.get_kv("ctx", *bad))
        sess = side.session.ServeSession(side.copy_streamer(store), side.eng, slo_s=30.0, recompute_s=R_SLOW,
                                         decode_bytes_per_s=1e9, fixed_level=1)
        with pytest.raises(ValueError, match="mismatched bitstream") as err:
            sess.run("ctx", world["tokens"], side.network(("constant", (100 * u,))), prior_throughput_gbps=100 * u)
        msgs.append(str(err.value))
        meta = store.meta("ctx")[0]
        with pytest.raises(ValueError, match="mismatched bitstream"):
            side.session.validate_blob(store.get_kv("ctx", 0, 1), meta, 1)
        side.session.validate_blob(side.store.get_kv("ctx", 0, 1), meta, 1)
    assert msgs[0] == msgs[1]


def test_stream_result_is_timeline_compatible_like_reference(world):
    u = world["u"]

    def scenario(side):
        res = side.serve(slo_s=5.0, allow_text=False).run(
            "ctx", world["tokens"], side.network(("constant", (100 * u,))), prior_throughput_gbps=100 * u)
        sr = res.stream_result()
        assert sr.configs == res.configs and sr.total_bytes == res.total_bytes
        assert sr.slo_violated == res.slo_violated and sr.ttft_s == res.ttft_s
        return res, sr

    (res, sr), (jres, jsr) = run_both(world, scenario)
    assert type(sr).__name__ == type(jsr).__name__ == "StreamResult"
    assert [dataclasses.asdict(t) for t in sr.timelines] == [dataclasses.asdict(t) for t in jsr.timelines]
    assert (sr.ttft_s, sr.configs, sr.slo_s, sr.duplicate_bytes) == (jsr.ttft_s, jsr.configs, jsr.slo_s,
                                                                      jsr.duplicate_bytes)
    assert res.level_histogram() == jres.level_histogram()
    assert_same(world, res, jres)


# ---------------------------------------------------------------------------
# SimTransport alone
# ---------------------------------------------------------------------------

FETCH_CASES = [  # (trace, network kw, chunk_levels, start_t, hedge_after_s, byte_range, resumable)
    (("constant", (0.02,)), {}, [(0, 1)], 0.0, None, None, False),
    (("constant", (0.02,)), {"rtt_s": 0.003}, [(2, 0), (3, 4)], 0.25, None, None, False),
    (("steps", (0.05, [0.5, 0.001, 2.0])), {}, [(1, 2)], 0.01, None, (300, None), True),
    (("constant", (0.008,)), {"straggler_p": 1.0, "straggler_scale_s": 0.5, "seed": 5}, [(2, 0)], 0.0, 0.005,
     None, True),
    (("constant", (0.008,)), {"straggler_p": 0.6, "straggler_scale_s": 0.3, "seed": 9}, [(4, 3)], 0.1, 0.05,
     (100, 500), False),
]


@pytest.mark.parametrize("case", range(len(FETCH_CASES)))
def test_sim_transport_completion_matches_reference_and_fetch_outcome(world, case):
    trace, kw, chunk_levels, start, hedge, byte_range, resumable = FETCH_CASES[case]
    got = []
    for side in world["sides"]:
        network = side.network(trace, **kw)
        res = side.tr.SimTransport(side.store, network).fetch_run(
            "ctx", chunk_levels, start_t=start, hedge_after_s=hedge, byte_range=byte_range,
            resumable=resumable).result(timeout=30)
        nbytes = sum(len(b) for b in res.blobs)
        assert res.nbytes == nbytes
        want = network.fetch_outcome(float(nbytes), start, chunk_idx=chunk_levels[0][0],
                                     hedge_after_s=None if byte_range else hedge)
        assert (res.end_t, res.throughput_gbps, res.hedged, res.duplicate_bytes) == \
               (want.end_t, want.throughput_gbps, want.hedged, want.duplicate_bytes)
        if res.hedge_issued:
            assert res.loser_cancelled
        fields = dataclasses.asdict(res)
        for name in ("wall_s", "loser_bytes_read", "seg_index"):
            fields.pop(name)
        got.append((fields, None if res.seg_index is None else dataclasses.asdict(res.seg_index)))
    assert got[0] == got[1]
    if hedge is not None and byte_range is None and kw.get("straggler_p") == 1.0:
        assert got[0][0]["hedged"]  # the stalled primary loses to the hedge


def test_sim_transport_paced_hedge_loser_is_cancelled(world):
    """With real pacing the losing attempt stops mid-read, in both packages."""
    for side in world["sides"]:
        nbytes = world["metas"][0].sizes[0]
        network = side.network(("constant", (nbytes * 8 / 1e9 / 0.05,)), straggler_p=1.0, straggler_scale_s=10.0,
                               straggler_alpha=50.0, seed=1)
        res = side.tr.SimTransport(side.store, network, time_scale=1.0).fetch_run(
            "ctx", [(0, 0)], hedge_after_s=0.02).result(timeout=30)
        assert res.hedged and res.winner == "hedge" and res.loser_cancelled
        assert res.blobs[0] == side.store.get_kv("ctx", 0, 0)
        assert res.loser_bytes_read < res.nbytes and 0 <= res.duplicate_bytes <= res.nbytes


def test_sim_transport_missing_cancel_and_salvage_match_reference(world):
    out = []
    for side in world["sides"]:
        t = side.tr.SimTransport(side.store, side.network(("constant", (world["u"],)), rtt_s=0.002))
        with pytest.raises(KeyError, match="chunk 0 level 99") as err:
            t.fetch_run("ctx", [(0, 99)], start_t=0.5).result(timeout=10)
        assert err.value.fail_t == 0.502
        salv = t.fetch_run("ctx", [(0, 1)], resumable=True).cancel(0.1)
        assert salv.data == side.store.get_kv("ctx", 0, 1)[:len(salv.data)]
        paced = side.tr.SimTransport(side.store, side.network(("constant", (world["u"],))), time_scale=30.0)
        h = paced.fetch_run("ctx", [(0, 1), (1, 1)])
        h.cancel()
        with pytest.raises(side.tr.FetchError) as err:
            h.result(timeout=10)
        assert "context 'ctx'" in str(err.value) and "(chunk, level)=[(0, 1), (1, 1)]" in str(err.value)
        with pytest.raises(ValueError, match="single-chunk"):
            t.fetch_run("ctx", [(0, 1), (1, 1)], byte_range=(0, 10))
        out.append((salv.data, salv.offset, salv.total, salv.nbytes_wire, salv.index.verified_prefix(salv.data)))
    assert out[0] == out[1] and 0 < len(out[0][0]) < world["metas"][0].sizes[1]
