"""The port's store -> stream -> materialize slice against the reference's
``repro.streaming``.

The network model, Algorithm 1 and the simulator are plain Python and numpy
on both sides, so their outcomes, decisions and plans must be *equal*.  The
store must give byte-identical blobs and equal metadata, the local transport
the same bytes, and the segmenter the same segments.  Materialized caches
are held at the tolerances of ``tests/test_torch_engine.py`` and greedy
tokens must be equal, on ``smollm-360m.tiny()`` in f32 with the reference's
weights.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import codec as jcodec
from repro.models import lm as jlm
from repro.serving import kv_layout as jkv_layout
from repro.serving.engine import Engine as JEngine
from repro.streaming import adaptation as jad
from repro.streaming import network as jnet
from repro.streaming import pipeline as jpipe
from repro.streaming import storage as jst
from repro.streaming import streamer as jsm
from repro.streaming import transport as jtr

from repro_torch.configs import registry
from repro_torch.core import codec
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.streaming import adaptation as ad
from repro_torch.streaming import calibration
from repro_torch.streaming import network as net
from repro_torch.streaming import pipeline as pipe
from repro_torch.streaming import storage as st
from repro_torch.streaming import streamer as sm
from repro_torch.streaming import transport as tr

torch.set_num_threads(1)

TEXT = ad.TEXT
T, CHUNK, CAP = 75, 20, 88  # four chunks, the last one ragged (15 tokens)


@pytest.fixture(autouse=True)
def _no_port_report(monkeypatch, tmp_path):
    """Neither package may read a throughput report the other cannot see."""
    monkeypatch.setenv("CACHEGEN_TORCH_BENCH_CODEC", str(tmp_path / "absent.json"))
    monkeypatch.setenv("CACHEGEN_TORCH_BENCH_SESSION", str(tmp_path / "absent.json"))
    calibration.clear_calibration_cache()


# ---------------------------------------------------------------------------
# network model
# ---------------------------------------------------------------------------


def _trace(mod, i):
    return [
        lambda: mod.BandwidthTrace.constant(0.5),
        lambda: mod.BandwidthTrace.steps(0.3, [2.0, 0.05, 1.0]),
        lambda: mod.BandwidthTrace(np.array([0.0, 0.2, 0.2, 0.7]), np.array([1.0, 3.0, 0.2, 0.8])),
        lambda: mod.BandwidthTrace.sampled(np.random.default_rng(7), 8, 0.7, 0.1, 10.0),
    ][i]()


NET_KW = [{}, {"rtt_s": 0.01}, {"straggler_p": 0.5, "straggler_scale_s": 0.3, "seed": 3},
          {"rtt_s": 0.005, "straggler_p": 0.9, "straggler_alpha": 2.0, "seed": 11}]
FETCHES = [(1e6, 0.0, 0, None), (3e7, 0.25, 3, 0.05), (1.0, 1.3, 7, 0.0), (5e8, 0.0, 2, 0.5)]


@pytest.mark.parametrize("trace", range(4))
def test_network_outcomes_equal_reference(trace):
    jt, t = _trace(jnet, trace), _trace(net, trace)
    np.testing.assert_array_equal(t.times, jt.times)
    for nbytes, start, _, _ in FETCHES:
        assert t.transmit_time(nbytes, start) == jt.transmit_time(nbytes, start)
        assert t.bytes_in_window(0.4, start) == jt.bytes_in_window(0.4, start)
        assert t.bandwidth_at(start) == jt.bandwidth_at(start)
        assert t.measured_throughput_gbps(nbytes, start) == jt.measured_throughput_gbps(nbytes, start)
    for kw in NET_KW:
        jm, m = jnet.NetworkModel(jt, **kw), net.NetworkModel(t, **kw)
        for nbytes, start, chunk, hedge in FETCHES:
            got = m.fetch_outcome(nbytes, start, chunk_idx=chunk, hedge_after_s=hedge)
            want = jm.fetch_outcome(nbytes, start, chunk_idx=chunk, hedge_after_s=hedge)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert m.straggler_delay(chunk, 1) == jm.straggler_delay(chunk, 1)


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------


def _choose_cases():
    """The four cases of tests/test_streaming.py, then seeded random ones."""
    cases = [
        dict(remaining_sizes={0: 1e6, 1: 5e5, 2: 2e5}, remaining_text_bytes=4e4,
             remaining_recompute_s=10.0, throughput_gbps=1.0, time_left_s=1.0),
        dict(remaining_sizes={0: 1e9, 1: 4e8, 2: 1e8}, remaining_text_bytes=1e6,
             remaining_recompute_s=50.0, throughput_gbps=1.0, time_left_s=1.0),
        dict(remaining_sizes={0: 1e9, 1: 9e8, 2: 8e8}, remaining_text_bytes=1e5,
             remaining_recompute_s=0.2, throughput_gbps=0.01, time_left_s=1.0),
        dict(remaining_sizes={0: 1e9, 1: 9e8}, remaining_text_bytes=1e9,
             remaining_recompute_s=100.0, throughput_gbps=0.001, time_left_s=0.1),
    ]
    rng = np.random.default_rng(0)
    for _ in range(24):
        n = int(rng.integers(2, 6))
        cases.append(dict(
            remaining_sizes={lvl: float(rng.uniform(1e4, 5e8)) for lvl in range(n)},
            remaining_text_bytes=float(rng.uniform(1e3, 1e7)),
            remaining_recompute_s=float(rng.uniform(0.0, 5.0)),
            throughput_gbps=float(rng.uniform(0.01, 5.0)),
            time_left_s=float(rng.uniform(0.01, 4.0)),
        ))
    return cases


def _call(fn, **kw):
    try:
        c = fn(**kw)
        return c.config, c.projected_s
    except (ad.NoFeasibleConfigError, jad.NoFeasibleConfigError) as e:
        return type(e).__name__


@pytest.mark.parametrize("allow_text", [True, False])
def test_choose_config_equal_reference(allow_text):
    for case in _choose_cases():
        levels = sorted(case["remaining_sizes"])
        for exclude in [(), (levels[0],), (TEXT, *levels[:-1]), (TEXT, *levels)]:
            kw = dict(case, levels_quality_order=levels, allow_text=allow_text, exclude=exclude)
            assert _call(ad.choose_config, **kw) == _call(jad.choose_config, **kw), kw


def test_policy_and_salvage_credit_equal_reference():
    for kw in [dict(slo_s=1.0), dict(slo_s=2.0, prior_throughput_gbps=0.3), dict(slo_s=1.0, fixed_level=3),
               dict(slo_s=1.0, adapt=False), dict(slo_s=0.5, default_level=0, allow_text=False)]:
        p, jp = ad.make_policy(5, **kw), jad.make_policy(5, **kw)
        assert (list(p.levels_quality_order), p.default_level, p.allow_text) == \
               (list(jp.levels_quality_order), jp.default_level, jp.allow_text)
        for step, (thr, exclude) in enumerate([(None, ()), (None, (1,)), (0.2, ()), (0.05, (0, TEXT)), (4.0, ())]):
            if thr is not None:
                p.observe_throughput(thr)
                jp.observe_throughput(thr)
            args = dict(elapsed_s=0.1 * step, remaining_sizes={lvl: 1e7 / (lvl + 1) for lvl in range(5)},
                        remaining_text_bytes=4e3, remaining_recompute_s=0.3, exclude=exclude)
            got, want = _call(p.next_config, **args), _call(jp.next_config, **args)
            assert got == want or (np.isnan(got[1]) and np.isnan(want[1]) and got[0] == want[0])
    with pytest.raises(ValueError):
        ad.make_policy(5, slo_s=1.0, fixed_level=5)
    sizes = {0: 5000.0, 1: 3000.0, 2: 2000.0}
    for args in [(1, 1200, 40, 900), (1, 800, 40, 900), (0, 2500, 40, 900), (2, 100, 40, 40)]:
        assert ad.salvage_credit(sizes, *args) == jad.salvage_credit(sizes, *args)


def _metas(mod, seed, n):
    r = np.random.default_rng(seed)
    out, start = [], 0
    for i in range(n):
        toks = int(r.integers(50, 200))
        base = int(r.integers(10_000, 400_000))
        sizes = {0: base * 4, 1: base * 2, 2: base, 3: base // 2}
        out.append(mod.ChunkMeta("c", i, start, start + toks, sizes=sizes, text_bytes=4 * toks))
        start += toks
    return out


SIM_CASES = [  # (trace, network kw, policy kw, hedge_after_s)
    (1, {}, dict(slo_s=1.0), None),
    (3, {"rtt_s": 0.002}, dict(slo_s=2.5, prior_throughput_gbps=1.0), None),
    (0, {"straggler_p": 0.5, "straggler_scale_s": 0.4, "seed": 5}, dict(slo_s=3.0), 0.05),
    (2, {}, dict(slo_s=0.2, allow_text=False), None),
    (1, {}, dict(slo_s=1.0, fixed_level=2), 0.01),
]


@pytest.mark.parametrize("case", range(len(SIM_CASES)))
def test_simulate_stream_equal_reference(case):
    trace, net_kw, pol_kw, hedge = SIM_CASES[case]
    results = []
    for mod, pmod, amod in ((net, pipe, ad), (jnet, jpipe, jad)):
        metas = _metas(st if mod is net else jst, case, 7)
        results.append(pmod.simulate_stream(
            metas, amod.make_policy(4, **pol_kw), mod.NetworkModel(_trace(mod, trace), **net_kw),
            decode_bytes_per_s=2e8, recompute_s=lambda n, p: 1e-3 * n + 1e-6 * n * p,
            final_step_s=0.01, hedge_after_s=hedge,
        ))
    got, want = results
    assert got.configs == want.configs and got.ttft_s == want.ttft_s and got.slo_s == want.slo_s
    assert [dataclasses.asdict(t) for t in got.timelines] == [dataclasses.asdict(t) for t in want.timelines]
    assert (got.slo_violated, got.total_bytes, got.duplicate_bytes) == \
           (want.slo_violated, want.total_bytes, want.duplicate_bytes)


def test_calibration_reads_only_the_port_reports(tmp_path, monkeypatch):
    names = {os.path.basename(p) for p in calibration.bench_codec_candidates()}
    assert names == {"absent.json", "BENCH_torch_codec.json"}
    assert {os.path.basename(p) for p in calibration.bench_session_candidates()} == \
           {"absent.json", "BENCH_torch_session.json"}
    monkeypatch.chdir(tmp_path)  # the reference's BENCH_codec.json is at the repo root
    assert calibration.measured_decode_bytes_per_s() == calibration.DEFAULT_DECODE_BYTES_PER_S
    here = "cuda" if torch.cuda.is_available() else "cpu"
    other = "cpu" if here == "cuda" else "cuda"
    report = {"fused": {"bytes_per_s": 123.0},
              "stacked": {"1": {"stacked": {"bytes_per_s": 100.0}}, "4": {"stacked": {"bytes_per_s": 200.0}}}}
    path = tmp_path / "BENCH_torch_codec.json"
    path.write_text(json.dumps(dict(report, host_backend=other)))
    assert calibration.measured_decode_bytes_per_s() == calibration.DEFAULT_DECODE_BYTES_PER_S
    path.write_text(json.dumps(dict(report, host_backend=here)) + " ")
    assert calibration.measured_decode_bytes_per_s() == 123.0
    assert calibration.measured_contention_factors() == {1: 1.0, 4: 2.0}
    assert calibration.measured_text_contention_factors() == {}
    cm = pipe.ContentionModel.measured()
    assert (cm.factor(1), cm.factor(4), cm.text_factor(4), cm.gen_factor(2)) == (1.0, 2.0, 2.0, 4 / 3)


# ---------------------------------------------------------------------------
# store, transport, segmenter, materialize (tiny model, the reference's weights)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    jcfg = dataclasses.replace(jregistry.get("smollm-360m").tiny(), dtype="float32")
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), dtype="float32")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jeng = JEngine(jcfg, jparams, cache_capacity=CAP)
    eng = Engine(cfg, params, cache_capacity=CAP, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 512, size=(1, T)).astype(np.int32)
    jlogits, jc = jeng.calculate_kv({"tokens": jnp.asarray(tokens)})
    kv = np.asarray(jkv_layout.caches_to_codec_kv(jc, 0, T), np.float32)
    jct = jcodec.profile([kv], jcodec.CodecConfig(precision=10))
    ct = codec.tables_from_numpy(
        anchor=np.asarray(jct.anchor.freqs),
        deltas={lvl: np.asarray(t.freqs) for lvl, t in jct.deltas.items()},
        ll_anchor=np.asarray(jct.ll_anchor.freqs),
        ll_delta=np.asarray(jct.ll_delta.freqs),
        table_idx=jct.table_idx, delta_scale=jct.delta_scale,
        config=codec.CodecConfig(**dataclasses.asdict(jct.config)),
        n_layers=jct.n_layers, n_channels=jct.n_channels, device="cpu",
    )
    jstore, store = jst.KVStore(jct), st.KVStore(ct)
    jmetas = jstore.store_kv("ctx", kv, chunk_tokens=CHUNK)
    metas = store.store_kv("ctx", kv, chunk_tokens=CHUNK)
    first = np.array(jnp.argmax(jlogits[:, -1], -1), np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jeng=jeng, eng=eng, tokens=tokens, kv=kv, jct=jct, ct=ct,
                jstore=jstore, store=store, jmetas=jmetas, metas=metas, first=first)


def test_store_kv_byte_identical_to_reference(world):
    jstore, store = world["jstore"], world["store"]
    assert [dataclasses.asdict(m) for m in world["metas"]] == [dataclasses.asdict(m) for m in world["jmetas"]]
    assert [m.n_tokens for m in world["metas"]] == [20, 20, 20, 15]
    for m in world["metas"]:
        for lvl in m.sizes:
            assert store.get_kv("ctx", m.chunk_idx, lvl) == jstore.get_kv("ctx", m.chunk_idx, lvl)
    for lvl in range(5):
        assert store.total_bytes("ctx", lvl) == jstore.total_bytes("ctx", lvl)
    assert store.storage_bytes("ctx") == jstore.storage_bytes("ctx")
    run = [(3, 4), (0, 0), (2, 1)]
    assert store.get_run("ctx", run) == jstore.get_run("ctx", run)
    bounds = st.split_chunks(T, CHUNK)
    assert bounds == jst.split_chunks(T, CHUNK)
    for ns in ("", "smollm"):
        payloads = st.token_payloads(world["tokens"][0], bounds)
        assert payloads == jst.token_payloads(world["tokens"][0], bounds)
        assert st.chain_hashes(payloads, ns) == jst.chain_hashes(payloads, ns)
    for s in (store, jstore):
        with pytest.raises(KeyError, match="chunk 9 level 1"):
            s.get_kv("ctx", 9, 1)
        with pytest.raises(KeyError, match="nope"):
            s.meta("nope")


def test_directory_backend_stores_the_same_files(world, tmp_path):
    kv = world["kv"][:, :, :CHUNK]
    jstore = jst.KVStore(world["jct"], directory=str(tmp_path / "ref"))
    store = st.KVStore(world["ct"], directory=str(tmp_path / "port"))
    jstore.store_kv("d", kv, chunk_tokens=CHUNK, levels=[0, 3])
    store.store_kv("d", kv, chunk_tokens=CHUNK, levels=[0, 3])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) == ["d.c0000.l0.kvbs", "d.c0000.l3.kvbs"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    assert store.get_kv("d", 0, 3) == world["store"].get_kv("ctx", 0, 3)
    with pytest.raises(ValueError):
        st.KVStore(world["ct"], directory=str(tmp_path), backend=st.MemoryBackend())


def test_store_decode_matches_reference(world):
    for ci, lvl in [(0, 0), (1, 2), (3, 4)]:
        blob = world["store"].get_kv("ctx", ci, lvl)
        got = world["store"].decode(blob)
        want = world["jstore"].decode(blob)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        if lvl == 0:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


class _Gate:
    """A backend whose reads wait until the gate opens."""

    def __init__(self, inner):
        self.inner, self.open = inner, threading.Event()

    def get(self, *key):
        self.open.wait(30)
        return self.inner.get(*key)


def test_local_transport_matches_reference(world):
    t, jt = tr.LocalTransport(world["store"]), jtr.LocalTransport(world["jstore"])
    run = [(0, 1), (1, 0), (3, 4)]
    got, want = t.fetch_run("ctx", run).result(timeout=30), jt.fetch_run("ctx", run).result(timeout=30)
    assert got.blobs == want.blobs and got.nbytes == want.nbytes
    assert got.completion_order == want.completion_order == (0, 1, 3)
    for byte_range in [(100, 50), (200, None), (10**9, None), None]:
        got = t.fetch_run("ctx", [(2, 3)], byte_range=byte_range, resumable=True).result(timeout=30)
        want = jt.fetch_run("ctx", [(2, 3)], byte_range=byte_range, resumable=True).result(timeout=30)
        assert got.blobs == want.blobs
        assert (got.range_offset, got.range_total) == (want.range_offset, want.range_total)
        assert dataclasses.asdict(got.seg_index) == dataclasses.asdict(want.seg_index)
    with pytest.raises(ValueError):
        t.fetch_run("ctx", run, byte_range=(0, None))
    with pytest.raises(KeyError):
        t.fetch_run("ctx", [(0, 9)]).result(timeout=30)
    for err in [KeyError("x"), ValueError("x"), TimeoutError(), ConnectionError(), OSError(),
                tr.FetchError("x"), RuntimeError("x"), codec.bitstream.IntegrityError("x")]:
        jerr = jtr.FetchError("x") if isinstance(err, tr.FetchError) else err
        if isinstance(err, codec.bitstream.IntegrityError):
            jerr = jcodec.bitstream.IntegrityError("x")
        assert tr.classify_failure(err) == jtr.classify_failure(jerr)
    assert [tr.RetryPolicy().backoff(k) for k in range(4)] == [jtr.RetryPolicy().backoff(k) for k in range(4)]


def test_local_transport_cancel_and_completion_order(world):
    gate = _Gate(world["store"].backend)
    t = tr.LocalTransport(st.KVStore(world["ct"], backend=gate))
    held = t.fetch_run("ctx", [(0, 1)])
    assert held.cancel() is None  # a local fetch has no resumable prefix to salvage
    with pytest.raises(tr.FetchError) as err:
        held.result(timeout=5)
    assert tr.classify_failure(err.value) == "io" and err.value.chunk_levels == [(0, 1)]
    slow = t.fetch_run("ctx", [(1, 1)])
    fast = tr.LocalTransport(world["store"]).fetch_run("ctx", [(2, 1)])
    order = tr.as_completed([slow, fast], timeout=30)
    assert next(order) is fast
    gate.open.set()
    assert next(order) is slow and slow.result().blobs == [world["store"].get_kv("ctx", 1, 1)]


SEGMENT_PLANS = [
    ([0, 1, TEXT, 2, 2, TEXT, TEXT, 4], None),
    ([0, 1, TEXT, 2, 2, TEXT, TEXT, 4], 30),
    ([TEXT, TEXT, TEXT], None),
    ([3, 3, 3, 3, 3], 25),
    ([0, TEXT, 1], 1),
]


@pytest.mark.parametrize("case", range(len(SEGMENT_PLANS)))
def test_segment_plan_equal_reference(case):
    configs, max_run = SEGMENT_PLANS[case]
    metas, jmetas = _metas(st, case, len(configs)), _metas(jst, case, len(configs))
    got = sm.segment_plan(metas, configs, max_run)
    want = jsm.segment_plan(jmetas, configs, max_run)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    seg, jseg = sm.RunSegmenter(max_run), jsm.RunSegmenter(max_run)
    pushed = [s for m, c in zip(metas, configs) for s in seg.push(m, c, b"%d" % m.chunk_idx)] + seg.flush()
    jpushed = [s for m, c in zip(jmetas, configs) for s in jseg.push(m, c, b"%d" % m.chunk_idx)] + jseg.flush()
    assert [dataclasses.asdict(s) for s in pushed] == [dataclasses.asdict(s) for s in jpushed]
    with pytest.raises(ValueError):
        sm.RunSegmenter(0)


@pytest.fixture(scope="module")
def plans(world):
    """One plan per package from ``stream()``, its configs then replaced by
    a mix of levels and TEXT chunks (a TEXT chunk between two runs)."""
    out = []
    for streamer, netmod in ((sm.CacheGenStreamer(world["store"], world["cfg"]), net),
                             (jsm.CacheGenStreamer(world["jstore"], world["jcfg"]), jnet)):
        plan = streamer.stream("ctx", netmod.NetworkModel(netmod.BandwidthTrace.constant(0.5)), slo_s=5.0,
                               decode_bytes_per_s=1e9, recompute_s=lambda t, p: 100.0,
                               prior_throughput_gbps=0.5, allow_text=False)
        plan = dataclasses.replace(plan, result=dataclasses.replace(plan.result, configs=[0, 2, TEXT, 4]))
        out.append((streamer, plan))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_materialize_matches_reference_and_generates_the_same_tokens(world, plans, fused):
    (streamer, plan), (jstreamer, jplan) = plans
    assert plan.result.configs == jplan.result.configs
    c = streamer.materialize(plan, world["eng"], world["tokens"], fused=fused)
    jc = jstreamer.materialize(jplan, world["jeng"], world["tokens"], fused=fused)
    assert c.length.tolist() == np.asarray(jc.length).tolist() == [T]
    for m, config in zip(world["metas"], plan.result.configs):
        sl = slice(m.start, m.end)
        for got, want in ((c.kv_k, jc.kv_k), (c.kv_v, jc.kv_v)):
            got, want = got[:, :, sl].float().numpy(), np.asarray(want[:, :, sl], np.float32)
            if config == 0:
                np.testing.assert_array_equal(got, want)
            else:  # lossy levels, and TEXT recomputed on top of them: bf16
                np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)
    first = world["first"]
    gen = world["eng"].generate_with_kv(c, torch.as_tensor(first), 8)
    jgen = world["jeng"].generate_with_kv(jc, jnp.asarray(first), 8)
    np.testing.assert_array_equal(gen, np.asarray(jgen))


def test_materialize_modes_agree(world, plans):
    streamer, plan = plans[0]
    fused = streamer.materialize(plan, world["eng"], world["tokens"])
    ref = streamer.materialize(plan, world["eng"], world["tokens"], fused=False)
    assert torch.equal(fused.length, ref.length)
    for m, config in zip(world["metas"], plan.result.configs):
        sl = slice(m.start, m.end)
        if config == 0:
            assert torch.equal(fused.kv_k[:, :, sl], ref.kv_k[:, :, sl])
        elif config != TEXT:
            assert codec.ops.bf16_ulp_excess(fused.kv_k[:, :, sl], ref.kv_k[:, :, sl],
                                             **codec.ops.BF16_TOL["kv_dequant_tokens"]) <= 1


def test_insert_codec_kv_length_is_monotone(world):
    kv = torch.as_tensor(world["kv"])
    c = world["eng"].empty_caches(2)
    c = sm._insert_codec_kv(world["cfg"], c, kv[:, :, 40:60], 40)
    assert c.length.tolist() == [60, 60]
    c = sm._insert_codec_kv(world["cfg"], c, kv[:, :, :20], 0)
    assert c.length.tolist() == [60, 60]  # re-inserting an earlier chunk: no shrink
    want = kv[:, 0, :20].reshape(4, 20, 2, 32).to(torch.bfloat16)
    assert torch.equal(c.kv_k[:, 1, :20], want)
