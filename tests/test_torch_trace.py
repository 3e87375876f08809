"""The port's tracer (``repro_torch.tracing``): off, it does nothing; on,
it records nested spans per thread on ``time.time_ns`` and sums counters;
and the load path and the decode step emit the spans and counters the
benchmark reads, on ``smollm-360m.tiny()`` in f32 (the session world of
``tests/_torch_session_world.py``)."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tracing

from _torch_session_world import R_SLOW, build_world

torch.set_num_threads(1)

LOAD_SPANS = {"sched.run", "session.step", "session.wait", "session.validate", "transport.fetch", "store.get",
              "crc", "sched.decode", "codec.unpack", "codec.h2d", "codec.rans", "codec.assemble",
              "engine.insert", "sched.sync"}


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def world():
    return build_world()


def _traced(fn):
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    return out, spans, counters


def test_off_is_a_shared_noop_without_a_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the tracer read the clock while off")

    monkeypatch.setattr(tracing.time, "time_ns", no_clock)
    a = tracing.span("a", rows=3)
    assert a is tracing.span("b") is tracing.span("c", x=1)
    with a as entered:
        with tracing.span("d"):
            tracing.count("n", 5)
    assert entered is a
    assert tracing.drain() == ([], {})


def test_nesting_threads_and_stamps():
    inside = {}

    def worker():
        with tracing.span("worker", k=2):
            tracing.count("n", 3)
        inside["thread"] = threading.get_ident()

    def run():
        with tracing.span("outer"):
            with tracing.span("inner", rows=4):
                inside["t"] = time.time_ns()
                tracing.count("n", 1)
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        with tracing.span("after"):
            pass

    _, spans, counters = _traced(run)
    by = {s.name: (i, s) for i, s in enumerate(spans)}
    assert [s.name for s in spans] == ["outer", "inner", "worker", "after"]
    (io, outer), (_, inner), (_, w), (_, after) = by["outer"], by["inner"], by["worker"], by["after"]
    main = threading.get_ident()
    assert inner.parent == io and outer.parent == -1 and after.parent == -1
    assert outer.thread == inner.thread == main
    assert w.thread == inside["thread"] != main and w.parent == -1
    assert inner.t0_ns <= inside["t"] <= inner.t1_ns
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= w.t0_ns <= w.t1_ns <= outer.t1_ns <= after.t0_ns
    assert inner.attrs == {"rows": 4} and w.attrs == {"k": 2} and outer.attrs == {}
    assert counters == {"n": 4}
    assert tracing.drain() == ([], {})


def _wave(world, side):
    """Two requests of the context at level 1 over a LocalTransport, one
    ConcurrentScheduler wave, as a benchmark wave loads them."""
    transport = side.tr.LocalTransport(side.store)
    session = side.session.ServeSession(side.streamer, side.eng, slo_s=10.0, recompute_s=R_SLOW,
                                        decode_bytes_per_s=1e9, allow_text=False, fixed_level=1,
                                        transport=transport)
    reqs = [side.sched.SessionRequest(session, "ctx", world["tokens"], side.network(("constant", (100.0,))),
                                      transport=transport) for _ in range(2)]
    return side.sched.ConcurrentScheduler(side.eng, contention=side.pipeline.ContentionModel({})).run(reqs)


def test_wave_emits_every_load_span(world):
    side = world["sides"][0]
    plain = _wave(world, side)
    out, spans, counters = _traced(lambda: _wave(world, side))
    # tracing changes nothing the wave computes
    assert torch.equal(out.caches.kv_k, plain.caches.kv_k) and torch.equal(out.caches.kv_v, plain.caches.kv_v)
    names = {s.name for s in spans}
    assert LOAD_SPANS <= names, LOAD_SPANS - names
    wire = 2 * sum(m.sizes[1] for m in world["metas"])
    assert counters == {"wire_bytes": wire, "crc_bytes": 3 * wire}
    main = threading.get_ident()
    (run,) = [i for i, s in enumerate(spans) if s.name == "sched.run"]
    assert spans[run].thread == main
    for i, s in enumerate(spans):
        parent = spans[s.parent].name if s.parent >= 0 else None
        if s.name == "transport.fetch":
            assert s.thread != main and parent is None
        elif s.name == "store.get":
            assert parent == "transport.fetch"
        elif s.name == "crc":
            assert parent in ("store.get", "session.validate", "codec.unpack")
            assert s.attrs["bytes"] > 0
        elif s.name in ("session.wait", "session.validate"):
            assert parent == "session.step" and spans[s.parent].attrs["req"] in ("req0:ctx", "req1:ctx")
        elif s.name in ("codec.unpack", "codec.h2d", "codec.rans", "codec.assemble", "engine.insert"):
            assert parent == "sched.decode"
        elif s.name in ("session.step", "sched.decode", "sched.sync"):
            assert parent == "sched.run"
        if s.thread == main and s.name != "sched.run":
            assert spans[run].t0_ns <= s.t0_ns <= s.t1_ns <= spans[run].t1_ns
    crc_by_parent = {}
    for s in spans:
        if s.name == "crc":
            key = spans[s.parent].name
            crc_by_parent[key] = crc_by_parent.get(key, 0) + s.attrs["bytes"]
    assert crc_by_parent == {"store.get": wire, "session.validate": wire, "codec.unpack": wire}


def test_decode_step_spans_each_layer(world):
    side = world["sides"][0]
    eng = side.eng
    caches = eng.empty_caches(2)
    toks = torch.as_tensor(np.array([[1], [2]]))
    active = torch.tensor([True, False])
    (logits, _), spans, counters = _traced(lambda: eng.decode_step_rows(toks, caches.clone(), active))
    plain, _ = eng.decode_step_rows(toks, caches.clone(), active)
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)
    (step,) = [i for i, s in enumerate(spans) if s.name == "engine.step"]
    assert spans[step].attrs == {"rows": 2}
    L = eng.cfg.n_layers
    for name in ("step.attn", "step.ffn"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == L and all(s.parent == step for s in mine)
    assert len(spans) == 1 + 2 * L and counters == {}


def test_threads_lose_no_span_and_no_count():
    n_threads, n_each = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n_each):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("n", 1)

        def run():
            threads = [threading.Thread(target=worker) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)

        _, spans, counters = _traced(run)
    finally:
        sys.setswitchinterval(old)
    assert counters == {"n": n_threads * n_each}
    assert len(spans) == 2 * n_threads * n_each
    for s in spans:
        if s.name == "inner":
            p = spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread and p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
        else:
            assert s.parent == -1
