"""The readers of the program's own spans and counters (``pbench.program``
and its eight metric files) on synthetic records whose values are known,
the idle gaps labelled by the program span the host was in, and the
collection that follows the profiler."""
import dataclasses
import threading

import pytest

from _tiny import MANIFEST
from pbench import program
from pbench.cell import RunRecord, WaveRecord
from pbench.manifest import load_reader
from pbench.tracing import DeviceTrace, Spans
from pbench.traffic import Request, Traffic
from repro_torch import tracing
from repro_torch.tracing import Span

MS = 1_000_000
MAIN, WORKER = 1, 2


def _record(traced=True, counters=None):
    """Two waves in a window of [1000, 3000) ms.  Each wave: a load span of
    [t0, t0 + 400) holding one ``sched.run`` on the main thread, whose
    ``session.step`` holds a ``session.validate`` with a 5-ms ``crc``, one
    ``sched.decode`` with a 30-ms ``codec.unpack`` (a 10-ms ``crc`` in it),
    a 7-ms ``codec.h2d`` and a 20-ms ``sched.sync``; a 4-ms ``crc`` on a
    worker thread; then two steps of 50 ms, each an ``engine.step`` of 40
    ms with two ``step.attn`` of 6 ms and two ``step.ffn`` of 9 ms."""
    t = dataclasses.replace(Traffic.load(MANIFEST.traffic_path("gen-c32")), answer_tokens=3)
    hs = Spans()
    waves = []
    out = []

    def add(name, a, b, parent=-1, thread=MAIN, **attrs):
        out.append(Span(name, a * MS, b * MS, thread, parent, attrs))
        return len(out) - 1

    for w in range(2):
        t0 = 1000 * (w + 1)
        hs.items.append(("load", t0 * MS, (t0 + 400) * MS))
        run = add("sched.run", t0, t0 + 400)
        step = add("session.step", t0 + 10, t0 + 100, run, req="req0:ctx0")
        val = add("session.validate", t0 + 20, t0 + 90, step)
        add("crc", t0 + 21, t0 + 26, val, bytes=100)
        dec = add("sched.decode", t0 + 110, t0 + 300, run)
        unp = add("codec.unpack", t0 + 120, t0 + 150, dec)
        add("crc", t0 + 121, t0 + 131, unp, bytes=100)
        add("codec.h2d", t0 + 160, t0 + 167, dec)
        add("sched.sync", t0 + 350, t0 + 370, run)
        add("crc", t0 + 5, t0 + 9, thread=WORKER, bytes=100)
        steps = []
        for k in range(2):
            a = t0 + 500 + 50 * k
            hs.items.append(("step", a * MS, (a + 50) * MS))
            es = add("engine.step", a, a + 40, rows=2)
            for j in range(2):
                add("step.attn", a + 1 + 20 * j, a + 7 + 20 * j, es)
                add("step.ffn", a + 8 + 20 * j, a + 17 + 20 * j, es)
            steps.append((a + 50) * MS)
        reqs = [Request(0, 2, None, [1] * t.answer_tokens)]
        waves.append(WaveRecord(t0 * MS, (t0 + 400) * MS, (t0 + 500) * MS, steps, reqs, [1000], [True], 0.2))
    r = RunRecord({"family": "dense"}, t, waves, (1000 * MS, 3000 * MS), 10.0, hs)
    if traced:
        # an early span outside the window, as a warm-up's would be
        out.insert(0, Span("crc", 10 * MS, 500 * MS, MAIN, -1, {"bytes": 100}))
        out = [s._replace(parent=s.parent + 1 if s.parent >= 0 else -1) for s in out]
        r.program = {"spans": out, "counters": counters or {"wire_bytes": 200, "crc_bytes": 600}, "main": MAIN}
    return r


@pytest.mark.parametrize("name,want", [
    ("load_crc_ms", 5 + 10 + 4),  # every crc of a wave, the worker's too, not the one before the window
    ("load_crc_passes", 3.0),
    ("load_unpack_ms", 30 - 10),
    ("load_h2d_ms", 7),
    ("load_sync_wait_ms", 20),
    ("step_enqueue_ms", 40),
    ("step_attn_host_ms", 12),
    ("step_ffn_host_ms", 18),
])
def test_reader_on_a_known_record(name, want):
    assert load_reader(name)(_record()) == pytest.approx(want)
    # a program without the tracer leaves the record without spans
    assert load_reader(name)(_record(traced=False)) is None


def test_passes_follow_the_counters():
    r = _record(counters={"wire_bytes": 400, "crc_bytes": 1000})
    assert load_reader("load_crc_passes")(r) == pytest.approx(2.5)
    assert load_reader("load_crc_passes")(_record(counters={"crc_bytes": 5})) is None


def test_idle_gaps_labelled_by_the_innermost_program_span():
    # the device busy everywhere in the window but five holes: in the
    # validate span, in the unpack span's crc, in a step's ffn, in the
    # load's sched.run between its children, and between the harness's
    # spans
    holes = [(1045, 1055), (1124, 1129), (1510, 1513), (1310, 1312), (1460, 1461)]
    edges = sorted(x for h in holes for x in h)
    busy = [(1000, edges[0])] + [(edges[i], edges[i + 1]) for i in range(1, len(edges) - 1, 2)] + [(edges[-1], 3000)]
    r = _record()
    r.device = [("k", a * MS, b * MS) for a, b in busy]
    got = program.label_gaps(r)
    assert got == [["load/session.validate", 0.010], ["load/crc", 0.005], ["step/step.ffn", 0.003],
                   ["load/sched.run", 0.002], ["between", 0.001]]
    # without program spans the harness label stands alone
    r2 = _record(traced=False)
    r2.device = r.device
    assert program.label_gaps(r2) == [["load", 0.010], ["load", 0.005], ["step", 0.003], ["load", 0.002],
                                      ["between", 0.001]]


def test_innermost_is_found_by_bisection_among_many():
    # 20,000 sibling spans and their children: the walk visits the latest
    # started span and its parent, not the list
    spans = [Span("root", 0, 10 ** 9, MAIN, -1, {})]
    for k in range(10_000):
        spans.append(Span("outer", 100 * k, 100 * k + 90, MAIN, 0, {}))
        spans.append(Span("inner", 100 * k + 10, 100 * k + 20, MAIN, len(spans) - 1, {}))
    order = list(range(len(spans)))
    starts = [s.t0_ns for s in spans]
    assert program._innermost(spans, starts, order, 777_715) == "inner"
    assert program._innermost(spans, starts, order, 777_750) == "outer"
    assert program._innermost(spans, starts, order, 777_795) == "root"
    assert program._innermost(spans, starts, order, 2 * 10 ** 9) is None


def test_collection_follows_the_profiler(monkeypatch):
    monkeypatch.setattr(DeviceTrace, "start", lambda self: None)
    monkeypatch.setattr(DeviceTrace, "stop", lambda self: None)
    tracing.disable()
    with tracing.span("before"):
        pass
    pt = program.ProgramTrace()
    pt.start()
    try:
        assert tracing.enabled()
        with tracing.span("inside", rows=1):
            tracing.count("wire_bytes", 7)
    finally:
        pt.stop()
    assert not tracing.enabled()
    assert [s.name for s in pt.program["spans"]] == ["inside"]
    assert pt.program["counters"] == {"wire_bytes": 7} and pt.program["main"] == threading.get_ident()
    assert tracing.drain() == ([], {})
