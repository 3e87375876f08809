"""The metric arithmetic: percentiles over every request, rates over the
whole window, device shares from the union of intervals, bounds from shapes."""
import dataclasses
import math

import numpy as np
import pytest

from _tiny import MANIFEST
from pbench import readers, yardstick
from pbench.cell import RunRecord, WaveRecord
from pbench.manifest import load_reader
from pbench.tracing import Spans
from pbench.traffic import Request, Traffic

MS = 1_000_000


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 95) == 95 and yardstick.percentile(xs, 50) == 50
    assert yardstick.percentile([3.0], 95) == 3.0
    assert yardstick.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 100], 95) == 19
    assert yardstick.percentile([1, 2, math.inf], 95) == math.inf


def test_spread_is_quartiles_over_median():
    assert yardstick.spread([10, 10, 10, 10]) == 0
    # statistics.quantiles' exclusive method: positions (n + 1) p
    q1, q2, q3 = (8.5, 10.5, 12.5)
    assert yardstick.spread([7, 9, 10, 11, 12, 14]) == pytest.approx((q3 - q1) / q2)


def test_intervals():
    m = yardstick.merge_intervals([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert m == [[0, 3], [5, 8]]
    assert yardstick.covered(m, 2, 6) == 2
    assert yardstick.gaps(m, 0, 10) == [[3, 5], [8, 10]]
    assert yardstick.gaps([], 0, 4) == [[0, 4]]


def test_covered_is_the_overlap_summed():
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 10_000, 400)
    m = yardstick.merge_intervals(zip(starts, starts + rng.integers(1, 60, 400)))
    for a, b in rng.integers(-100, 10_200, (300, 2)):
        want = sum(max(0, min(e, b) - max(s, a)) for s, e in m if e > a and s < b)
        assert yardstick.covered(m, int(a), int(b)) == want


def test_bounds_from_shapes():
    # K3: 2 rows of 1,000 cached positions, 8 KV heads of 128, 32 query heads
    b = yardstick.k3_bound_s([1000, 1000], 32, 8, 128)
    assert b == pytest.approx((2 * 2000 * 8 * 128 * 2 + 2 * 2 * 32 * 128 * 2 + 8) / yardstick.HBM_BYTES_PER_S)
    # K7: bytes bound at 12 int32 operations a symbol
    n = yardstick.k7_bound_s(1000, 100, 50_000)
    assert n == pytest.approx(max((50_000 * 2 + 100_000 * 4 + 1000 * 28) / yardstick.HBM_BYTES_PER_S,
                                  12 * 100_000 / yardstick.INT32_OPS))
    assert yardstick.kernel_name("void (anonymous namespace)::decode_split_kernel<64, 2>(float const*)") == \
        "decode_split_kernel"


def test_token_flops_dense_and_moe():
    d = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "d_head": 4, "d_ff": 16,
         "vocab_size": 10}
    per_layer = 2 * (8 * (2 + 2) * 4 + 2 * 4 * 8 + 3 * 8 * 16) + 4 * 2 * 4 * 5
    assert yardstick.token_flops(d, 5, head=False) == 2 * per_layer
    assert yardstick.token_flops(d, 5, head=True) == 2 * per_layer + 2 * 8 * 256
    m = dict(d, family="moe", moe_topk=2, n_shared_experts=1, n_experts=4)
    assert yardstick.token_flops(m, 5, False) - yardstick.token_flops(d, 5, False) == \
        2 * 2 * (3 * 8 * 16 * 2 + 8 * 4)


def _record(device=None):
    t = dataclasses.replace(Traffic.load(MANIFEST.traffic_path("gen-c32")), answer_tokens=4)
    spans = Spans()
    waves = []
    # two waves of two requests: TTFT 100 ms and 300 ms, steps 10 and 30 ms
    for w, (ttft, step) in enumerate([(100, 10), (300, 30)]):
        t0 = 1000 * MS * (w + 1)
        steps = [t0 + (ttft + step * (i + 1)) * MS for i in range(t.answer_tokens - 1)]
        reqs = [Request(0, 0, None, [1] * t.answer_tokens) for _ in range(2)]
        waves.append(WaveRecord(t0, t0 + 50 * MS, t0 + ttft * MS, steps, reqs, [1000, 2000], [True, True], 0.02))
        spans.items.append(("load", t0, t0 + 50 * MS))
        spans.items += [("step", a - step * MS, a) for a in steps]
    return RunRecord({"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "d_head": 4,
                      "d_ff": 16, "vocab_size": 10}, t, waves, (1000 * MS, 3000 * MS), 12.5, spans, device=device)


def test_end_to_end_over_all_requests_and_the_whole_window():
    r = _record()
    assert load_reader("output_tokens_per_s")(r) == pytest.approx(4 * r.traffic.answer_tokens / 2.0)
    gaps = readers.token_gaps_ms(r)
    assert len(gaps) == 4 * (r.traffic.answer_tokens - 1) and max(gaps) == pytest.approx(30.0)
    assert load_reader("setup_s")(r) == 12.5
    assert load_reader("load_wave_ms")(r) == pytest.approx(50.0)
    assert load_reader("sched_decode_ms_per_ktok")(r) == pytest.approx(1e3 * 0.04 / 6.0)
    r.waves[1].ok[0] = False  # a failed load loads no context
    assert load_reader("sched_decode_ms_per_ktok")(r) == pytest.approx(1e3 * 0.04 / 5.0)


def test_device_metrics_need_a_trace():
    r = _record()
    for name in ("gen_step_device_ms", "k7_roofline", "k3_roofline", "device_idle_pct.gen"):
        assert load_reader(name)(r) is None
    assert load_reader("mfu.gen")(r) > 0


def test_device_metrics_from_intervals():
    r = _record(device=[("rans_decode_kernel", 1000 * MS, 1100 * MS), ("x", 1050 * MS, 1150 * MS),
                        ("decode_split_kernel", 2310 * MS, 2320 * MS)])
    r.k7_calls = [(1000, 100, 50_000)]
    assert load_reader("device_idle_pct.gen")(r) == pytest.approx(100 * (1 - 160 / 2000))
    assert load_reader("k7_roofline")(r) == pytest.approx(100 * yardstick.k7_bound_s(1000, 100, 50_000) / 0.1)
    k3 = load_reader("k3_roofline")(r)
    assert 0 < k3 < 100
    # device time inside the 6 step spans: 30 ms of the first wave's, 10 of the second's
    assert load_reader("gen_step_device_ms")(r) == pytest.approx(40 / 6)
