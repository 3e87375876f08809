"""The port's ``ContinuousScheduler``, row pool and row primitives against
the reference's, on ``smollm-360m.tiny()`` in f32 with the reference's
weights and the same stored bytes.

The cases are those of ``tests/test_continuous.py`` (and its EDF case in
``tests/test_generation.py``): at t = 0 with ``rows=None`` the loop equals
the wave, at N = 1 the session; admission queues, recycles and backdates;
a straggler is preempted and resumed, or convoys with preemption off; a
waiter without headroom preempts nothing; EDF admits by deadline.  Each
run must equal the reference's: every request's result
(``_torch_session_world.assert_same``), every ``RequestTimeline`` field,
the occupancy samples and the preemption counts.  ``RowPool`` and
``ShardedRowPool`` follow the reference's draw for draw over fixed seeds,
and the row primitives own their memory: a ``RowSnapshot``, and a cache in
a ``SessionResult``, keep their contents after later in-place writes to
the pool cache.
"""
import numpy as np
import pytest
import torch

from _torch_session_world import T_CTX, TEXT, assert_caches_equal, build_world, continuous_both, ideal

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return build_world()


def _m(u):
    """``tests/test_continuous.py::_trace_matrix``, as ``(name, args)``."""
    return {
        "flat": ("constant", (400 * u,)),
        "falling": ("steps", (0.2, [1.0 * u, 0.55 * u])),
        "oscillating": ("steps", (0.15, [2.0 * u, 0.4 * u, 2.0 * u, 0.4 * u])),
        "collapsed": ("constant", (0.002 * u,)),
        "fast3": ("constant", (3 * u,)),
        "fast50": ("constant", (50 * u,)),
    }


# ---------------------------------------------------------------------------
# t = 0 / N = 1 degeneration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("serialized", [False, True], ids=["ideal", "serialized"])
def test_continuous_t0_equals_wave(world, serialized):
    m = _m(world["u"])
    traces = [m["flat"], m["falling"], m["oscillating"], m["fast3"]]
    contention = (lambda side: side.pipeline.ContentionModel({})) if serialized else ideal
    cont = continuous_both(world, traces, priors=False, contention=contention)
    port = world["sides"][0]
    wave = port.sched.ConcurrentScheduler(port.eng, contention=contention(port)).run(
        [port.request(world["tokens"], tr, prior=False) for tr in traces])
    assert cont.n_rows == len(traces) and cont.n_preemptions == cont.n_resumes == 0
    for name in ("n_rounds", "n_decode_batches", "n_text_batches", "n_runs"):
        assert getattr(cont, name) == getattr(wave, name), name
    for a, b in zip(cont.sessions, wave.sessions):
        assert [t.nbytes for t in a.timelines] == [t.nbytes for t in b.timelines]
        assert a.ttft_s == b.ttft_s
        assert_caches_equal(a, b)
    if not serialized:
        configs = [c for s in cont.sessions for c in s.configs]
        assert TEXT in configs and any(c != TEXT for c in configs) and cont.n_decode_batches >= 1


@pytest.mark.parametrize("pinned", [False, True], ids=["adaptive", "level0"])
def test_continuous_n1_equals_session(world, pinned):
    u = world["u"]
    trace, kw = (("constant", (3 * u,)), dict(fixed_level=0)) if pinned else (("steps", (0.2, [u, 0.55 * u])), {})
    out = continuous_both(world, [trace], kws=[kw])
    port = world["sides"][0]
    net = port.network(trace)
    solo = port.sched_session(**kw).run("ctx", world["tokens"], net, prior_throughput_gbps=float(net.trace.gbps[0]))
    assert out.sessions[0].ttft_s == solo.ttft_s
    assert_caches_equal(out.sessions[0], solo)


# ---------------------------------------------------------------------------
# admission: queueing, recycling, backdating, EDF
# ---------------------------------------------------------------------------


def test_admission_queues_and_recycles_rows(world):
    m = _m(world["u"])
    out = continuous_both(world, [m["falling"], m["fast3"]], kws=[{}, dict(fixed_level=0)], rows=1)
    t0, t1 = out.timeline
    assert t0.admit_t == 0.0 and t0.queue_wait_s == 0.0
    assert t1.admit_t == pytest.approx(t0.finish_t) and t1.queue_wait_s > 0.0
    assert t0.rows_used == [0] and t1.rows_used == [0]
    assert out.sessions[1].ttft_s > t1.queue_wait_s
    assert all(int(s.caches.length[0]) == T_CTX for s in out.sessions)


def test_admission_backdates_to_arrival_on_free_row(world):
    u = world["u"]
    slow, fast = ("constant", (0.05 * u,)), ("constant", (3 * u,))
    out = continuous_both(world, [slow, fast], kws=[dict(fixed_level=0), {}], arrivals=[0.0, 0.4], rows=2)
    assert out.timeline[1].admit_t == pytest.approx(0.4)
    assert out.timeline[1].queue_wait_s == pytest.approx(0.0)
    port = world["sides"][0]
    net = port.network(fast)
    solo = port.sched_session().run("ctx", world["tokens"], net, prior_throughput_gbps=float(net.trace.gbps[0]),
                                    start_t=0.4)
    assert out.sessions[1].ttft_s == solo.ttft_s
    assert_caches_equal(out.sessions[1], solo)


def test_edf_admission_orders_waiters_by_deadline(world):
    u = world["u"]
    traces = [("constant", (0.4 * u,)), ("constant", (3 * u,)), ("constant", (3 * u,))]
    kws = [dict(fixed_level=0), dict(fixed_level=0, slo_s=10.0), dict(fixed_level=0, slo_s=0.5)]
    fifo = continuous_both(world, traces, kws=kws, arrivals=[0.0, 0.01, 0.02], rows=1, admission="fifo")
    assert fifo.timeline[1].admit_t < fifo.timeline[2].admit_t
    edf = continuous_both(world, traces, kws=kws, arrivals=[0.0, 0.01, 0.02], rows=1, admission="edf")
    assert edf.timeline[2].admit_t < edf.timeline[1].admit_t
    assert edf.timeline[2].admit_t == pytest.approx(edf.timeline[0].finish_t)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


def _straggler(u):
    return ("steps", (0.1, [3.0 * u, 0.0005 * u])), ("constant", (50 * u,))


def test_preemption_straggler_yields_row_and_resumes(world):
    """The straggler's fetch is cancelled, its prefix suspended and restored
    (possibly elsewhere); both loads end with every chunk realized, and
    their caches equal the reference's bit for bit (level 0)."""
    slow, fast = _straggler(world["u"])
    out = continuous_both(world, [slow, fast], kws=[dict(fixed_level=0)] * 2, arrivals=[0.0, 0.3], rows=1,
                          policy={})
    assert out.n_preemptions == 1 and out.n_resumes == 1
    t0, t1 = out.timeline
    assert t0.preempt_ts == [pytest.approx(0.3)] and len(t0.resume_ts) == 1
    assert t1.admit_t == pytest.approx(0.3) and t1.finish_t < t0.finish_t
    assert out.sessions[1].ttft_s < 1.25
    assert len(out.sessions[0].timelines) == len(world["metas"])
    assert all(int(s.caches.length[0]) == T_CTX for s in out.sessions)


def test_preemption_disabled_means_fifo_convoy(world):
    slow, fast = _straggler(world["u"])
    out = continuous_both(world, [slow, fast], kws=[dict(fixed_level=0)] * 2, arrivals=[0.0, 0.3], rows=1)
    assert out.n_preemptions == 0
    assert out.sessions[1].ttft_s > out.sessions[1].slo_s
    assert out.timeline[1].admit_t == pytest.approx(out.timeline[0].finish_t)


@pytest.mark.parametrize("waiter_slo,preempts", [(0.1, 0), (1.25, 1)], ids=["expired", "headroom"])
def test_preemption_respects_waiter_headroom(world, waiter_slo, preempts):
    u = world["u"]
    sizes = [m.sizes[0] for m in world["metas"]]
    rate_fast = (sizes[0] + sizes[1]) * 8.0 / 1e9 / 0.30
    slow, fast = ("steps", (0.31, [rate_fast, 0.0005 * u])), ("constant", (50 * u,))
    out = continuous_both(world, [slow, fast], kws=[dict(fixed_level=0), dict(fixed_level=0, slo_s=waiter_slo)],
                          arrivals=[0.0, 0.05], rows=1, policy={})
    assert out.n_preemptions == preempts


def test_resume_and_preempt_misuse_raise(world):
    u = world["u"]
    for side in world["sides"]:
        trace = ("constant", (3 * u,))
        task = side.session.SessionTask(side.sched_session(fixed_level=0), "ctx", world["tokens"],
                                        side.network(trace), label="req0:ctx")
        with pytest.raises(RuntimeError, match=r"resuming request 'req0:ctx'.*not suspended"):
            task.resume(0, 1.0)
        while not task.done:
            task.step()
        with pytest.raises(RuntimeError, match=r"preempting request 'req0:ctx'.*already finished"):
            task.suspend(1.0)


def test_scheduler_validates_knobs(world):
    for side in world["sides"]:
        for kw, what in ((dict(admission="lifo"), "admission"), (dict(gen_step_s=0.0), "gen_step_s"),
                         (dict(rows=0), "rows >= 1")):
            with pytest.raises(ValueError, match=what):
                side.sched.ContinuousScheduler(side.eng, contention=ideal(side), **kw)
        with pytest.raises(ValueError, match="one per shard"):
            side.sched.ContinuousScheduler(side.eng, contention=ideal(side), shard_transports=[None, None])
        with pytest.raises(ValueError, match="one per shard"):
            side.sched.ConcurrentScheduler(side.eng, contention=ideal(side), shard_transports=[])


# ---------------------------------------------------------------------------
# row pool: parity over fixed seeds, and its errors
# ---------------------------------------------------------------------------


def _drive_pool(pool, seed, n_ops=120):
    """A fixed-seed sequence of admit/release calls; returns every answer
    and error message in order."""
    rng = np.random.default_rng(seed)
    log, owned, t, nxt = [], {}, 0.0, 0
    for _ in range(n_ops):
        t += float(rng.uniform(0.0, 1.0))
        if int(rng.integers(3)) == 0 or not owned:
            owner = f"req{nxt}:ctx"
            try:
                row, since, dirty = pool.allocate(owner)
            except RuntimeError as e:
                log.append(("full", str(e)))
                continue
            nxt += 1
            owned[row] = owner
            log.append(("alloc", row, since, dirty, [pool.shard_of(r) for r in sorted(owned)]))
        else:
            row = sorted(owned)[int(rng.integers(len(owned)))]
            pool.release(row, owned.pop(row), t)
            log.append(("release", row, pool.n_free, pool.next_free_since))
        log.append(pool.describe())
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_row_pool_matches_reference(world, seed, shards):
    (port, ref) = (side.sched for side in world["sides"])
    n_rows = 4 * shards if seed % 2 else 2 * shards
    make = (lambda mod: mod.RowPool(n_rows)) if shards == 1 else (
        lambda mod: mod.ShardedRowPool(n_rows, n_shards=shards))
    assert _drive_pool(make(port), seed) == _drive_pool(make(ref), seed)


def test_row_pool_errors_name_request_and_state(world):
    for side in world["sides"]:
        pool = side.sched.RowPool(2)
        pool.allocate("req0:ctx")
        pool.allocate("req1:ctx")
        with pytest.raises(RuntimeError, match=r"req2:ctx.*beyond row-pool capacity.*0/2 rows free"):
            pool.allocate("req2:ctx")
        with pytest.raises(RuntimeError, match=r"row 7.*req0:ctx.*not allocated"):
            pool.release(7, "req0:ctx", 1.0)
        with pytest.raises(RuntimeError, match=r"row 1.*req0:ctx.*owned by 'req1:ctx'"):
            pool.release(1, "req0:ctx", 1.0)
        with pytest.raises(ValueError, match="at least one row"):
            side.sched.RowPool(0)
        with pytest.raises(ValueError, match="do not split"):
            side.sched.ShardedRowPool(3, n_shards=2)


# ---------------------------------------------------------------------------
# row primitives: bit-exact round trips and owned memory
# ---------------------------------------------------------------------------


def _loaded_pool(world):
    """The port's 3-row pool cache with the whole context decoded (level 0)
    into rows 0 and 2 at different lengths."""
    port = world["sides"][0]
    eng = port.eng
    blobs = port.store.get_run("ctx", [(c, 0) for c in range(5)])
    from repro_torch.core import codec

    kv = codec.decode_chunks(blobs, port.tables, out_dtype=torch.float32)
    caches = eng.insert_runs(eng.empty_caches(3), kv[:, :, :T_CTX], rows=[0], starts=[0], run_tokens=[T_CTX])
    return eng, eng.insert_runs(caches, kv[:, :, :60], rows=[2], starts=[0], run_tokens=[60])


def test_save_reset_restore_round_trip_is_bit_exact(world):
    eng, caches = _loaded_pool(world)
    snap = eng.save_row(caches, 0, T_CTX)
    want_k, want_v = caches.kv_k[:, 0].clone(), caches.kv_v[:, 0].clone()
    caches = eng.reset_rows(caches, [0, 1])
    assert caches.length.tolist() == [0, 0, 60] and not caches.kv_k[:, :2].any() and not caches.kv_v[:, :2].any()
    # the snapshot owns its memory: the reset pool row is zero, it is not
    assert torch.equal(snap.kv_k, want_k[:, :T_CTX]) and torch.equal(snap.kv_v, want_v[:, :T_CTX])
    caches = eng.restore_row(caches, snap, 1)
    assert caches.length.tolist() == [0, T_CTX, 60]
    assert torch.equal(caches.kv_k[:, 1], want_k) and torch.equal(caches.kv_v[:, 1], want_v)
    # later in-place writes to the pool do not reach the snapshot either
    caches = eng.decode_step_rows(np.zeros((3, 1), np.int32), caches, np.array([True, True, True]))[1]
    caches = eng.reset_rows(caches, [1])
    assert torch.equal(snap.kv_k, want_k[:, :T_CTX]) and torch.equal(snap.kv_v, want_v[:, :T_CTX])


def test_row_primitives_validate_like_reference(world):
    for side in world["sides"]:
        eng = side.eng
        caches = eng.empty_caches(2)
        with pytest.raises(ValueError, match="save_row: row 2 out of range"):
            eng.save_row(caches, 2, 1)
        with pytest.raises(ValueError, match="tokens out of range"):
            eng.save_row(caches, 0, eng.capacity + 1)
        snap = eng.save_row(caches, 0, 4)
        with pytest.raises(ValueError, match="restore_row: row -1 out of range"):
            eng.restore_row(caches, snap, -1)
        with pytest.raises(ValueError, match=r"reset_rows: rows \[0, 5\] out of range"):
            eng.reset_rows(caches, [0, 5])


def test_extract_row_is_a_view_and_results_keep_their_cache(world):
    """``extract_row`` is a view of the pool (a later write shows through),
    so the continuous loop copies a row when its load finishes: a request
    whose row went on to another tenant still holds its own load."""
    from repro_torch.serving import kv_layout

    eng, caches = _loaded_pool(world)
    view = kv_layout.extract_row(caches, 0)
    caches = eng.reset_rows(caches, [0])
    assert not view.kv_k.any()
    m = _m(world["u"])
    out = continuous_both(world, [m["fast3"], m["falling"]], kws=[dict(fixed_level=0), {}], rows=1)
    # row 0 was reset for request 1, then held its load: request 0's cache
    # is its own copy, equal to the session run alone
    assert out.timeline[1].rows_used == [0]
    port = world["sides"][0]
    net = port.network(m["fast3"])
    solo = port.sched_session(fixed_level=0).run("ctx", world["tokens"], net,
                                                 prior_throughput_gbps=float(net.trace.gbps[0]))
    assert_caches_equal(out.sessions[0], solo)
    assert out.sessions[0].caches.kv_k.data_ptr() != out.sessions[1].caches.kv_k.data_ptr()
