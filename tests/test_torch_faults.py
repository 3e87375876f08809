"""The port's fault layer (``streaming/faults.py``) and the session's retry,
degrade, salvage and resume paths against the reference's.

Seeded ``FaultPlan``s draw the reference's faults key for key; the same
plan over the same stored bytes must then end each session the same way in
both packages: the same ``status``, decisions, virtual timelines and every
fault and salvage counter, the same cache (level-0 chunks bit-exact, lossy
chunks within 2e-5) and the same greedy tokens.  The cases are the ``Sim``
and ``Local`` ones of ``tests/test_faults.py`` and ``tests/test_resume.py``.
Random fault plans come from a fixed list, drawn once from a seeded RNG.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_session_world import CHUNK, R_SLOW, T_CTX, assert_same, build_world, reconcile, to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return build_world()


def _outcome(side, scenario):
    """``scenario(side)`` -> (result, extras), or the exception it raised."""
    try:
        return scenario(side)
    except Exception as e:  # noqa: BLE001 - compared across packages below
        return e


def _both(world, scenario):
    """Run ``scenario`` in both packages; they must end the same way: the
    same exception type, or results held equal by ``assert_same`` with equal
    extras (injection counters)."""
    got, want = (_outcome(side, scenario) for side in world["sides"])
    if isinstance(got, Exception) or isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__, (got, want)
        return got
    (res, extra), (jres, jextra) = got, want
    assert extra == jextra
    assert_same(world, res, jres)
    return res


def _faulty(side, plan, trace, *, backend=False):
    """(store, network, FaultyTransport over a SimTransport) for ``plan``."""
    store = side.faults.with_faulty_backend(side.store, plan) if backend else side.store
    network = side.network(trace)
    return store, network, side.faults.FaultyTransport(side.tr.SimTransport(store, network), plan)


def _extras(ft, store=None):
    out = dict(ft.n_injected)
    if store is not None:
        out.update(missing=store.backend.n_missing_reads, corrupt=store.backend.n_corrupt_reads)
    return out


# ---------------------------------------------------------------------------
# FaultPlan, FaultyBackend, delete_kv
# ---------------------------------------------------------------------------


def test_fault_plan_draws_equal_reference_key_for_key(world):
    port, ref = world["sides"]
    cases = [  # (plan, the in-flight kinds it must draw)
        (dict(seed=7, drop_p=0.2, stall_p=0.2, corrupt_p=0.2, missing_p=0.3, store_corrupt_p=0.3),
         {"drop", "stall", "corrupt"}),
        (dict(seed=42, truncate_p=0.6), {"truncate"}),
        (dict(seed=2**33 + 5, drop_p=0.1, stall_p=0.3, truncate_p=0.3, stall_scale_s=5.0, stall_alpha=2.5,
              drop_detect_s=0.1), {"drop", "stall", "truncate"}),
        (dict(seed=0), set()),
    ]
    blob = port.store.get_kv("ctx", 1, 2)
    for k, want_kinds in cases:
        plan, jplan = port.faults.FaultPlan(**k), ref.faults.FaultPlan(**k)
        kinds = set()
        for cid in ("ctx", "other"):
            for chunk in range(5):
                for level in range(-1, 5):
                    for attempt in range(4):
                        got, want = plan.draw(cid, chunk, level, attempt), jplan.draw(cid, chunk, level, attempt)
                        assert (got is None) == (want is None)
                        if got is not None:
                            assert dataclasses.asdict(got) == dataclasses.asdict(want)
                            kinds.add(got.kind)
                        assert plan.truncate_fraction(cid, chunk, level, attempt) == \
                               jplan.truncate_fraction(cid, chunk, level, attempt)
                        assert plan.corrupt_bytes(blob, cid, chunk, level, attempt) == \
                               jplan.corrupt_bytes(blob, cid, chunk, level, attempt)
                    assert plan.missing(cid, chunk, level) == jplan.missing(cid, chunk, level)
                    assert plan.corrupt_at_rest(cid, chunk, level) == jplan.corrupt_at_rest(cid, chunk, level)
        assert kinds == want_kinds
    assert port.faults.FaultPlan().corrupt_bytes(b"\x00", "ctx", 0, 1) == \
           ref.faults.FaultPlan().corrupt_bytes(b"\x00", "ctx", 0, 1) != b"\x00"
    for side in world["sides"]:
        with pytest.raises(ValueError, match="exceeds 1"):
            side.faults.FaultPlan(drop_p=0.6, stall_p=0.3, corrupt_p=0.2)


def test_delete_kv_and_faulty_backend_match_reference(world):
    counts = []
    for side in world["sides"]:
        store = side.copy_store()
        assert store.delete_kv("ctx", 2, 1) is True and store.delete_kv("ctx", 2, 1) is False
        with pytest.raises(KeyError, match="chunk 2 level 1"):
            store.get_kv("ctx", 2, 1)
        assert store.get_kv("ctx", 2, 2) == side.store.get_kv("ctx", 2, 2) and len(store.meta("ctx")) == 5
        fstore = side.faults.with_faulty_backend(side.store, side.faults.FaultPlan(seed=11, missing_p=0.4,
                                                                                   store_corrupt_p=0.3))
        seen = []
        for ci in range(T_CTX // CHUNK):
            for lvl in range(5):
                try:
                    seen.append(fstore.get_kv("ctx", ci, lvl) == side.store.get_kv("ctx", ci, lvl))
                except KeyError:
                    seen.append("missing")
                except ValueError:
                    seen.append("corrupt")
        assert seen.count("missing") == fstore.backend.n_missing_reads > 0
        assert seen.count("corrupt") == fstore.backend.n_corrupt_reads > 0
        assert fstore.meta("ctx") is side.store.meta("ctx")
        counts.append(seen)
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# retry / degrade / TEXT fallback (tests/test_faults.py)
# ---------------------------------------------------------------------------

def _flat(world):
    return ("constant", (400 * world["u"],))


def test_retry_degrade_matches_reference(world):
    def scenario(side):
        plan = side.faults.FaultPlan(seed=3, drop_p=0.15, stall_p=0.1, corrupt_p=0.1, missing_p=0.1)
        store, network, ft = _faulty(side, plan, _flat(world), backend=True)
        res = side.serve(retry_policy=side.tr.RetryPolicy(max_attempts=3, timeout_s=0.5)).run(
            "ctx", world["tokens"], network, transport=ft)
        return res, _extras(ft, store)

    res = _both(world, scenario)
    assert res.status == "ok" and int(res.caches.length[0]) == T_CTX
    assert res.n_retries + res.n_degrades + res.n_fault_text > 0
    assert res.n_failed_attempts == sum(res.fault_counts.values()) > 0


def test_stall_timeout_path_matches_reference(world):
    def scenario(side):
        plan = side.faults.FaultPlan(seed=0, stall_p=1.0, stall_scale_s=30.0)
        _, network, ft = _faulty(side, plan, _flat(world))
        res = side.serve(retry_policy=side.tr.RetryPolicy(max_attempts=2, backoff_s=0.01, timeout_s=0.2)).run(
            "ctx", world["tokens"], network, transport=ft)
        return res, _extras(ft)

    res = _both(world, scenario)
    assert res.status == "ok" and res.fault_counts.get("timeout", 0) > 0 and res.n_fault_text == 5


def test_exhaustion_without_text_fails_like_reference(world):
    def scenario(side):
        plan = side.faults.FaultPlan(seed=1, drop_p=1.0)
        _, network, ft = _faulty(side, plan, _flat(world))
        res = side.serve(allow_text=False, retry_policy=side.tr.RetryPolicy(max_attempts=2, backoff_s=0.01)).run(
            "ctx", world["tokens"], network, transport=ft)
        return res, _extras(ft)

    res = _both(world, scenario)
    assert res.status == "failed" and "exhausted" in res.failure and res.ttft_s == float("inf")


def test_legacy_no_policy_crash_matches_reference(world):
    msgs = []
    for side in world["sides"]:
        _, network, ft = _faulty(side, side.faults.FaultPlan(seed=1, drop_p=1.0), _flat(world))
        with pytest.raises(side.tr.FetchError) as err:
            side.serve().run("ctx", world["tokens"], network, transport=ft)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "context 'ctx'" in msgs[0] and "(chunk, level)=" in msgs[0]


@pytest.mark.parametrize("resume_fetch", [True, False], ids=["resume", "whole_blob"])
def test_zero_fault_policy_is_bit_identical_like_reference(world, resume_fetch):
    """No faults: a policy-armed session equals the unarmed one, in both."""
    u = world["u"]
    rc = lambda t, p: 0.04 * t / CHUNK  # noqa: E731

    def scenario(side):
        trace = ("steps", (0.2, [2.0 * u, 0.6 * u]))
        base = side.serve(rc=rc).run("ctx", world["tokens"], side.network(trace))
        res = side.serve(rc=rc, retry_policy=side.tr.RetryPolicy(max_attempts=3, timeout_s=10.0),
                         resume_fetch=resume_fetch).run(
            "ctx", world["tokens"], side.network(trace))
        assert res.configs == base.configs and res.ttft_s == base.ttft_s
        for a, b in ((res.caches.kv_k, base.caches.kv_k), (res.caches.kv_v, base.caches.kv_v)):
            np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
        reconcile(res)
        return res, {}

    res = _both(world, scenario)
    assert res.n_retries == res.n_resumes == res.salvaged_bytes == 0 and res.wire_bytes > 0


def _random_plans():
    """The strategy of ``tests/test_faults.py``'s property test, drawn once
    from a fixed seed: (seed, drop, stall, corrupt, missing, backend faults,
    degrade, allow_text)."""
    rng = np.random.default_rng(2026)
    return [(int(rng.integers(0, 2**20)), float(rng.uniform(0, 0.3)), float(rng.uniform(0, 0.2)),
             float(rng.uniform(0, 0.3)), float(rng.uniform(0, 0.3)), bool(backend), bool(degrade), bool(text))
            for backend, degrade, text in [(0, 0, 0), (0, 1, 1), (0, 1, 0), (0, 0, 1),
                                           (1, 0, 0), (1, 1, 1), (1, 1, 0), (1, 0, 1)]]


@pytest.mark.parametrize("case", _random_plans(), ids=lambda c: f"seed{c[0]}")
def test_random_fault_plans_end_like_reference(world, case):
    seed, drop_p, stall_p, corrupt_p, missing_p, backend, degrade, allow_text = case

    def scenario(side):
        if backend:
            plan = side.faults.FaultPlan(seed=seed, missing_p=missing_p, store_corrupt_p=corrupt_p)
        else:
            plan = side.faults.FaultPlan(seed=seed, drop_p=drop_p, stall_p=stall_p, corrupt_p=corrupt_p,
                                         stall_scale_s=5.0)
        store, network, ft = _faulty(side, plan, _flat(world), backend=True)
        res = side.serve(allow_text=allow_text, retry_policy=side.tr.RetryPolicy(
            max_attempts=2, backoff_s=0.01, timeout_s=0.5, degrade=degrade)).run(
            "ctx", world["tokens"], network, transport=ft)
        assert res.n_failed_attempts == sum(res.fault_counts.values())
        return res, _extras(ft, store)

    _both(world, scenario)


def test_deleted_entry_takes_the_degrade_ladder_like_reference(world):
    """``delete_kv`` behind the reader: the fetch of that entry is
    ``missing``, never retried, and the chunk is re-decided coarser."""
    u = world["u"]

    def scenario(side):
        store = side.copy_store()
        for lvl in (0, 1):
            store.delete_kv("ctx", 1, lvl)
        network = side.network(("constant", (100 * u,)))
        sess = side.session.ServeSession(side.copy_streamer(store), side.eng, slo_s=30.0, recompute_s=R_SLOW,
                                         decode_bytes_per_s=1e9, allow_text=False,
                                         retry_policy=side.tr.RetryPolicy(max_attempts=3))
        return sess.run("ctx", world["tokens"], network, prior_throughput_gbps=100 * u), {}

    res = _both(world, scenario)
    assert res.status == "ok" and res.configs[1] == 2 and res.fault_counts == {"missing": 2} and res.n_retries == 0


# ---------------------------------------------------------------------------
# byte-range resume (tests/test_resume.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gbps_u, slo_s, seed", [(1.0, 1.0, 1), (0.8, 1.3, 0)])
def test_degrade_prices_salvage_credit_like_reference(world, gbps_u, slo_s, seed):
    """Retries exhausted on truncated fetches: the chunk is re-decided with
    the salvaged prefix credited per level (``adaptation.salvage_credit``),
    which here changes the decisions and how far the load gets."""
    u = world["u"]

    def scenario(side):
        network = side.network(("constant", (gbps_u * u,)))
        ft = side.faults.FaultyTransport(side.tr.SimTransport(side.store, network),
                                         side.faults.FaultPlan(seed=seed, truncate_p=0.7))
        res = side.serve(slo_s=slo_s, allow_text=False, retry_policy=side.tr.RetryPolicy(
            max_attempts=2, backoff_s=0.01)).run("ctx", world["tokens"], network, transport=ft,
                                                 prior_throughput_gbps=gbps_u * u)
        reconcile(res)
        return res, _extras(ft)

    res = _both(world, scenario)
    assert res.n_degrades >= 2 and res.salvaged_bytes >= 0


def test_range_fetch_and_truncate_salvage_match_reference(world):
    """Sim and local byte ranges, and a truncate fault's salvage, are the
    reference's bytes."""
    out = []
    for side in world["sides"]:
        network = side.network(_flat(world))
        got = []
        for t in (side.tr.SimTransport(side.store, network), side.tr.LocalTransport(side.store)):
            for byte_range in [(1000, None), (1000, 500), (10**9, None)]:
                res = t.fetch_run("ctx", [(0, 1)], byte_range=byte_range, resumable=True).result(timeout=30)
                got.append((res.blobs, res.nbytes, res.range_offset, res.range_total, res.seg_index.total))
            plan = side.faults.FaultPlan(seed=5, truncate_p=1.0)
            ft = side.faults.FaultyTransport(t, plan)
            with pytest.raises(side.tr.FetchError) as err:
                ft.fetch_run("ctx", [(0, 1)], resumable=True).result(timeout=30)
            s = err.value.salvage
            got.append((s.data, s.offset, s.total, s.nbytes_wire, s.index.verified_prefix(s.data),
                        dataclasses.asdict(s.index), ft.n_injected))
        out.append(got)
    assert out[0] == out[1]


def _truncated(world, side, *, resume):
    plan = side.faults.FaultPlan(seed=42, truncate_p=0.6)
    _, network, ft = _faulty(side, plan, _flat(world))
    res = side.serve(retry_policy=side.tr.RetryPolicy(max_attempts=3, backoff_s=0.01, timeout_s=0.5),
                     resume_fetch=resume).run("ctx", world["tokens"], network, transport=ft)
    reconcile(res)
    return res, _extras(ft)


@pytest.mark.parametrize("resume", [True, False], ids=["resume", "whole_blob"])
def test_truncate_resume_matches_reference(world, resume):
    res = _both(world, lambda side: _truncated(world, side, resume=resume))
    assert res.status == "ok" and int(res.caches.length[0]) == T_CTX
    if resume:
        assert res.n_resumes > 0 and res.salvaged_bytes > 0
        assert all(tl.salvaged_bytes > 0 for tl in res.timelines if tl.resumed)
    else:
        assert res.n_resumes == 0 and res.salvaged_bytes == 0 and res.n_retries > 0


def test_truncate_resume_over_local_transport_matches_reference(world):
    """Local reads: their times are host wall time, so only the decisions
    (a fixed level), counters, bytes and caches are compared."""
    def scenario(side):
        plan = side.faults.FaultPlan(seed=3, truncate_p=0.5)  # at most 4 truncations a chunk
        ft = side.faults.FaultyTransport(side.tr.LocalTransport(side.store), plan)
        res = side.serve(fixed_level=1, retry_policy=side.tr.RetryPolicy(max_attempts=6, backoff_s=0.0)).run(
            "ctx", world["tokens"], side.network(_flat(world)), transport=ft)
        reconcile(res)
        fields = ("chunk_idx", "config", "nbytes", "n_retries", "salvaged_bytes", "wire_bytes", "refetched_bytes",
                  "resumed")
        return res, dict(_extras(ft), timelines=[[getattr(t, f) for f in fields] for t in res.timelines])

    got, want = (_outcome(side, scenario) for side in world["sides"])
    (res, extra), (jres, jextra) = got, want
    assert extra == jextra and res.configs == jres.configs == [1] * 5
    for name in ("status", "n_retries", "n_degrades", "n_failed_attempts", "fault_counts", "salvaged_bytes",
                 "refetched_bytes", "wire_bytes", "n_resumes"):
        assert getattr(res, name) == getattr(jres, name), name
    assert res.n_resumes > 0 and res.salvaged_bytes > 0
    np.testing.assert_allclose(res.caches.kv_k[:, :, :T_CTX].numpy(), np.asarray(jres.caches.kv_k[:, :, :T_CTX]),
                               atol=2e-5, rtol=2e-5)


def test_suspend_resume_mid_fetch_matches_reference(world):
    """A preempted fetch's verified prefix survives suspend/resume, by direct
    calls on ``SessionTask`` (``tests/test_resume.py``'s case)."""
    u = world["u"]

    def scenario(side):
        sess = side.serve(retry_policy=side.tr.RetryPolicy(max_attempts=3, timeout_s=10.0))
        network = side.network(("constant", (u,)))  # chunk 0 takes ~0.2 s
        task = side.session.SessionTask(sess, "ctx", world["tokens"], network,
                                        transport=side.tr.SimTransport(side.store, network))
        caches, state = side.eng.empty_caches(1), side.session._ExecState()
        while task._pending is None:
            for w in task.step():
                caches = sess._execute_one(w, caches, state)
        peeks = [(task.fetch_ready, task.peek_pending_end_t(), task.horizon_t(), task.next_fetch_t,
                  task.deadline_t, task.realized_tokens)]
        task.suspend(0.1)
        sv = task._salvage
        with pytest.raises(RuntimeError, match="suspended"):
            task.step()
        with pytest.raises(RuntimeError, match="already suspended"):
            task.suspend(0.12)
        task.resume(0, 0.15)
        while not task.done:
            peeks.append((task.fetch_ready, task.peek_pending_end_t(), task.horizon_t(), task.next_fetch_t,
                          task.deadline_t, task.realized_tokens))
            for w in task.step():
                caches = sess._execute_one(w, caches, state)
        res = task.result(caches, wall_decode_s=0.0, wall_recompute_s=0.0, wall_total_s=0.0, n_runs=state.runs)
        reconcile(res)
        with pytest.raises(RuntimeError, match="already finished"):
            task.suspend(1.0)
        return res, dict(salvage=(sv.level, sv.verified_end, sv.total, sv.data), n_preemptions=task.n_preemptions,
                         cancelled=task.cancelled_fetches, resumes=task.n_resumes, peeks=peeks)

    res = _both(world, scenario)
    assert res.status == "ok" and res.salvaged_bytes > 0 and res.n_resumes >= 1


@pytest.mark.parametrize("low", [0.002, 0.00053], ids=["collapse", "deep_collapse"])
def test_mid_chunk_replan_matches_reference(world, low):
    def scenario(side):
        trace = ("steps", (0.001, [2.0, low]))
        res = side.serve(rc=lambda t, p: 0.3, replan_factor=3.0, retry_policy=side.tr.RetryPolicy(
            max_attempts=3, backoff_s=0.05, timeout_s=50.0)).run(
            "ctx", world["tokens"], side.network(trace, rtt_s=0.0005), prior_throughput_gbps=2.0)
        reconcile(res)
        pinned = side.serve(rc=lambda t, p: 0.3, fixed_level=0).run(
            "ctx", world["tokens"], side.network(trace, rtt_s=0.0005), prior_throughput_gbps=2.0)
        return res, dict(pinned=(pinned.configs, pinned.ttft_s))

    res = _both(world, scenario)
    assert res.status == "ok" and res.n_mid_chunk_replans >= 1 and not res.slo_violated
    assert any(tl.replanned for tl in res.timelines)


# ---------------------------------------------------------------------------
# the reference's trailer-magic fault, carried by parity
# ---------------------------------------------------------------------------


class _TrailerFlip:
    """Wraps a transport; flips 4 bytes of chunk 0's first delivered blob at
    ``offset`` from its end (8: the ``KVC1`` trailer magic; 4: the CRC)."""

    supports_range = True
    realtime = False

    def __init__(self, side, inner, offset):
        self.side, self.inner, self.offset, self.fired = side, inner, offset, False

    def fetch_run(self, cid, chunk_levels, **kw):
        handle = self.inner.fetch_run(cid, chunk_levels, **kw)
        if self.fired or chunk_levels[0][0] != 0:
            return handle
        self.fired = True

        def flip(res):
            blob, i = res.blobs[0], len(res.blobs[0]) - self.offset
            return dataclasses.replace(res, blobs=[blob[:i] + bytes(b ^ 0xFF for b in blob[i:i + 4]) + blob[i + 4:]])

        return self.side.faults._TransformedHandle(handle, flip, context_id=cid, chunk_levels=chunk_levels,
                                                   salvageable=False)

    def close(self):
        pass


@pytest.mark.parametrize("offset", [8, 4], ids=["magic", "crc"])
def test_trailer_corruption_ends_like_reference(world, offset):
    """A corruption of exactly the 4 trailer-magic bytes makes the blob look
    trailer-less: the checksum gate passes it, and the decode's parse raises
    ``IntegrityError`` outside the retry path — in the reference, and so in
    the port.  The same flip on the CRC is caught by the gate and retried."""
    u = world["u"]

    def scenario(side):
        network = side.network(("constant", (100 * u,)))
        ft = _TrailerFlip(side, side.tr.SimTransport(side.store, network), offset)
        res = side.serve(slo_s=30.0, fixed_level=1, retry_policy=side.tr.RetryPolicy(max_attempts=3)).run(
            "ctx", world["tokens"], network, prior_throughput_gbps=100 * u, transport=ft)
        return res, {}

    res = _both(world, scenario)
    if offset == 8:
        assert type(res).__name__ == "IntegrityError"
    else:
        assert res.status == "ok" and res.fault_counts == {"integrity": 1} and res.n_retries == 1
