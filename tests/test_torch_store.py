"""The port's content-addressed tiered store (``TieredKVStore``) against the
reference's: the cases of ``tests/test_store.py`` that need no socket, each
run through both packages on the same KV, tokens and tables
(``tests/_torch_session_world.py``: ``smollm-360m.tiny()`` in f32 with the
reference's weights).

Blobs must be byte for byte the same, and hash keys, metadata, refcounts,
the hot tier's LRU order, every tier counter and every eviction victim
equal, step for step.  Level priorities are passed to both stores where
eviction is in play: by default each package reads its own session report
(the port's does not exist yet), so their default orders differ by design.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import _torch_session_world as W

T_CTX, CHUNK = W.T_CTX, W.CHUNK
N_CHUNKS = T_CTX // CHUNK

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return W.build_world()


def n_levels(world):
    return world["sides"][0].tables.config.n_levels


def toks(world):
    return world["tokens"][0].tolist()


def tiered(side, **kw):
    return side.st.TieredKVStore(side.tables, **kw)


def stored(world, side, cid="ctx", tokens=None, **kw):
    """A tiered store of ``side`` holding the world's context."""
    ts = tiered(side, **kw)
    ts.store_kv(cid, world["kv"], chunk_tokens=CHUNK, tokens=toks(world) if tokens is None else tokens)
    return ts


def both(world, scenario):
    return W.run_both(world, scenario)


def state(ts):
    """Everything a tiered store's behaviour depends on, as plain data."""
    return dict(
        counters=ts.tier_counters(),
        lru=list(ts._hot_lru.items()),
        refcount=dict(ts._refcount),
        hash_levels={h: dict(v) for h, v in ts._hash_levels.items()},
        probation=list(ts._probation.items()),
        hot_used=ts._hot_used,
        metas={cid: [dataclasses.asdict(m) for m in ms] for cid, ms in ts._meta.items()},
        hot=sorted(ts.hot._mem),
        cold=sorted(ts.cold._mem) if hasattr(ts.cold, "_mem") else None,
    )


def assert_same_state(ts, jts):
    assert state(ts) == state(jts)
    for key in ts.hot._mem:
        assert ts.hot._mem[key] == jts.hot._mem[key]
    if hasattr(ts.cold, "_mem"):
        for key in ts.cold._mem:
            assert ts.cold._mem[key] == jts.cold._mem[key]


# ---------------------------------------------------------------------------
# chain hashes: versioned, prefix-sharing, namespaced
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("namespace", ["", "a", "CodecConfig(group_size=10)"])
def test_chain_hashes_equal_reference(world, namespace):
    port, ref = world["sides"]
    for payloads in ([b"alpha", b"beta", b"gamma"], [b"alpha", b"alpha"], [b"doc", b"doc2", b"tail-b", b"same"]):
        keys = port.st.chain_hashes(payloads, namespace=namespace)
        assert keys == ref.st.chain_hashes(payloads, namespace=namespace)
        assert len(set(keys)) == len(keys)
        assert all(k.startswith(f"{port.st.HASH_CHAIN_VERSION}-") and len(k) == 4 + 1 + 40 for k in keys)
    a, b = [b"doc", b"doc2", b"tail-a"], [b"doc", b"doc2", b"tail-b"]
    ka, kb = port.st.chain_hashes(a), port.st.chain_hashes(b)
    assert ka[:2] == kb[:2] and ka[2] != kb[2]
    assert port.st.chain_hashes(a + [b"same"])[3] != port.st.chain_hashes(b + [b"same"])[3]
    assert port.st.HASH_CHAIN_VERSION == ref.st.HASH_CHAIN_VERSION


def test_token_payloads_equal_reference(world):
    port, ref = world["sides"]
    bounds = port.st.split_chunks(5, 2)
    assert bounds == ref.st.split_chunks(5, 2) == [(0, 2), (2, 4), (4, 5)]
    p = port.st.token_payloads([1, 2, 3, 4, 5], bounds)
    assert p == ref.st.token_payloads([1, 2, 3, 4, 5], bounds)
    assert p[0] == np.asarray([1, 2], "<u4").tobytes() and p[2] == np.asarray([5], "<u4").tobytes()


def test_chunk_hashes_over_tokens_and_kv_bytes_equal_reference(world):
    """Over token ids, over the KV's raw bytes as an f32 array or tensor,
    and over bf16 KV (the reference's ``jnp`` bf16 array against a torch
    bf16 tensor): the same keys, and the token length checked."""
    import jax.numpy as jnp

    port, ref = world["sides"]
    ts, jts = stored(world, port), stored(world, ref)
    bounds = port.st.split_chunks(T_CTX, CHUNK)
    kv = world["kv"]
    by_tok = ts.chunk_hashes(kv, bounds, toks(world))
    assert by_tok == jts.chunk_hashes(kv, bounds, toks(world)) == [m.chunk_hash for m in ts.meta("ctx")]
    by_kv = ts.chunk_hashes(kv, bounds)
    assert by_kv == jts.chunk_hashes(kv, bounds) != by_tok
    assert ts.chunk_hashes(torch.as_tensor(kv), bounds) == by_kv
    bf16 = ts.chunk_hashes(torch.as_tensor(kv).to(torch.bfloat16), bounds)
    assert bf16 == jts.chunk_hashes(jnp.asarray(kv, jnp.bfloat16), bounds) and bf16 != by_kv
    with pytest.raises(ValueError, match="tokens length"):
        ts.chunk_hashes(kv, bounds, toks(world)[:-1])


# ---------------------------------------------------------------------------
# dedup + refcounts
# ---------------------------------------------------------------------------


def test_shared_prefix_dedups_and_refcounts_like_reference(world):
    def scenario(side):
        ts = tiered(side)
        base = toks(world)
        other = base[: 3 * CHUNK] + [(t + 1) % 512 for t in base[3 * CHUNK:]]
        ma = ts.store_kv("A", world["kv"], chunk_tokens=CHUNK, tokens=base)
        mb = ts.store_kv("B", world["kv"], chunk_tokens=CHUNK, tokens=other)
        steps = [state(ts)]
        assert [m.chunk_hash for m in ma[:3]] == [m.chunk_hash for m in mb[:3]]
        assert ts.n_dedup_chunks == 3 and ts.n_encoded_chunks == N_CHUNKS + 2
        assert ts.unique_storage_bytes() < ts.logical_storage_bytes()
        blobs = [(ts.get_kv("A", ci, lvl), ts.get_kv("B", ci, lvl))
                 for ci in range(N_CHUNKS) for lvl in range(n_levels(world))]
        assert ts.delete_context("A") is True and ts.delete_context("A") is False
        steps.append(state(ts))
        blobs += [ts.get_kv("B", ci, 1) for ci in range(N_CHUNKS)]
        assert ts.delete_context("B") is True
        assert ts.unique_storage_bytes() == 0 and ts._refcount == {} and ts._hash_levels == {}
        assert ts._hot_used == 0 and not ts._hot_lru
        return steps, blobs

    (steps, blobs), (jsteps, jblobs) = both(world, scenario)
    assert steps == jsteps and blobs == jblobs
    flat = world["sides"][0].store
    assert blobs[0] == (flat.get_kv("ctx", 0, 0),) * 2


def test_restore_same_context_releases_old_references_like_reference(world):
    def scenario(side):
        ts = stored(world, side, cid="A")
        old = [m.chunk_hash for m in ts.meta("A")]
        ts.store_kv("A", world["kv"], chunk_tokens=CHUNK, tokens=[(t + 7) % 512 for t in toks(world)])
        assert all(ts.refcount(h) == 0 for h in old)
        assert all(ts.refcount(m.chunk_hash) == 1 for m in ts.meta("A"))
        assert ts.unique_storage_bytes() == sum(sum(m.sizes.values()) for m in ts.meta("A"))
        return state(ts)

    got, want = both(world, scenario)
    assert got == want


# ---------------------------------------------------------------------------
# the atomic DirectoryBackend put, and a directory as the cold tier
# ---------------------------------------------------------------------------


def test_directory_put_is_atomic_under_mid_write_kill(world, tmp_path, monkeypatch):
    st = world["sides"][0].st
    be = st.DirectoryBackend(str(tmp_path))
    be.put("c", 0, 1, b"the old committed blob")

    def killed(src, dst):
        raise RuntimeError("writer killed before publish")

    monkeypatch.setattr(st.os, "replace", killed)
    with pytest.raises(RuntimeError, match="killed"):
        be.put("c", 0, 1, b"half-written replacement that never lands")
    with pytest.raises(RuntimeError, match="killed"):
        be.put("fresh", 9, 0, b"never published")
    monkeypatch.undo()
    assert be.get("c", 0, 1) == b"the old committed blob"
    with pytest.raises(KeyError, match="context 'fresh' chunk 9 level 0"):
        be.get("fresh", 9, 0)
    assert not [p for p in os.listdir(str(tmp_path)) if ".tmp." in p]
    be.put("c", 0, 1, b"new blob")
    assert be.get("c", 0, 1) == b"new blob"


def test_directory_cold_tier_holds_the_reference_files(world, tmp_path):
    port, ref = world["sides"]
    ts = stored(world, port, hot_bytes=0, cold=port.st.DirectoryBackend(str(tmp_path / "port")))
    jts = stored(world, ref, hot_bytes=0, cold=ref.st.DirectoryBackend(str(tmp_path / "ref")))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref")) and len(names) == N_CHUNKS * n_levels(world)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes()
    assert ts.get_kv("ctx", 0, 1) == jts.get_kv("ctx", 0, 1) == port.store.get_kv("ctx", 0, 1)
    assert ts.tier_counters() == jts.tier_counters()
    assert ts.n_cold_hits > 0 and ts.n_hot_hits == 0


# ---------------------------------------------------------------------------
# never-evict tiered == flat, through a session and both schedulers
# ---------------------------------------------------------------------------


def tiered_session(world, side, ts, **kw):
    kw.setdefault("rc", W.R_SLOW)
    rc = kw.pop("rc")
    return side.session.ServeSession(side.copy_streamer(ts), side.eng, slo_s=1.0, recompute_s=rc,
                                     decode_bytes_per_s=1e9, **kw)


def test_never_evict_tiered_session_equals_flat_and_reference(world):
    u = world["u"]
    rc = lambda t, p: 0.04 * t / CHUNK  # noqa: E731

    def scenario(side):
        ts = stored(world, side)
        net = lambda: side.network(("steps", (0.2, [2.0 * u, 0.6 * u])))  # noqa: E731
        base = side.serve(rc=rc).run("ctx", world["tokens"], net())
        tier = tiered_session(world, side, ts, rc=rc).run("ctx", world["tokens"], net())
        assert tier.status == "ok" and tier.n_cold_hits == 0 and ts.n_misses == 0
        assert tier.configs == base.configs and tier.ttft_s == base.ttft_s
        assert [t.nbytes for t in tier.timelines] == [t.nbytes for t in base.timelines]
        return tier, base

    (tier, base), (jtier, _) = both(world, scenario)
    W.assert_caches_equal(tier, base)
    W.assert_same(world, tier, jtier)


def test_never_evict_tiered_schedulers_equal_flat_and_reference(world):
    u = world["u"]
    traces = [("constant", (2.0 * u,)), ("steps", (0.2, [1.0 * u, 0.55 * u])),
              ("steps", (0.15, [2.0 * u, 0.4 * u] * 2))]
    rc = lambda t, p: 0.04 * t / CHUNK  # noqa: E731

    def scenario(side):
        ts = stored(world, side)

        def reqs(streamer, arrivals=(0.0, 0.0, 0.0)):
            out = []
            for tr, a in zip(traces, arrivals):
                net = side.network(tr)
                sess = side.session.ServeSession(streamer, side.eng, slo_s=1.0, recompute_s=rc,
                                                 decode_bytes_per_s=1e9)
                out.append(side.sched.SessionRequest(sess, "ctx", world["tokens"], net,
                                                     prior_throughput_gbps=float(net.trace.gbps[0]), start_t=a))
            return out

        flat, tier = side.streamer, side.copy_streamer(ts)
        contention = W.ideal(side)
        base = side.sched.ConcurrentScheduler(side.eng, contention=contention).run(reqs(flat))
        wave = side.sched.ConcurrentScheduler(side.eng, contention=contention).run(reqs(tier))
        arr = (0.0, 0.1, 0.2)
        cbase = side.sched.ContinuousScheduler(side.eng, rows=2, contention=contention).run(reqs(flat, arr))
        cont = side.sched.ContinuousScheduler(side.eng, rows=2, contention=contention).run(reqs(tier, arr))
        assert wave.n_failed == cont.n_failed == 0
        for a, b in zip(wave.sessions + cont.sessions, base.sessions + cbase.sessions):
            assert a.configs == b.configs and a.ttft_s == b.ttft_s
        return wave, cont, base

    (wave, cont, base), (jwave, jcont, _) = both(world, scenario)
    for a, b in zip(wave.sessions, base.sessions):
        W.assert_caches_equal(a, b)
    W.assert_same_scheduled(world, wave, jwave)
    W.assert_same_scheduled(world, cont, jcont)


# ---------------------------------------------------------------------------
# tiering: eviction, demotion, level priorities, the cold-read penalty
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("priorities", [{}, {0: 0.1, 1: 0.5, 2: 0.2}], ids=["lru", "measured"])
def test_eviction_demotes_and_reads_like_reference(world, priorities):
    """Capacity pressure while storing, then every read: the same victims,
    demotions, promotions and LRU order after each step, the same bytes."""
    total = sum(sum(m.sizes.values()) for m in world["metas"])

    def scenario(side):
        ts = stored(world, side, hot_bytes=total // 4, level_priorities=priorities)
        assert ts.n_evictions > 0 and ts.n_demotions == ts.n_evictions
        assert ts._hot_used <= ts.hot_bytes
        steps, blobs = [state(ts)], []
        for ci in range(N_CHUNKS):
            for lvl in range(n_levels(world)):
                blobs.append(ts.get_kv("ctx", ci, lvl))
                steps.append(state(ts))
        c = ts.tier_counters()
        assert c["hot_hits"] + c["cold_hits"] == N_CHUNKS * n_levels(world) and c["misses"] == 0
        assert c["cold_hits"] > 0 and c["promotions"] > 0
        return ts, steps, blobs

    (ts, steps, blobs), (jts, jsteps, jblobs) = both(world, scenario)
    assert steps == jsteps and blobs == jblobs
    assert_same_state(ts, jts)
    flat = world["sides"][0].store
    assert blobs == [flat.get_kv("ctx", ci, lvl) for ci in range(N_CHUNKS) for lvl in range(n_levels(world))]


def test_level_priorities_keep_measured_levels_hot_like_reference(world):
    keep = n_levels(world) - 1
    keep_bytes = sum(m.sizes[keep] for m in world["metas"])
    biggest = max(max(m.sizes.values()) for m in world["metas"])

    def scenario(side):
        ts = stored(world, side, hot_bytes=keep_bytes + biggest, level_priorities={keep: 1.0})
        assert all((m.chunk_hash, keep) in ts._hot_lru for m in ts.meta("ctx"))
        not_hot = sorted((m.chunk_hash, lvl) for m in ts.meta("ctx") for lvl in range(n_levels(world))
                         if (m.chunk_hash, lvl) not in ts._hot_lru)
        assert ts.n_evictions > 0 and not_hot and all(lvl != keep for _, lvl in not_hot)
        by_hash = {m.chunk_hash: m.chunk_idx for m in ts.meta("ctx")}
        return state(ts), [ts.get_kv("ctx", by_hash[h], lvl) for h, lvl in not_hot]

    got, want = both(world, scenario)
    assert got == want


def test_default_level_priorities_come_from_each_packages_report(world, tmp_path, monkeypatch):
    """With no ``level_priorities`` the port reads only its own session
    report: none here, so every level ties at 0.0 (plain LRU), while the
    reference reads its ``BENCH_session.json``.  Pointed at one report,
    both take the same priorities and evict alike."""
    port, ref = world["sides"]
    from repro_torch.streaming import calibration

    monkeypatch.setenv("CACHEGEN_TORCH_BENCH_SESSION", str(tmp_path / "absent.json"))
    calibration.clear_calibration_cache()
    assert tiered(port).level_priorities == {}
    report = tmp_path / "session.json"
    report.write_text('{"host_backend": "cpu", "scenarios": [{"levels": {"0": 3, "1": 1, "-1": 2}}]}')
    monkeypatch.setenv("CACHEGEN_TORCH_BENCH_SESSION", str(report))
    monkeypatch.setenv("CACHEGEN_BENCH_SESSION", str(report))
    total = sum(sum(m.sizes.values()) for m in world["metas"])
    ts, jts = (stored(world, side, hot_bytes=total // 3) for side in (port, ref))
    assert ts.level_priorities == jts.level_priorities == {0: 0.75, 1: 0.25}
    assert_same_state(ts, jts)


def test_tier_penalty_equals_reference(world):
    def scenario(side):
        ts = stored(world, side, hot_bytes=0, cold_latency_s=0.002, cold_gbps=2.0)
        run = [(0, 1), (1, 1), (3, 0)]
        never = stored(world, side)
        return (ts.tier_penalty("ctx", run), ts.tier_penalty("ctx", [(0, -1)]), ts.tier_penalty("nope", run),
                never.tier_penalty("ctx", run))

    got, want = both(world, scenario)
    assert got == want
    extra, n_cold = got[0]
    sizes = world["metas"]
    assert n_cold == 3 and extra == pytest.approx(
        sum(0.002 + sizes[ci].sizes[lvl] * 8 / 2e9 for ci, lvl in [(0, 1), (1, 1), (3, 0)]), abs=1e-12)
    assert got[1:] == ((0.0, 0), (0.0, 0), (0.0, 0))


def test_cold_store_reports_slower_fetch_than_hot_like_reference(world):
    u = world["u"]

    def scenario(side):
        cold = stored(world, side, hot_bytes=0, promote_on_read=False)
        hot = stored(world, side)
        net = lambda: side.network(("constant", (400 * u,)))  # noqa: E731
        hot_res = tiered_session(world, side, hot).run("ctx", world["tokens"], net())
        cold_res = tiered_session(world, side, cold).run("ctx", world["tokens"], net())
        assert cold_res.status == hot_res.status == "ok"
        assert cold_res.ttft_s > hot_res.ttft_s
        assert cold_res.n_cold_hits == len(cold_res.timelines) and hot_res.n_cold_hits == 0
        assert cold.n_cold_hits > 0 and cold.n_hot_hits == 0
        return cold_res, hot_res, cold.tier_counters()

    (cold, hot, c), (jcold, jhot, jc) = both(world, scenario)
    W.assert_caches_equal(cold, hot)
    W.assert_same(world, cold, jcold)
    W.assert_same(world, hot, jhot)
    assert c == jc


# ---------------------------------------------------------------------------
# eviction x faults
# ---------------------------------------------------------------------------


def test_entry_deleted_behind_reader_takes_degrade_ladder_like_reference(world):
    u = world["u"]

    def scenario(side):
        ts = stored(world, side)
        for lvl in range(n_levels(world)):
            assert ts.delete_kv("ctx", 2, lvl) is True
        assert ts.delete_kv("ctx", 2, 0) is False and ts.delete_kv("nope", 0, 0) is False
        res = tiered_session(world, side, ts, retry_policy=side.tr.RetryPolicy(max_attempts=2, backoff_s=0.01)).run(
            "ctx", world["tokens"], side.network(("constant", (400 * u,))))
        assert res.status == "ok" and int(res.caches.length[0]) == T_CTX
        assert res.fault_counts.get("missing", 0) == ts.n_misses > 0
        assert res.n_degrades + res.n_fault_text > 0
        return res, ts.tier_counters()

    (res, c), (jres, jc) = both(world, scenario)
    W.assert_same(world, res, jres)
    assert c == jc


@pytest.mark.parametrize("hot_frac", [0.0, 0.3])
def test_eviction_x_faults_counters_reconcile_like_reference(world, hot_frac):
    """A faulty cold tier (``with_faulty_backend`` of a tiered store)
    under a session: every injected missing read is counted by the faulty
    tier, classified by the session and a tier miss, in both packages."""
    u = world["u"]
    total = sum(sum(m.sizes.values()) for m in world["metas"])

    def scenario(side):
        ts = stored(world, side, hot_bytes=int(hot_frac * total), level_priorities={})
        fstore = side.faults.with_faulty_backend(ts, side.faults.FaultPlan(seed=11, missing_p=0.3))
        assert fstore.cold is fstore.backend and fstore.cold.inner is ts.cold
        net = side.network(("constant", (400 * u,)))
        res = tiered_session(world, side, fstore, retry_policy=side.tr.RetryPolicy(max_attempts=3, backoff_s=0.01)
                             ).run("ctx", world["tokens"], net, transport=side.tr.SimTransport(fstore, net))
        assert res.status == "ok" and int(res.caches.length[0]) == T_CTX
        assert res.fault_counts.get("missing", 0) == fstore.cold.n_missing_reads == fstore.n_misses > 0
        assert fstore.n_cold_hits > 0
        if hot_frac == 0.0:
            assert fstore.n_hot_hits == 0
        # the view shares the index with the clean store, which reads clean
        assert ts.get_kv("ctx", 0, 1) == side.store.get_kv("ctx", 0, 1)
        return res, fstore.tier_counters(), fstore.cold.n_missing_reads

    (res, c, n), (jres, jc, jn) = both(world, scenario)
    W.assert_same(world, res, jres)
    assert c == jc and n == jn


# ---------------------------------------------------------------------------
# random families and interleavings, under fixed seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
def test_random_families_and_interleavings_step_for_step(world, seed):
    """The reference's property test, driven by one fixed-seed operation
    list through both packages: the invariants hold in each, and their
    states are equal after every operation."""
    rng = np.random.default_rng(seed)
    n_contexts = int(rng.integers(2, 5))
    flat_total = world["sides"][0].store.storage_bytes("ctx")
    hot_bytes = int(float(rng.uniform(0.0, 1.2)) * flat_total)
    base = toks(world)
    families = []
    for i in range(n_contexts):
        k = int(rng.integers(0, T_CTX + 1))
        families.append(base[:k] + [int((t + i + 1) % 512) for t in base[k:]])
    ops = []
    for _ in range(int(rng.integers(5, 26))):
        op = ["get", "get", "evict", "delete"][int(rng.integers(4))]
        ops.append((op, int(rng.integers(1 << 30)), int(rng.integers(N_CHUNKS)),
                    int(rng.integers(n_levels(world))), int(rng.integers(1, 4))))

    def scenario(side):
        ts = tiered(side, hot_bytes=hot_bytes, level_priorities={})
        live = {}
        for i, family in enumerate(families):
            live[f"c{i}"] = ts.store_kv(f"c{i}", world["kv"], chunk_tokens=CHUNK, tokens=family)

        def check_invariants():
            uniq, refs = {}, {}
            for metas in live.values():
                for m in metas:
                    refs[m.chunk_hash] = refs.get(m.chunk_hash, 0) + 1
                    for lvl, sz in m.sizes.items():
                        uniq[(m.chunk_hash, lvl)] = sz
            assert ts.unique_storage_bytes() == sum(uniq.values())
            assert all(ts.refcount(h) == n for h, n in refs.items())
            assert ts._hot_used <= max(ts.hot_bytes, 0)

        check_invariants()
        trail = [state(ts)]
        for op, pick, ci, lvl, n in ops:
            if op == "get" and live:
                cid = sorted(live)[pick % len(live)]
                trail.append(ts.get_kv(cid, ci, lvl))
            elif op == "evict":
                trail.append(ts.evict_hot(n))
            elif op == "delete" and len(live) > 1:
                cid = sorted(live)[pick % len(live)]
                assert ts.delete_context(cid) is True
                del live[cid]
                check_invariants()
            trail.append(state(ts))
        trail += [ts.get_kv(cid, ci, lvl) for cid in sorted(live) for ci in range(N_CHUNKS)
                  for lvl in range(n_levels(world))]
        check_invariants()
        for cid in list(live):
            assert ts.delete_context(cid) is True
            del live[cid]
        assert ts.unique_storage_bytes() == 0 and ts._refcount == {} and ts._hash_levels == {}
        assert ts._hot_used == 0 and not ts._hot_lru
        return trail

    got, want = both(world, scenario)
    assert got == want
    flat = world["sides"][0].store
    oracle = {flat.get_kv("ctx", ci, lvl) for ci in range(N_CHUNKS) for lvl in range(n_levels(world))}
    assert all(b in oracle for b in got if isinstance(b, bytes))


# ---------------------------------------------------------------------------
# 2Q probation
# ---------------------------------------------------------------------------


def test_probation_window_validates(world):
    for side in world["sides"]:
        with pytest.raises(ValueError, match="probation"):
            tiered(side, probation=0)


PROBATION = {
    # (store keywords, reads after demoting everything)
    "second-touch": (dict(probation=8), [(0, 1), (0, 1), (0, 1)]),
    "ghosts-expire": (dict(probation=2), [(0, 1), (1, 1), (2, 1), (3, 1), (0, 1), (0, 1)]),
    "off": (dict(), [(0, 1), (0, 1)]),
    "no-room": (dict(hot_bytes=0, probation=4), [(0, 1), (0, 1)]),
}


@pytest.mark.parametrize("case", sorted(PROBATION))
def test_probation_like_reference(world, case):
    kw, reads = PROBATION[case]

    def scenario(side):
        ts = stored(world, side, **kw)
        ts.evict_hot(1000)
        trail = []
        for ci, lvl in reads:
            trail.append(ts.get_kv("ctx", ci, lvl))
            trail.append(ts.tier_counters())
        return trail

    got, want = both(world, scenario)
    assert got == want
    last = got[-1]
    if case == "second-touch":
        assert got[1]["promotions"] == 0 and got[1]["probation_pending"] == 1
        assert got[3]["promotions"] == 1 and got[3]["probation_promotes"] == 1
        assert last["hot_hits"] == 1 and last["cold_hits"] == 2
    elif case == "ghosts-expire":
        assert got[9]["promotions"] == 0 and got[9]["probation_adds"] == 5
        assert got[9]["probation_expired"] == 2
        assert last["promotions"] == 1 and last["probation_promotes"] == 1
    elif case == "off":
        assert got[1]["promotions"] == 1 and last["probation_adds"] == 0
    else:
        assert last["probation_promotes"] == 1 and last["promotions"] == 0 and last["cold_hits"] == 2
