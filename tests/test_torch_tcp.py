"""The port's TCP transport (``TcpStoreServer``, ``TcpTransport``) against
the reference's: the TCP cases of ``tests/test_transport.py``,
``test_resume.py``, ``test_faults.py`` and ``test_store.py``, each run
against the port's server and client, on the store of
``tests/_torch_session_world.py`` (the same blobs in both packages).

The two packages speak one protocol: the port packs and parses its frames
with its own msgpack subset, so its frames must be the bytes
``msgpack.packb`` gives, a port client must fetch from a reference server
and a reference client from a port server, and a frame either server
refuses (garbage, a bogus request, bytes after the object) counts as
malformed on both.

Every wait is bounded: results by ``result(timeout=)``, sockets by their
timeouts, so a hang fails a test instead of stalling the run.  Servers are
closed on the way out of every test.
"""
import socket
import struct
import threading
import time

import msgpack
import numpy as np
import pytest
import torch

import _torch_session_world as W

T_CTX, CHUNK = W.T_CTX, W.CHUNK
WAIT = 20.0  # seconds any one fetch may take before the test fails

torch.set_num_threads(1)


def _socket_or_skip():
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        s.close()
    except OSError as e:  # no loopback sockets in this environment
        pytest.skip(f"sockets unavailable: {e}")


@pytest.fixture(scope="module")
def world():
    _socket_or_skip()
    return W.build_world()


def client(side, server, **kw):
    kw.setdefault("connect_timeout_s", 5.0)
    kw.setdefault("io_timeout_s", 10.0)
    return side.tr.TcpTransport.for_server(server, **kw)


def wait_for(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


def tiered(world, side, **kw):
    ts = side.st.TieredKVStore(side.tables, **kw)
    ts.store_kv("ctx", world["kv"], chunk_tokens=CHUNK, tokens=world["tokens"][0].tolist())
    return ts


# ---------------------------------------------------------------------------
# frames: msgpack's bytes, and one protocol across the two packages
# ---------------------------------------------------------------------------


def test_frames_are_msgpack_bytes(world):
    from repro_torch.core import _msgpack
    from repro_torch.core.bitstream import segment_index

    blob = world["sides"][0].store.get_kv("ctx", 0, 1)
    idx = segment_index(blob).to_wire()
    frames = [
        {"cid": "ctx", "chunks": [[0, 1], [1, 2]], "straggle": True, "attempt": 0},
        {"cid": "ctx", "chunks": [[3, 0]], "straggle": False, "attempt": 1,
         "hashes": ["kvh1-" + "ab" * 20], "range": [1000, 0], "want_idx": True},
        {"cid": "é-ctx", "chunks": [[0, 1], [1, 1]], "straggle": True, "attempt": 0,
         "hashes": [None, "kvh1-" + "cd" * 20]},
        {"ok": True, "sizes": [len(blob)], "total": len(blob), "idx": idx},
        {"ok": True, "sizes": [70000, 1 << 33]},
        {"ok": False, "error": "no stored bitstream for context 'ctx' chunk 0 level 99 (memory backend)"},
        {"cid": "x" * 40, "chunks": [[i, i % 5] for i in range(20)], "straggle": True, "attempt": 300,
         "range": [1 << 20, 1 << 17]},
    ]
    for frame in frames:
        packed = _msgpack.packb(frame)
        assert packed == msgpack.packb(frame, use_bin_type=True)
        assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False) == frame


@pytest.mark.parametrize("tail", [b"\x00", b"\xc0", b"junk"])
def test_trailing_bytes_refused_like_msgpack(tail):
    from repro_torch.core import _msgpack

    frame = msgpack.packb({"cid": "ctx", "chunks": [[0, 1]], "straggle": True, "attempt": 0})
    with pytest.raises(msgpack.ExtraData):
        msgpack.unpackb(frame + tail, raw=False)
    with pytest.raises(_msgpack.IntegrityError, match="after its object"):
        _msgpack.unpackb(frame + tail)


class Recorder:
    """A one-shot listener that keeps every byte a client sends."""

    def __init__(self):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.sock.settimeout(10)
        self.address = self.sock.getsockname()[:2]
        self.data = b""
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        conn, _ = self.sock.accept()
        with conn:
            conn.settimeout(2)
            try:
                while True:
                    part = conn.recv(65536)
                    if not part:
                        break
                    self.data += part
            except OSError:
                pass

    def close(self):
        self.sock.close()
        self._thread.join(timeout=10)


@pytest.mark.parametrize("kind", ["plain", "hashes", "range"])
def test_request_bytes_equal_reference_client(world, kind):
    """The port's client and the reference's write the same request bytes
    for the same fetch."""
    sent = []
    for side in world["sides"]:
        rec = Recorder()
        ts = tiered(world, side)
        kw = dict(hash_lookup=ts.try_hash) if kind == "hashes" else {}
        t = side.tr.TcpTransport(*rec.address, connect_timeout_s=5.0, io_timeout_s=1.0, **kw)
        if kind == "range":
            h = t.fetch_run("ctx", [(2, 1)], byte_range=(123, None), resumable=True)
        else:
            h = t.fetch_run("ctx", [(0, 1), (3, 2)])
        with pytest.raises(Exception):
            h.result(timeout=WAIT)  # the recorder never answers
        t.close()
        rec.close()
        sent.append(rec.data)
    assert sent[0] == sent[1] and len(sent[0]) > 4
    (n,) = struct.unpack(">I", sent[0][:4])
    req = msgpack.unpackb(sent[0][4:4 + n], raw=False)
    assert req["cid"] == "ctx" and ("hashes" in req) == (kind == "hashes") and ("range" in req) == (kind == "range")


def _exchange(address, frame):
    """Send one raw request frame, read until the server closes."""
    with socket.create_connection(address, timeout=10) as s:
        s.sendall(struct.pack(">I", len(frame)) + frame)
        s.shutdown(socket.SHUT_WR)
        data = b""
        while True:
            part = s.recv(65536)
            if not part:
                return data
            data += part


@pytest.mark.parametrize("req", [
    {"cid": "ctx", "chunks": [[0, 1], [2, 0]], "straggle": True, "attempt": 0},
    {"cid": "ctx", "chunks": [[1, 2]], "straggle": True, "attempt": 0, "range": [100, 0], "want_idx": True},
    {"cid": "ctx", "chunks": [[4, 3]], "straggle": False, "attempt": 1, "want_idx": True},
    {"cid": "ctx", "chunks": [[0, 99]], "straggle": True, "attempt": 0},
], ids=["run", "range", "index", "missing"])
def test_response_bytes_equal_reference_server(world, req):
    """The same request frame to the port's server and the reference's:
    the same response bytes, header and payload."""
    frame = msgpack.packb(req)
    got = []
    for side in world["sides"]:
        with side.tr.TcpStoreServer(side.store) as server:
            got.append(_exchange(server.address, frame))
    assert got[0] == got[1] and len(got[0]) > 4


@pytest.mark.parametrize("direction", ["port client, reference server", "reference client, port server"])
def test_clients_and_servers_interoperate(world, direction):
    port, ref = world["sides"]
    cli, srv = (port, ref) if direction.startswith("port") else (ref, port)
    with srv.tr.TcpStoreServer(tiered(world, srv)) as server:
        ts = tiered(world, cli)
        t = client(cli, server, hash_lookup=ts.try_hash)
        res = t.fetch_run("ctx", [(0, 1), (2, 2), (4, 0)]).result(timeout=WAIT)
        assert res.blobs == [port.store.get_kv("ctx", ci, lvl) for ci, lvl in [(0, 1), (2, 2), (4, 0)]]
        res = t.fetch_run("ctx", [(1, 1)], byte_range=(500, None), resumable=True).result(timeout=WAIT)
        full = port.store.get_kv("ctx", 1, 1)
        assert res.blobs[0] == full[500:] and res.range_total == len(full)
        assert res.seg_index.verified_prefix(full) == len(full)
        with pytest.raises(KeyError, match="level 99 .hash kvh1-"):  # read by hash key
            t.fetch_run("ctx", [(0, 99)]).result(timeout=WAIT)
        assert server.n_malformed == 0 and server.tier_stats()["hot_hits"] >= 4
        t.close()


MALFORMED = {
    "garbage": struct.pack(">I", 12) + b"\xde\xad\xbe\xef not msgpack",
    "bogus-request": struct.pack(">I", len(msgpack.packb([42]))) + msgpack.packb([42]),
    "trailing-bytes": (lambda f: struct.pack(">I", len(f)) + f)(
        msgpack.packb({"cid": "ctx", "chunks": [[0, 1]], "straggle": True, "attempt": 0}) + b"\x00"),
    "range-over-two-chunks": (lambda f: struct.pack(">I", len(f)) + f)(
        msgpack.packb({"cid": "ctx", "chunks": [[0, 1], [1, 1]], "straggle": True, "attempt": 0,
                       "range": [0, 0]})),
    "hashes-length": (lambda f: struct.pack(">I", len(f)) + f)(
        msgpack.packb({"cid": "ctx", "chunks": [[0, 1]], "straggle": True, "attempt": 0, "hashes": []})),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frames_count_like_reference(world, case):
    """The reference's malformed-frame case, per kind of bad frame: both
    servers count it in ``n_malformed``, keep a reason in ``last_errors``,
    drop no connection, and serve real fetches afterwards."""
    counts = []
    for side in world["sides"]:
        server = side.tr.TcpStoreServer(side.store)
        try:
            s = socket.create_connection(server.address, timeout=5)
            s.sendall(MALFORMED[case])
            s.close()
            assert wait_for(lambda: server.n_malformed >= 1)
            assert server.last_errors and "malformed request frame" in server.last_errors[-1]
            res = client(side, server).fetch_run("ctx", [(0, 1)]).result(timeout=WAIT)
            assert res.blobs[0] == side.store.get_kv("ctx", 0, 1)
            counts.append((server.n_malformed, server.n_dropped_connections, len(server.last_errors)))
        finally:
            server.close()
    assert counts[0] == counts[1] == (1, 0, 1)


# ---------------------------------------------------------------------------
# test_transport.py's tcp cases, on the port
# ---------------------------------------------------------------------------


def test_tcp_roundtrip_and_missing_key(world):
    port = world["sides"][0]
    store = port.store
    with port.tr.TcpStoreServer(store) as server:
        t = client(port, server)
        res = t.fetch_run("ctx", [(0, 1), (1, 1), (2, 0)]).result(timeout=WAIT)
        assert res.blobs == store.get_run("ctx", [(0, 1), (1, 1), (2, 0)])
        assert res.nbytes == sum(len(b) for b in res.blobs)
        assert res.end_t > res.start_t and res.throughput_gbps > 0
        assert not res.hedge_issued and res.duplicate_bytes == 0.0
        with pytest.raises(KeyError, match="chunk 0 level 99"):
            t.fetch_run("ctx", [(0, 99)]).result(timeout=WAIT)
        t.close()


def test_tcp_session_runs_end_to_end(world):
    """A full adaptive session over the port's socket transport: throughput
    is measured off the wire and the cache materializes completely; pinned
    to one level, it equals the unfused ``materialize`` of that level."""
    port = world["sides"][0]
    level1 = sum(m.sizes[1] for m in world["metas"])
    pace = level1 * 8 / 1e9 / 0.25  # the level-1 context in ~250 ms
    with port.tr.TcpStoreServer(port.store, pace_gbps=pace) as server:
        net = port.net.NetworkModel(port.net.BandwidthTrace.constant(pace))
        res = port.serve(slo_s=5.0, allow_text=False, transport=client(port, server)).run(
            "ctx", world["tokens"], net, prior_throughput_gbps=pace)
        assert int(res.caches.length[0]) == T_CTX and all(c >= 0 for c in res.configs)
        assert res.ttft_s > 0.1
        pinned = port.serve(slo_s=5.0, allow_text=False, fixed_level=1, transport=client(port, server)).run(
            "ctx", world["tokens"], port.net.NetworkModel(port.net.BandwidthTrace.constant(pace)),
            prior_throughput_gbps=pace)
    plan = port.streamer.stream("ctx", port.net.NetworkModel(port.net.BandwidthTrace.constant(pace)), slo_s=5.0,
                                decode_bytes_per_s=1e9, recompute_s=W.R_SLOW, fixed_level=1,
                                prior_throughput_gbps=pace)
    ref = port.streamer.materialize(plan, port.eng, world["tokens"], batch=1, fused=False)
    assert pinned.configs == [1] * len(world["metas"])
    np.testing.assert_allclose(pinned.caches.kv_k[:, :, :T_CTX].numpy(), ref.kv_k[:, :, :T_CTX].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_tcp_hedge_cancels_loser_mid_stream(world):
    """Stalled primary (keyed injection, attempt 0 only) on a paced link:
    the hedge wins, the loser's socket is closed mid-stream, and the
    duplicate bytes stay bounded by the payload."""
    port = world["sides"][0]
    store = port.store
    nb = store.meta("ctx")[0].sizes[0]
    pace = nb * 8 / 1e9 / 0.3  # ~300 ms paced transfer
    with port.tr.TcpStoreServer(store, pace_gbps=pace, straggler_p=1.0, straggler_scale_s=1.0,
                                straggler_alpha=50.0, seed=3) as server:
        t = client(port, server)
        t0 = time.perf_counter()
        res = t.fetch_run("ctx", [(0, 0)], hedge_after_s=0.05).result(timeout=WAIT)
        wall = time.perf_counter() - t0
        assert res.hedged and res.winner == "hedge" and res.hedge_issued and res.loser_cancelled
        assert res.blobs[0] == store.get_kv("ctx", 0, 0)
        assert 0 <= res.duplicate_bytes <= res.nbytes and res.loser_bytes_read == res.duplicate_bytes
        assert wall < 1.0, wall
        t0 = time.perf_counter()
        t.fetch_run("ctx", [(0, 0)]).result(timeout=WAIT)
        assert time.perf_counter() - t0 > 1.0
        t.close()


# ---------------------------------------------------------------------------
# test_resume.py's tcp cases, on the port
# ---------------------------------------------------------------------------


def test_tcp_range_fetch_pooling_and_reconnect(world):
    port = world["sides"][0]
    store = port.store
    full = store.get_kv("ctx", 0, 1)
    with port.tr.TcpStoreServer(store) as server:
        t = client(port, server)
        off = 1000
        res = t.fetch_run("ctx", [(0, 1)], byte_range=(off, None), resumable=True).result(timeout=WAIT)
        assert res.blobs[0] == full[off:]
        assert res.range_offset == off and res.range_total == len(full)
        assert res.seg_index is not None and res.seg_index.verified_prefix(full) == len(full)
        t.fetch_run("ctx", [(1, 1)]).result(timeout=WAIT)
        s = t.tier_stats()
        assert s["n_connects"] == 1 and s["n_pool_reuses"] >= 1
        with t._pool_lock:
            for sock in t._pool:
                sock.close()
        res = t.fetch_run("ctx", [(2, 1)]).result(timeout=WAIT)
        assert res.blobs[0] == store.get_kv("ctx", 2, 1)
        assert t.tier_stats()["n_reconnects"] >= 1
        t.close()


def test_tcp_server_truncate_salvages_client_side(world):
    port = world["sides"][0]
    store = port.store
    full = store.get_kv("ctx", 0, 1)
    with port.tr.TcpStoreServer(store, fault_plan=port.faults.FaultPlan(seed=9, truncate_p=1.0)) as server:
        h = client(port, server).fetch_run("ctx", [(0, 1)], resumable=True)
        with pytest.raises((port.tr.FetchError, ConnectionError, OSError)):
            h.result(timeout=WAIT)
        salv = h.salvage_at()
        assert salv is not None and 0 < len(salv.data) < len(full)
        assert salv.data == full[: len(salv.data)]
        assert salv.index is not None and salv.index.verified_prefix(salv.data, salv.offset) > 0
        assert server.n_injected_faults >= 1
        # the truncation point is the reference plan's: the same byte count
        frac = port.faults.FaultPlan(seed=9, truncate_p=1.0).truncate_fraction("ctx", 0, 1, 0)
        assert len(salv.data) == max(1, int(len(full) * frac))


def test_server_side_faults_draw_like_reference(world):
    """The same fault plan on both servers, the same sequence of fetches
    (each until it succeeds): the same injected faults, attempt by
    attempt, and the same outcome of each attempt."""
    plan = dict(seed=4, drop_p=0.3, corrupt_p=0.2, truncate_p=0.2)
    logs = []
    for side in world["sides"]:
        log = []
        with side.tr.TcpStoreServer(side.store, fault_plan=side.faults.FaultPlan(**plan)) as server:
            t = client(side, server)
            for ci, lvl in [(0, 1), (1, 1), (2, 0), (3, 2), (4, 1)]:
                for _ in range(8):
                    try:
                        res = t.fetch_run("ctx", [(ci, lvl)]).result(timeout=WAIT)
                    except (side.tr.FetchError, ConnectionError, OSError) as e:
                        log.append((ci, lvl, "sever", type(e).__name__))
                        continue
                    ok = res.blobs[0] == side.store.get_kv("ctx", ci, lvl)
                    log.append((ci, lvl, "intact" if ok else "corrupt"))
                    if ok:
                        break
            t.close()
            assert wait_for(lambda: not server._live_conns)
            log.append(("injected", server.n_injected_faults))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][-1][1] > 0 and any(e[2] == "corrupt" for e in logs[0][:-1])


# ---------------------------------------------------------------------------
# test_faults.py's tcp cases, on the port
# ---------------------------------------------------------------------------


def test_tcp_server_faults_are_survivable_with_retry(world):
    port = world["sides"][0]
    plan = port.faults.FaultPlan(seed=2, drop_p=0.25, corrupt_p=0.15, stall_p=0.05, stall_scale_s=0.05,
                                 wall_cap_s=0.2)
    with port.tr.TcpStoreServer(port.store, pace_gbps=0.5, fault_plan=plan) as server:
        trace = port.net.BandwidthTrace.constant(2.0 * world["u"])
        res = port.serve(retry_policy=port.tr.RetryPolicy(max_attempts=4, backoff_s=0.01, degrade=True)).run(
            "ctx", world["tokens"], port.net.NetworkModel(trace), transport=client(port, server))
        assert res.status == "ok" and int(res.caches.length[0]) == T_CTX
        assert server.n_injected_faults > 0 and server.n_connections > 0
        assert res.n_failed_attempts > 0 and res.n_retries > 0


# ---------------------------------------------------------------------------
# test_store.py's tcp cases, on the port
# ---------------------------------------------------------------------------


def test_tcp_hash_keyed_fetch_and_tier_stats(world):
    port = world["sides"][0]
    ts = tiered(world, port)
    with port.tr.TcpStoreServer(ts) as server:
        run = [(0, 1), (2, 2), (4, 0)]
        want = [port.store.get_kv("ctx", ci, lvl) for ci, lvl in run]
        hits0 = ts.n_hot_hits
        t_hash = client(port, server, hash_lookup=ts.try_hash)
        assert t_hash._hashes_for("ctx", run) == [ts.hash_for("ctx", ci) for ci, _ in run]
        assert t_hash.fetch_run("ctx", run).result(timeout=WAIT).blobs == want
        assert ts.n_hot_hits == hits0 + len(run)
        t_plain = client(port, server)
        assert t_plain._hashes_for("ctx", run) is None
        assert t_plain.fetch_run("ctx", run).result(timeout=WAIT).blobs == want
        assert client(port, server, hash_lookup=lambda cid, ci: None)._hashes_for("ctx", run) is None
        assert client(port, server, hash_lookup=lambda cid, ci: 1 / 0)._hashes_for("ctx", run) is None
        stats = server.tier_stats()
        assert stats["hot_hits"] >= 2 * len(run) and stats["misses"] == 0
        assert stats["unique_bytes"] == ts.unique_storage_bytes()
        # a hash-keyed read reaches a blob another context shares
        ts.store_kv("other", world["kv"], chunk_tokens=CHUNK, tokens=world["tokens"][0].tolist())
        res = t_hash.fetch_run("other", [(1, 1)]).result(timeout=WAIT)
        assert res.blobs[0] == port.store.get_kv("ctx", 1, 1) and ts.n_dedup_chunks == T_CTX // CHUNK
        for t in (t_hash, t_plain):
            t.close()


def test_tcp_flat_store_has_no_tier_stats(world):
    port = world["sides"][0]
    with port.tr.TcpStoreServer(port.store) as server:
        assert server.tier_stats() == {}


def test_fetch_after_server_close_is_served_like_reference(world):
    """``TcpStoreServer.close()`` closes its sockets from another thread,
    and a thread blocked in ``accept``/``recv`` keeps its socket alive, so
    a closed server still serves: a pooled client socket is found stale,
    the client redials once, and the redial is accepted and answered.
    Both packages behave so (a fault of the reference, carried by
    parity)."""
    outcomes = []
    for side in world["sides"]:
        server = side.tr.TcpStoreServer(side.store)
        try:
            t = client(side, server, io_timeout_s=2.0)
            t.fetch_run("ctx", [(0, 1)]).result(timeout=WAIT)
            assert len(t._pool) == 1
        finally:
            server.close()
        res = t.fetch_run("ctx", [(0, 1)]).result(timeout=WAIT)
        assert res.blobs[0] == side.store.get_kv("ctx", 0, 1)
        outcomes.append(t.tier_stats())
        t.close()
    assert outcomes[0] == outcomes[1] == {"n_connects": 2, "n_reconnects": 1, "n_pool_reuses": 1}
