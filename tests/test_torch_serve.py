"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), in process, on ``smollm-360m.tiny()``.

Both launchers run the same flags.  The reference's ``main()`` runs with
``sys.argv`` patched and its output captured; the port's ``run()`` returns
the lines it printed.  To give both the same inputs:

* both registries serve the f32 variant of the tiny config, and the port
  gets the reference's own weight draw (``PRNGKey(0)``, converted);
* the port's engine returns the reference's prefill of the context (the
  port's own prefill is held within 1e-4 of it first: the engine tests'
  rule), so both profile and store the same KV and their blobs are byte
  for byte the same;
* both packages' calibration variables point at one codec report and one
  session report in ``tmp_path``, so both take the same contention factors
  and the same level priorities (by default each reads its own reports,
  and the port has none yet).

On the sim transport every printed line must then be equal once the
wall-clock fields are masked.  Over ``local`` and ``tcp`` the links are
real, so only what does not depend on wall time is compared: configs,
tokens and the tier and fault counters.
"""
import contextlib
import io
import re
import socket
import sys

import pytest
import torch

from repro.launch import serve as jserve

from repro_torch.launch import serve

from _torch_serve_world import (
    CTX,
    SIM_CASES,
    both,
    make_assets,
    make_world,
    mask,
    run_port,
    run_reference,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp("serve"))


@pytest.fixture
def world(assets, monkeypatch):
    """Both launchers on the same inputs (see the module docstring)."""
    return make_world(assets, monkeypatch)


# ---------------------------------------------------------------------------
# the sim transport: every line equal, wall-clock fields masked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_lines_equal_reference(world, case):
    argv = [*CTX, *SIM_CASES[case]]
    got, ref = both(world, argv)
    assert mask(got["lines"]) == mask(ref)
    assert world["checked"] and world["checked"][-1] == (1, 128)
    n = int(argv[argv.index("--requests") + 1])
    assert len(got["sessions"]) == n
    if "--check-sim" in argv:
        assert got["sim_match"] == {r: True for r in range(n)}
    if "--fixed-level" in argv:
        # a codec level was decoded, not recomputed
        assert all(s.n_runs > 0 for s in got["sessions"])


def test_tiered_run_returns_counters(world):
    """The tiered case's data: the store evicted, demoted and read cold,
    and the retries resumed truncated fetches."""
    got = run_port(world, [*CTX, *SIM_CASES["tiered-faults-retry"]])
    c = got["tier_counters"]
    assert c["evictions"] > 0 and c["demotions"] > 0 and c["cold_hits"] > 0
    assert c["hot_used_bytes"] <= 60000
    assert sum(s.n_retries for s in got["sessions"]) > 0
    assert sum(s.n_resumes for s in got["sessions"]) > 0
    assert got["tcp_server"] is None and got["tcp_client"] is None


def test_open_loop_preempts_and_resumes(world):
    got = run_port(world, [*CTX, *SIM_CASES["open-loop-preempting"]])
    loop = got["open_loop"]
    assert loop.n_preemptions > 0 and loop.n_resumes == loop.n_preemptions
    assert loop.n_failed == 0 and loop.n_gen_tokens == 4 * 4


def test_missing_cold_entries_reach_the_session(world):
    """``--fault-missing`` on a tiered store wraps its cold tier: with
    nothing hot, every injected missing read reaches the session as a
    tier miss, and a level pinned by ``--fixed-level`` has nowhere to
    degrade (as in the reference's lines)."""
    got = run_port(world, [*CTX, *SIM_CASES["tiered-cold-missing"]])
    missing = sum(s.fault_counts.get("missing", 0) for s in got["sessions"])
    assert missing > 0 and got["tier_counters"]["misses"] == missing
    assert got["tier_counters"]["hot_hits"] == 0
    for s in got["sessions"]:
        assert s.failed and s.failure.startswith("exhausted") and s.n_degrades == 1


def _evicted_as_it_took_its_row(loop):
    """(request, instant) pairs where a load was evicted at the very
    instant it had taken its row by evicting another."""
    out = []
    for tl in loop.timeline:
        others = {t for o in loop.timeline if o is not tl for t in o.preempt_ts}
        out += [(tl.index, t) for t in tl.preempt_ts if t in others and t in (tl.admit_t, *tl.resume_ts)]
    return out


RUNAWAY = {
    "one-row": ["--requests", "4", "--arrivals", "poisson:200", "--rows", "1", "--slo-ms", "30"],
    "two-rows": ["--requests", "6", "--arrivals", "poisson:1000", "--rows", "2", "--slo-ms", "20"],
}


@pytest.mark.parametrize("case", sorted(RUNAWAY))
def test_preemption_runaway_ends_like_reference(world, monkeypatch, case):
    """Generation and preemption under a tight SLO.  The reference's
    continuous scheduler lets two doomed loads evict each other at one
    virtual instant until its runaway guard raises.  The port does not: a
    load that took its row by preemption is not evictable at that instant
    (a deliberate divergence), so its run ends with every request served
    after a bounded number of preemptions.  Both guards are lowered from
    100,000 to 200 preemptions, so the reference's run ends in seconds and
    a runaway in the port would raise too."""
    from repro.serving.scheduler import ContinuousScheduler as JContinuousScheduler
    from repro_torch.serving.scheduler import ContinuousScheduler

    for cls in (JContinuousScheduler, ContinuousScheduler):
        monkeypatch.setattr(cls, "MAX_PREEMPTIONS", 200)
    argv = [*CTX, *RUNAWAY[case], "--generate", "4", "--preempt", "--fixed-level", "1"]
    with pytest.raises(RuntimeError, match="preemption runaway: 201 preemptions"):
        run_reference(argv)
    loop = run_port(world, argv)["open_loop"]
    n = len(loop.timeline)
    assert loop.n_failed == 0 and 0 < loop.n_preemptions <= n
    assert loop.n_resumes == loop.n_preemptions
    assert [tl.n_tokens_out for tl in loop.timeline] == [4] * n
    assert _evicted_as_it_took_its_row(loop) == []


def test_preemption_keeps_a_load_at_the_instant_it_took_its_row(world):
    """A chain of evictions that ends in both packages: the reference
    evicts a load at the instant it took its row by preemption (three
    preemptions); the port keeps that load (two), and both serve every
    request."""
    argv = [*CTX, "--requests", "4", "--arrivals", "poisson:200", "--rows", "1", "--slo-ms", "10",
            "--generate", "4", "--preempt", "--fixed-level", "0"]
    got, ref = both(world, argv)
    loop = got["open_loop"]
    assert "preemptions=3 resumes=3" in _line(ref, "[open-loop rows=1]")
    assert "failed=0" in _line(ref, "[open-loop rows=1]")
    assert (loop.n_preemptions, loop.n_resumes, loop.n_failed) == (2, 2, 0)
    assert _evicted_as_it_took_its_row(loop) == []
    assert [tl.n_tokens_out for tl in loop.timeline] == [4] * 4
    assert _requests(got["lines"]) == _requests(ref)


def test_open_loop_returns_scheduler_result(world):
    got = run_port(world, [*CTX, *SIM_CASES["open-loop-generate-preempt"]])
    loop = got["open_loop"]
    assert loop.n_rows == 2 and loop.n_failed == 0
    assert loop.n_gen_tokens == 4 * 4
    assert max(n for _, n in loop.occupancy) == 2
    assert [tl.n_tokens_out for tl in loop.timeline] == [4] * 4


# ---------------------------------------------------------------------------
# local and tcp: real links, so what does not depend on wall time
# ---------------------------------------------------------------------------


def _socket_or_skip():
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.bind(("127.0.0.1", 0))
        s.close()
    except OSError as e:  # no loopback sockets in this environment
        pytest.skip(f"sockets unavailable: {e}")


REQ = re.compile(r"^\[req (\d+)\] configs=(\[[^\]]*\]) .*tokens=(\[[^\]]*\])")


def _requests(lines):
    return [REQ.match(line).groups() for line in lines if REQ.match(line)]


def _line(lines, prefix):
    hits = [line for line in lines if line.startswith(prefix)]
    assert len(hits) == 1, (prefix, lines)
    return hits[0]


def _fields(line, names):
    return {n: re.search(rf"\b{n}=(\S+)", line).group(1) for n in names}


def test_local_transport_matches_reference(world):
    argv = [*CTX, "--requests", "2", "--transport", "local", "--fixed-level", "1"]
    got, ref = both(world, argv)
    assert _requests(got["lines"]) == _requests(ref)
    assert len(_requests(ref)) == 2
    assert got["lines"][0] == ref[0]  # the stored context's size


def test_tcp_tiered_faults_match_reference(world):
    """Over a real socket, on the tiered store with server-side truncation
    faults and retries: the same configs and tokens, the same tier
    counters (the same reads in the same order), the same injected faults
    and the same client connection counts."""
    _socket_or_skip()
    argv = [*CTX, "--requests", "2", "--transport", "tcp", "--tcp-pace-gbps", "2",
            "--store", "tiered", "--hot-bytes", "60000", "--store-dir",
            str(world["tmp"] / "cold-port"), "--fault-truncate", "0.5", "--fault-seed", "3",
            "--retry", "3", "--fixed-level", "1"]
    got = run_port(world, argv)
    ref = run_reference([a if a != str(world["tmp"] / "cold-port") else str(world["tmp"] / "cold-ref")
                         for a in argv])
    assert _requests(got["lines"]) == _requests(ref)
    tier = ["hot_hits", "cold_hits", "misses", "demotions", "evictions", "dedup_chunks", "hot", "unique"]
    assert _fields(_line(got["lines"], "[serve] tiered store:"), tier) == \
        _fields(_line(ref, "[serve] tiered store:"), tier)
    server = ["conns", "dropped", "malformed", "injected"]
    assert _fields(_line(got["lines"], "[serve] tcp server:"), server) == \
        _fields(_line(ref, "[serve] tcp server:"), server)
    client = ["connects", "reconnects", "pool_reuses"]
    assert _fields(_line(got["lines"], "[serve] tcp client:"), client) == \
        _fields(_line(ref, "[serve] tcp client:"), client)
    # the returned data says what the lines say
    assert got["tcp_server"]["n_injected_faults"] > 0
    assert got["tcp_server"]["n_injected_faults"] == int(_fields(_line(ref, "[serve] tcp server:"),
                                                                ["injected"])["injected"])
    assert got["tcp_client"]["n_connects"] >= 1
    assert got["tier_counters"]["cold_hits"] > 0
    assert (world["tmp"] / "cold-port").is_dir() and any((world["tmp"] / "cold-port").iterdir())


# ---------------------------------------------------------------------------
# flags: the reference's checks and the port's own
# ---------------------------------------------------------------------------


BAD_FLAGS = {
    "concurrency-0": ["--concurrency", "0"],
    "generate-negative": ["--generate", "-1"],
    "generate-without-arrivals": ["--generate", "2"],
}


@pytest.mark.parametrize("case", sorted(BAD_FLAGS))
def test_flag_errors_match_reference(case):
    argv = BAD_FLAGS[case]
    with pytest.raises(SystemExit) as mine:
        serve.run([*argv, "--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        run_reference(argv)
    assert str(mine.value) == str(theirs.value) and str(mine.value)


@pytest.mark.parametrize("spec", ["poisson:x", "poisson:0", "poisson:nan", "uniform:3", "trace:short",
                                  "trace:descending", "poisson:2.5", "trace:ok"])
def test_parse_arrivals_matches_reference(spec, tmp_path):
    (tmp_path / "short").write_text("0.1\n")
    (tmp_path / "descending").write_text("0.1\n0.3\n0.2\n")
    (tmp_path / "ok").write_text("0\n\n0.25\n0.5\n0.75\n")
    kind, _, val = spec.partition(":")
    if kind == "trace":
        spec = f"trace:{tmp_path / val}"
    try:
        want = jserve._parse_arrivals(spec, 3, 7)
    except SystemExit as e:
        with pytest.raises(SystemExit) as mine:
            serve._parse_arrivals(spec, 3, 7)
        assert str(mine.value) == str(e)
        return
    assert serve._parse_arrivals(spec, 3, 7) == want and len(want) == 3


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_non_attention_family_exits_like_reference(arch):
    """The port's model runs both families, its launcher (CacheGen's
    KV-cache streaming) serves neither, with the reference's message."""
    argv = ["--arch", arch]
    with pytest.raises(SystemExit) as mine:
        serve.run([*argv, "--device", "cpu", "--full-width"])
    with pytest.raises(SystemExit) as theirs:
        run_reference(argv)
    assert str(mine.value) == str(theirs.value)


def test_no_device_flag_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run([*CTX, "--requests", "1"])


def test_parser_has_every_reference_flag_and_two_more(capsys):
    mine = {a.dest for a in serve.build_parser()._actions}
    with pytest.raises(SystemExit):
        sys.argv, saved = ["serve", "--help"], sys.argv
        try:
            jserve.main()
        finally:
            sys.argv = saved
    flags = set(re.findall(r"--([a-z][a-z-]+)", capsys.readouterr().out))
    theirs = {f.replace("-", "_") for f in flags}
    assert theirs - {"help"} <= mine
    assert mine - theirs == {"device", "full_width"}
    help_text = serve.build_parser().format_help()
    assert "reference launcher always serves .tiny()" in " ".join(help_text.split())


def test_port_cli_alone_on_cpu_matches_its_simulator():
    """The port's own command line at its own weights (bf16, a torch
    draw): both requests make the simulator's decisions."""
    with contextlib.redirect_stdout(io.StringIO()):
        got = serve.run([*CTX, "--requests", "2", "--check-sim", "--device", "cpu"])
    assert got["sim_match"] == {0: True, 1: True}
    assert all("sim_match=True" in line for line in got["lines"] if line.startswith("[req"))
    assert got["engine"].params["embed"].dtype == torch.bfloat16
