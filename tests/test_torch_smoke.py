"""``chip_smoke.py`` off the card: it refuses to run without one, and its
main path (phases 4-5), store path (phase 6), session path (phase 7),
serving path (phase 8), launcher path (phase 9), MoE path (phase 10),
vlm path (phase 11), ssm and hybrid paths (phase 12) and encdec path
(phase 13) run at a tiny size on the CPU through the kernels' plain
versions (no launch counted)."""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_refuses_without_a_card(capsys, monkeypatch):
    smoke = _load_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""


@pytest.fixture(scope="module")
def rehearsal():
    smoke = _load_smoke()
    cfg = smoke.registry.get("smollm-360m").tiny()
    gen = torch.Generator(device="cpu")
    smoke.ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        served = smoke.drive_main_path(cfg, torch.device("cpu"), gen,
                                       lengths=(40, 37, 30, 20), chunk=20, capacity=64)
    return smoke, cfg, gen, served, out.getvalue()


def test_chip_smoke_main_path_runs_on_cpu_at_tiny_size(rehearsal):
    smoke, _, _, served, out = rehearsal
    assert "serve steps ms" in out and "TEXT chunk K vs exact prefill" in out
    assert served["decode_bytes_per_s"] > 0 and served["prefill_s_per_token"] > 0
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


@pytest.fixture(scope="module")
def stored(rehearsal):
    smoke, cfg, gen, served, _ = rehearsal
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = smoke.drive_store_path(cfg, torch.device("cpu"), gen, served, chunk=20, gen_tokens=8)
    return state, out.getvalue()


def test_chip_smoke_store_path_runs_on_cpu_at_tiny_size(rehearsal, stored):
    """Phase 6 at four 20-token chunks: the stated scenario's plan holds two
    levels and a TEXT chunk whatever the chunks' sizes (the script fails
    otherwise), and both materialize modes agree."""
    smoke = rehearsal[0]
    out = stored[1]
    assert "plan from the stated rates: configs [0, " in out and "-1, -1]" in out
    assert "plan from this device's own rates" in out and "store steps ms" in out
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


@pytest.fixture(scope="module")
def sessioned(rehearsal, stored):
    smoke, cfg = rehearsal[:2]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_session_path(cfg, stored[0], gen_tokens=8)
    return got, out.getvalue()


def test_chip_smoke_session_path_runs_on_cpu_at_tiny_size(rehearsal, sessioned):
    """Phase 7 on phase 6's tiny store: the clean session reproduces the
    plan and its cache, the faulted one recovers through a resumed prefix
    (the script fails otherwise), and the clean cache generates."""
    smoke = rehearsal[0]
    got, out = sessioned
    assert "session (clean): configs [0, " in out and "-1, -1], TTFT" in out and "session realized decode rate" in out
    assert "session (faulted" in out and "session steps ms" in out
    faulted = got["faulted"]
    assert faulted.status == "ok" and faulted.n_retries > 0 and faulted.salvaged_bytes > 0
    assert abs(faulted.salvaged_bytes + faulted.refetched_bytes - faulted.wire_bytes) < 1e-6
    assert got["tokens"].shape == (1, 8)
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_serving_path_runs_on_cpu_at_tiny_size(rehearsal, stored, sessioned):
    """Phase 8 on phase 6's tiny store and phase 7's clean session: the wave
    decides and caches as the session, the continuous loop at t = 0 equals
    the wave, the open loop recycles rows and stacks generation steps, and
    the row primitives round-trip (the script fails otherwise)."""
    smoke, cfg = rehearsal[:2]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_serving_path(cfg, stored[0], sessioned[0], gen_tokens=8)
    out = out.getvalue()
    assert "serving wave: 4 requests, configs [0, " in out and "stacked decode rate" in out
    assert "continuous at t = 0" in out and "open loop generation: 32 tokens" in out
    assert "row primitives: save -> reset -> restore bit-exact" in out and "serving steps ms" in out
    loop = got["open_loop"]
    assert loop.n_rows == 2 and all(tl.n_tokens_out == 8 for tl in loop.timeline)
    assert max(m for _, m in loop.gen_occupancy) == 2 and set(got["step_ms"]) == {1, 2}
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_launcher_path_runs_on_cpu_at_tiny_size():
    """Phase 9 through the launcher at ``.tiny()`` and 256 tokens: the wave
    makes the simulator's decisions and equals ``materialize``, the TCP
    waves on the tiered store survive their injected faults, and the open
    loop preempts, stacks generation steps on both rows and equals
    ``materialize`` (the script fails otherwise); the checks' own decodes
    leave the launch counts alone."""
    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_launcher_path(torch.device("cpu"), ctx_len=256, full_width=False)
    out = out.getvalue()
    assert "launcher A: 4 requests made the simulator's decisions" in out
    assert f"--fault-seed {smoke.LAUNCH_FAULT_SEED}" in out and "[serve] tcp server:" in out
    assert "[generation tokens=64]" in out and "launcher steps ms" in out
    assert got["B"]["tcp_server"]["n_injected_faults"] > 0
    loop = got["C"]["open_loop"]
    assert loop.n_gen_tokens == 64 and loop.n_preemptions > 0
    assert max(n for _, n in loop.gen_occupancy) == 2
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_launcher_fault_seed_keeps_every_chunk_within_its_retries():
    """B's seed truncates chunk 0's first fetch and no chunk more than
    twice in the twelve attempts four requests can make, at the card's
    context and at the rehearsal's."""
    from repro_torch.streaming.storage import split_chunks

    smoke = _load_smoke()
    for ctx in (256, smoke.LAUNCH_CTX):
        n = len(split_chunks(ctx, max(ctx // 4, 50)))
        plan = smoke.FaultPlan(seed=smoke.LAUNCH_FAULT_SEED, truncate_p=smoke.LAUNCH_TRUNCATE_P)
        hits = [[a for a in range(12) if plan.draw("ctx", ci, 1, a)] for ci in range(n)]
        assert hits[0][:1] == [0] and all(len(h) <= smoke.LAUNCH_RETRY - 1 for h in hits)


def test_chip_smoke_moe_path_runs_on_cpu_at_tiny_size():
    """Phase 10 at ``qwen2-moe-a2.7b.tiny()`` (bf16), a 256-token context
    in 64-token chunks: the fused level-0 decode equals the unfused oracle
    and generates its tokens, the lossy run is within K1's rule, a step
    repeats bit for bit and agrees with its plain version, and the
    launcher's waves (as decided, and pinned to level 0 and to a lossy
    level) make the simulator's decisions and equal ``materialize`` with
    their TEXT chunks equal to their batched calls replayed (the script
    fails otherwise); nothing is counted off the card."""
    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    cfg = smoke.registry.get(smoke.MOE_ARCH).tiny()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_moe_path(cfg, torch.device("cpu"), torch.Generator(device="cpu"), ctx_len=256, chunk=64,
                                   gen_tokens=8, launcher_ctx=256, full_width=False)
    out = out.getvalue()
    assert "moe prefill: dropped slots by layer" in out and "moe decode: level 0 bit-equal" in out
    assert "moe greedy: 8 tokens equal" in out and "logits bit-identical run twice" in out
    assert "moe launcher decided: 4 requests made the simulator's decisions" in out and "moe launcher steps ms" in out
    assert len(got["drops"]) == cfg.n_layers
    assert [w["cfg"].family for w in got["launcher"].values()] == ["moe"] * 3
    assert got["launcher"]["level 0"]["kinds"]["level 0"] == 2 * 4
    assert got["launcher"][f"level {smoke.MOE_LOSSY}"]["kinds"]["lossy"] == 2 * 4
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_vlm_path_runs_on_cpu_at_tiny_size():
    """Phase 11 at ``paligemma-3b.tiny()`` (bf16, 8 image rows), a 256-token
    context in 64-row chunks: the fused level-0 decode equals the unfused
    oracle and generates its tokens and the prefill cache's, the lossy run is within K1's rule, a
    step repeats bit for bit and agrees with its plain version, and the
    launcher's waves (as decided, and pinned to a lossy level) make the
    simulator's decisions without a TEXT chunk and equal ``materialize``
    (the script fails otherwise); nothing is counted off the card."""
    from repro_torch.streaming.storage import split_chunks

    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    cfg = smoke.registry.get(smoke.VLM_ARCH).tiny()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_vlm_path(cfg, torch.device("cpu"), torch.Generator(device="cpu"), ctx_len=256, chunk=64,
                                   gen_tokens=8, launcher_ctx=256, full_width=False)
    out = out.getvalue()
    assert "vlm decode: level 0 bit-equal" in out and "vlm greedy: 8 tokens equal from the fused, the oracle and the prefill" in out
    assert "logits bit-identical run twice" in out and "vlm launcher steps ms" in out
    assert "vlm launcher decided: 4 requests made the simulator's decisions" in out
    assert [w["cfg"].family for w in got["launcher"].values()] == ["vlm"] * 2
    n_chunks = len(split_chunks(256 + cfg.n_prefix_tokens, 64))  # the launcher's chunks: max(ctx // 4, 50)
    assert [len(c) for c in got["launcher"]["decided"]["configs"]] == [n_chunks] * 4
    assert got["launcher"][f"level {smoke.VLM_LOSSY}"]["kinds"]["lossy"] == 2 * n_chunks
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_chip_smoke_recurrent_path_runs_on_cpu_at_tiny_size(arch):
    """Phase 12 at ``.tiny()`` (bf16), a 40-token context (2.5 SSD chunks):
    greedy tokens equal in two runs, prefill then a step within the step
    rule of the longer prefill, the chunked SSD scan within its rule of the
    recurrence (ssm), a step that repeats bit for bit and agrees with its
    plain version (hybrid); the script fails otherwise.  Nothing is counted
    off the card."""
    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    cfg = smoke.registry.get(arch).tiny()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_recurrent_path(cfg, torch.device("cpu"), torch.Generator(device="cpu"), ctx_len=40,
                                         gen_tokens=8)
    out = out.getvalue()
    name = "hybrid" if cfg.family == "hybrid" else "ssm"
    assert f"{name} greedy: 8 tokens equal in two runs" in out and f"{name} prefill then step" in out
    assert "logits bit-identical run twice" in out and f"{name} steps ms" in out
    assert ("off the plain step" in out) == (name == "hybrid")
    assert ("ssm SSD at layer 0's shapes" in out) == (name == "ssm")
    assert got["tokens"].shape == (1, 8)
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_encdec_path_runs_on_cpu_at_tiny_size():
    """Phase 13 at ``.tiny()`` (bf16): 2 rows of 40 source frames and a
    24-token prompt, 8 greedy tokens equal in two runs, the kernel path
    against the plain attention and the f32 model, prefill then a step
    within its f32 rule of the longer prefill, ``loss_fn`` against the plain
    path; the script fails otherwise.  Nothing is counted off the card."""
    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    cfg = smoke.registry.get("seamless-m4t-large-v2").tiny()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_encdec_path(cfg, torch.device("cpu"), torch.Generator(device="cpu"), src_len=40,
                                      prompt=24, gen_tokens=8)
    out = out.getvalue()
    assert "encdec greedy: 8 tokens a row equal in two runs" in out
    for line in ("encdec kernels vs plain attention", "encdec memory: kernel path", "encdec cross_v: kernel path",
                 "encdec prefill then step (f32 weights)", "encdec loss_fn:", "encdec on cpu:", "encdec steps ms"):
        assert line in out, line
    assert got["tokens"].shape == (smoke.ENCDEC_BATCH, 8)
    assert set(got["counts"]) == {"prefill", "generate", "loss_fn"}
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}
