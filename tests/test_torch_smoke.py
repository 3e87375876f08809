"""``chip_smoke.py`` off the card: it refuses to run without one, and its
main path (phases 4-5), store path (phase 6), session path (phase 7),
serving path (phase 8), launcher path (phase 9), mesh path (phase 15),
MoE path (phase 10),
vlm path (phase 11), ssm and hybrid paths (phase 12), encdec path
(phase 13), training (phase 14) and distributed path (phase 16, on spawned
CPU ranks) run at a tiny size on the CPU through the kernels' plain
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


def test_chip_smoke_wide_codec_path_runs_on_cpu_at_tiny_size(rehearsal):
    """Phase 19 at 40 tokens: the codec at delta_qmax 1023 profiles
    2,047-symbol delta tables, its blobs equal the CPU route's (here the
    same route), level 0 decodes bit for bit and a lossy level within K1's
    rule of ``decode_chunk``."""
    smoke, cfg, gen, served, _ = rehearsal
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        smoke.drive_wide_codec_path(cfg, torch.device("cpu"), gen, served, ctx_len=40, gen_tokens=4)
    out = out.getvalue()
    assert "delta alphabet 2047" in out and "decode_chunks at level 2" in out and "wide codec steps ms" in out
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_shapes_path_runs_on_cpu_at_tiny_size():
    """Phase 20 at tiny widths (the heads kept: MHA 32 x 96, 71:1 x 64 and
    GQA 8:2 x 512): every K3/K4 call held to its plain version (here the
    plain version itself), the logits against the plain attention."""
    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        smoke.drive_shapes_path(torch.device("cpu"), torch.Generator(device="cpu"), prompt=24, steps=3, tiny=True)
    out = out.getvalue()
    assert "shapes Phi-3-mini MHA 32 x 96: 2 layers" in out and "71/1 heads x 64" in out
    assert "8/2 heads x 512" in out
    assert out.count("held calls") == 3
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_paths_cover_the_wide_kernels_apart():
    """The wide rANS kernels run on the wide codec path alone: the staged
    paths' lists leave them out, and the lists cover every kernel."""
    smoke = _load_smoke()
    assert set(smoke.WIDE_KERNELS) == {n for n in smoke.ops.KERNELS if n.endswith("_wide")}
    assert not set(smoke.ALL_KERNELS) & set(smoke.WIDE_KERNELS)
    assert set(smoke.WIDE_KERNELS) <= set(smoke.WIDE_CODEC_KERNELS)
    assert set(smoke.ALL_KERNELS) | set(smoke.WIDE_CODEC_KERNELS) == set(smoke.ops.KERNELS)


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


@pytest.fixture(scope="module")
def served_rows(rehearsal, stored, sessioned):
    smoke, cfg = rehearsal[:2]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_serving_path(cfg, stored[0], sessioned[0], gen_tokens=8)
    return got, out.getvalue()


def test_chip_smoke_serving_path_runs_on_cpu_at_tiny_size(rehearsal, served_rows):
    """Phase 8 on phase 6's tiny store and phase 7's clean session: the wave
    decides and caches as the session, the continuous loop at t = 0 equals
    the wave, the open loop recycles rows and stacks generation steps, and
    the row primitives round-trip (the script fails otherwise)."""
    smoke = rehearsal[0]
    got, out = served_rows
    assert "serving wave: 4 requests, configs [0, " in out and "stacked decode rate" in out
    assert "continuous at t = 0" in out and "open loop generation: 32 tokens" in out
    assert "row primitives: save -> reset -> restore bit-exact" in out and "serving steps ms" in out
    loop = got["open_loop"]
    assert loop.n_rows == 2 and all(tl.n_tokens_out == 8 for tl in loop.timeline)
    assert max(m for _, m in loop.gen_occupancy) == 2 and set(got["step_ms"]) == {1, 2}
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_mesh_path_runs_on_cpu_at_tiny_size(rehearsal, stored, served_rows):
    """Phase 15 on phases 6-8's tiny state: one shard reproduces phase 8 bit
    for bit, two shards make its decisions and hold each row primitive to
    the plain Engine on a shard's rows, and the baselines agree with
    themselves on the CPU (the script fails otherwise)."""
    smoke, cfg = rehearsal[:2]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_mesh_path(cfg, stored[0], served_rows[0], gen_tokens=8, card="a card, 1 W")
    out = out.getvalue()
    assert "mesh A (1 shard): the wave's and the open loop's decisions" in out
    assert "mesh B (2 shards on one card): decisions and TTFTs equal A's" in out
    assert "mesh B row primitives:" in out and "mesh steps ms" in out
    assert "baseline uniform 8-bit quantization" in out and "baseline uniform 4-bit quantization" in out
    assert "h2o_select(0.5) keeps 20, 0 indices apart" in out and "a card, 1 W" in out
    wave2, loop2 = got["two"]
    assert len(wave2.caches.shards) == 2 and loop2.n_gen_tokens == 32 and set(got["step_ms"]) == {1, 2}
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


def test_chip_smoke_train_path_runs_on_cpu_at_tiny_size():
    """Phase 14 A at ``.tiny()`` with remat "full" (bf16, 8 x 64 tokens, 6
    steps checkpointed every 3, lr 3e-3 so that six steps learn): the loss falls, the trainer resumed from
    step 3 gives the first run's losses and state bit for bit, the kernel
    path against the plain attention and the f32 grads; the script fails
    otherwise.  Nothing is counted off the card."""
    import dataclasses

    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    cfg = dataclasses.replace(smoke.registry.get(smoke.TRAIN_ARCH).tiny(), remat=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_train_path(cfg, torch.device("cpu"), batch=8, seq=64, steps=6, ckpt_every=3,
                                     opt=dict(lr=3e-3, warmup_steps=2))
    out = out.getvalue()
    for line in ("train: smollm-360m-tiny (remat full)", "train losses:", "train resume: the state restored from "
                 "step 3 equals the saved one bit for bit", "train held step:", "train kernel path vs plain attention",
                 "train AdamW step on the card against the CPU's", "train on cpu:", "train steps ms"):
        assert line in out, line
    assert got["history"]["step"] == [1, 2, 3, 4, 5, 6]
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_train_sweep_and_launcher_run_on_cpu():
    """Phase 14 B over every registry arch's ``.tiny()`` and C's launcher
    (a subprocess, twice: trains, then resumes from step 20; it prints its
    launches, none off the card)."""
    smoke = _load_smoke()
    smoke.ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        swept = smoke.drive_train_sweep(torch.device("cpu"))
        launched = smoke.drive_train_launcher(torch.device("cpu"))
    lines = launched["lines"]
    assert launched["launches"] == {name: 0 for name in smoke.ops.KERNELS}
    assert set(swept) == set(smoke.registry.names())
    assert lines[0][-1].startswith("[launch.train] smollm-360m-tiny: loss ")
    assert lines[1][0] == "[trainer] resumed from step 20"
    assert smoke.k4_calls_a_step(smoke.registry.get("zamba2-2.7b").tiny()) == 2
    assert smoke.k4_calls_a_step(smoke.registry.get("smollm-360m")) == 64
    assert smoke.k4_calls_a_step(smoke.registry.get("mamba2-370m").tiny()) == 0
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}


def test_chip_smoke_distributed_path_runs_on_cpu_at_tiny_size(monkeypatch):
    """Phase 16 at ``.tiny()`` on CPU ranks (gloo): A one rank, B-D one
    group of two (the S-split decode cache of 64 slots, row 1 in the first
    shard, in bf16 and f32; the grouped MoE; ``compressed_psum``), E four
    ranks' train steps, each held to the single-process references (step
    1's moments and update too, the rule rejecting its planted faults, and
    in f32); one JSON line a sub-phase, nothing counted off the card."""
    import json
    import sys

    smoke = _load_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # the ranks import the rank functions by name
    monkeypatch.syspath_prepend(str(ROOT))
    smoke.ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = smoke.drive_distributed_path(torch.device("cpu"), tiny=True, lengths=(40, 9), cap=64, steps=3,
                                           moe_tokens=(2, 32), psum_tokens=(2, 16), train_batch=4, train_seq=32)
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith('{"phase": "16')]
    assert [x["phase"] for x in lines] == ["16 A", "16 B", "16 B f32", "16 C", "16 D", "16 E", "16 E f32"]
    assert [x["ranks"] for x in lines] == [1, 2, 2, 2, 2, 4, 4]
    assert lines[1]["placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert max(lines[2]["rel"]) <= smoke.DIST_F32_TOL
    step1, controls = lines[5]["step1"], lines[5]["controls"]
    assert smoke.step_held(step1) and step1["moved"] > 0
    assert set(controls) == {"no update", "half the batch"}
    assert not any(smoke.step_held(x) for x in controls.values())
    assert smoke.step_held(lines[6]["step1"], f32=True)
    assert got == {name: 0 for name in smoke.ops.KERNELS}
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}
