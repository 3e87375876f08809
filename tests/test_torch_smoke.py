"""``chip_smoke.py`` off the card: it refuses to run without one, and its
main path (phases 4-5) and store path (phase 6) run at a tiny size on the
CPU through the kernels' plain versions (no launch counted)."""
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


def test_chip_smoke_store_path_runs_on_cpu_at_tiny_size(rehearsal):
    """Phase 6 at four 20-token chunks: the stated scenario's plan holds two
    levels and a TEXT chunk whatever the chunks' sizes (the script fails
    otherwise), and both materialize modes agree."""
    smoke, cfg, gen, served, _ = rehearsal
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        smoke.drive_store_path(cfg, torch.device("cpu"), gen, served, chunk=20, gen_tokens=8)
    out = out.getvalue()
    assert "plan from the stated rates: configs [0, " in out and "-1, -1]" in out
    assert "plan from this device's own rates" in out and "store steps ms" in out
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}
