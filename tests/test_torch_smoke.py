"""``chip_smoke.py`` off the card: it refuses to run without one, and its
main path runs at a tiny size on the CPU through the kernels' plain
versions (no launch counted)."""
import importlib.util
from pathlib import Path

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


def test_chip_smoke_main_path_runs_on_cpu_at_tiny_size(capsys):
    smoke = _load_smoke()
    cfg = smoke.registry.get("smollm-360m").tiny()
    smoke.ops.reset_launch_counts()
    smoke.drive_main_path(cfg, torch.device("cpu"), torch.Generator(device="cpu"),
                          lengths=(40, 37, 30, 20), chunk=20, capacity=64)
    out = capsys.readouterr().out
    assert "serve steps ms" in out and "TEXT chunk K vs exact prefill" in out
    assert smoke.ops.launch_counts() == {name: 0 for name in smoke.ops.KERNELS}
