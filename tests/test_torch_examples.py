"""The port's examples (``examples/torch``) on the CPU at a reduced size.

Each runs in process as ``__main__`` with ``--device cpu`` and must print
its reference example's lines: every line one of the patterns
``chip_smoke.EXAMPLE_LINES`` holds for it (the patterns phase 18 holds the
card's runs to), every pattern some line.  ``bandwidth_adaptation`` plans on
the host only, so its timeline must equal the reference example's line for
line.
"""
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _run(path, args, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [str(path)] + list(args))
    runpy.run_path(str(path), run_name="__main__")
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


@pytest.mark.parametrize("name, args", [
    ("quickstart", ["--device", "cpu"]),
    ("serve_batched", ["--device", "cpu", "--requests", "2", "--contexts", "1", "--ctx-len", "200", "--gen", "4"]),
    ("train_100m", ["--device", "cpu", "--small", "--steps", "3", "--ckpt-dir", None]),
])
def test_example_prints_its_reference_lines(name, args, monkeypatch, capsys, tmp_path):
    args = [str(tmp_path / "ckpt") if a is None else a for a in args]
    lines = _run(ROOT / "examples" / "torch" / f"{name}.py", args, monkeypatch, capsys)
    pats = [re.compile(p) for p in _smoke().EXAMPLE_LINES[name]]
    for ln in lines:
        assert any(p.fullmatch(ln) for p in pats), ln
    for p in pats:
        assert any(p.fullmatch(ln) for ln in lines), p.pattern
    if name == "serve_batched":
        assert sum(ln.startswith("[req ") for ln in lines) == 2
    if name == "train_100m":
        assert (tmp_path / "ckpt" / "LATEST").exists()


def test_bandwidth_adaptation_equals_the_reference_example(monkeypatch, capsys):
    got = _run(ROOT / "examples" / "torch" / "bandwidth_adaptation.py", [], monkeypatch, capsys)
    want = _run(ROOT / "examples" / "bandwidth_adaptation.py", [], monkeypatch, capsys)
    assert got == want
    assert "\n".join(got) == _smoke().BANDWIDTH_TIMELINE


def test_examples_import_only_the_port():
    for path in (ROOT / "examples" / "torch").glob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text, re.M), path
