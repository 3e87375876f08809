"""The JAX check compares whole top-level names; the harness refuses to run
without a card and without the program."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pbench.guard import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,bad", [
    ("repro_torch.serving.engine", False), ("repro_torch", False), ("jaxtyping", False), ("reprox", False),
    ("repro", True), ("repro.core.codec", True), ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True),
])
def test_whole_top_level_name(name, bad):
    assert bool(forbidden_loaded([name, "torch", "numpy"])) is bad


def test_harness_loads_no_jax():
    code = ("import sys; sys.path[:0]=['portbench','src']; import pbench.report, pbench.check, control; "
            "import repro_torch.serving.scheduler, repro_torch.streaming; from pbench.guard import forbidden_loaded; "
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "smollm360m-gen-c32", "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=120)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
