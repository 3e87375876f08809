"""Shared set-up of the launcher parity tests (``tests/test_torch_serve.py``,
``tests/test_torch_serve_moe.py`` and ``tests/test_torch_serve_vlm.py``):
both launchers in process on the same flags, config, weights, prefill and
calibration reports (see ``test_torch_serve.py``'s docstring), and the
masks that compare their printed lines."""
import contextlib
import dataclasses
import io
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import Caches
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
CTX = ["--ctx-len", "128"]


def _f32(get):
    return lambda name: dataclasses.replace(get(name), dtype="float32")


def make_assets(tmp, arch="smollm-360m"):
    """The reference's weight draw of ``arch``'s f32 ``.tiny()`` for both
    packages, and one codec and one session report in ``tmp``."""
    codec_report = tmp / "codec.json"
    codec_report.write_text((ROOT / "BENCH_codec.json").read_text())
    session_report = tmp / "session.json"
    # level 2 stays hot longest, level 0 leaves first: a priority order
    # that differs from plain LRU
    session_report.write_text(json.dumps({
        "host_backend": "cpu",
        "scenarios": [{"levels": {"0": 1, "1": 2, "2": 5, "-1": 3}}],
    }))
    jcfg = dataclasses.replace(jregistry.get(arch).tiny(), dtype="float32")
    cfg = dataclasses.replace(registry.get(arch).tiny(), dtype="float32")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return dict(params=params, jparams=jparams, jcfg=jcfg, tmp=tmp,
                reports=dict(codec=codec_report, session=session_report))


def make_world(assets, monkeypatch):
    """Both launchers on the same inputs (see ``test_torch_serve.py``)."""
    jcfg, jparams = assets["jcfg"], assets["jparams"]
    checked = []

    class RefPrefillEngine(Engine):
        """The port's engine, whose ``calculate_kv`` hands back the
        reference's prefill of the same tokens once its own is within the
        engine tests' 1e-4 of it."""

        def calculate_kv(self, batch):
            logits, caches = super().calculate_kv(batch)
            jeng = JEngine(jcfg, jparams, cache_capacity=self.capacity)
            # the vlm family's batch also holds its f32 patch embeddings
            jlogits, jc = jeng.calculate_kv({k: jnp.asarray(v.numpy()) for k, v in batch.items()})
            want = (np.array(jlogits), np.array(jc.kv_k), np.array(jc.kv_v))
            for got, ref in zip((logits, caches.kv_k, caches.kv_v), want):
                np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
            checked.append(tuple(batch["tokens"].shape))
            return torch.as_tensor(want[0]), Caches(
                torch.as_tensor(want[1]), torch.as_tensor(want[2]),
                torch.as_tensor(np.array(jc.length)))

    monkeypatch.setattr(jregistry, "get", _f32(jregistry.get))
    monkeypatch.setattr(registry, "get", _f32(registry.get))
    monkeypatch.setattr(serve, "Engine", RefPrefillEngine)
    reports = assets["reports"]
    for var, which in (("CACHEGEN_BENCH_CODEC", "codec"), ("CACHEGEN_TORCH_BENCH_CODEC", "codec"),
                       ("CACHEGEN_BENCH_SESSION", "session"), ("CACHEGEN_TORCH_BENCH_SESSION", "session")):
        monkeypatch.setenv(var, str(reports[which]))
    return dict(params=assets["params"], checked=checked, tmp=assets["tmp"])


def run_reference(argv):
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["repro.launch.serve", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jserve.main()
    finally:
        sys.argv = saved
    return out.getvalue().splitlines()


def run_port(world, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = serve.run([*argv, "--device", "cpu"], params=world["params"])
    assert out.getvalue().splitlines() == got["lines"]
    return got


WALL = [
    (re.compile(r"wall_decode=[\d.]+ ms"), "wall_decode=* ms"),
    (re.compile(r"wall_total=[\d.]+ ms"), "wall_total=* ms"),
    (re.compile(r"tpot_mean=[\d.]+ms"), "tpot_mean=*ms"),
    (re.compile(r"tpot mean=[\d.]+ ms p95=[\d.]+ ms"), "tpot mean=* ms p95=* ms"),
    (re.compile(r"agg [\d.naninf]+ tok/s"), "agg * tok/s"),
    (re.compile(r"server on \('127\.0\.0\.1', \d+\)"), "server on *"),
]


def mask(lines):
    out = []
    for line in lines:
        for pat, rep in WALL:
            line = pat.sub(rep, line)
        out.append(line)
    return out


def both(world, argv):
    got = run_port(world, argv)
    ref = run_reference(argv)
    return got, ref


SIM_CASES = {
    "closed-check-sim": ["--requests", "2", "--check-sim"],
    "closed-fixed-level-0": ["--requests", "2", "--fixed-level", "0", "--max-run-tokens", "64", "--check-sim"],
    "wave-of-2": ["--requests", "3", "--concurrency", "2", "--fixed-level", "2"],
    "open-loop-generate-preempt": ["--requests", "4", "--arrivals", "poisson:40", "--rows", "2",
                                   "--generate", "4", "--preempt", "--fixed-level", "0"],
    "open-loop-preempting": ["--requests", "4", "--arrivals", "poisson:300", "--rows", "1", "--slo-ms", "10",
                             "--generate", "4", "--preempt", "--fixed-level", "0"],
    "tiered-faults-retry": ["--requests", "2", "--store", "tiered", "--hot-bytes", "60000",
                            "--fault-truncate", "0.5", "--fault-seed", "3", "--retry", "3",
                            "--fixed-level", "1"],
    "tiered-cold-missing": ["--requests", "2", "--store", "tiered", "--hot-bytes", "0",
                            "--fault-missing", "0.3", "--fault-seed", "5", "--retry", "2",
                            "--fixed-level", "1"],
}
