"""The port's launcher against the reference's on the vlm family: ``--arch
paligemma-3b`` (``.tiny()``: 8 image rows of 64-wide patch embeddings, drawn
after the context's tokens from the same generator), on the same inputs as
``tests/test_torch_serve.py`` (the reference's weights and prefill, one pair
of calibration reports; ``_torch_serve_world``).

Three runs, each line equal once wall-clock fields are masked: the default
loop of sessions, the tiered store (whose chunks are keyed by their KV
bytes, since the image rows are not text tokens) and a loop checked
against the simulator.  The image rows are cached before the 128 text
tokens, so the stored context has 136 rows; no chunk is recomputed as TEXT.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import serve

from _torch_serve_world import CTX, both, make_assets, make_world, mask

torch.set_num_threads(1)

ARCH = ["--arch", "paligemma-3b"]
CASES = {
    "default": ["--requests", "2"],
    "tiered": ["--requests", "2", "--store", "tiered", "--hot-bytes", "60000"],
    "check-sim": ["--requests", "2", "--concurrency", "2", "--check-sim"],
}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp("serve-vlm"), "paligemma-3b")


@pytest.fixture
def world(assets, monkeypatch):
    return make_world(assets, monkeypatch)


@pytest.mark.parametrize("case", CASES)
def test_vlm_lines_equal_reference(world, case):
    argv = [*ARCH, *CTX, *CASES[case]]
    got, ref = both(world, argv)
    assert mask(got["lines"]) == mask(ref)
    assert world["checked"] and world["checked"][-1] == (1, 128)
    cfg = got["cfg"]
    assert cfg.family == "vlm" and cfg.name == "paligemma-3b-tiny"
    n_rows = 128 + cfg.n_prefix_tokens
    assert got["engine"].capacity == 128 + 32  # the reference's: the 8 image rows fit its slack
    assert len(got["sessions"]) == 2
    for s in got["sessions"]:
        assert s.status == "ok" and -1 not in s.configs and s.caches.length.tolist() == [n_rows]
    if case == "tiered":
        metas = got["store"].meta("ctx")
        assert len(metas) == 3 and all(m.chunk_hash for m in metas) and got["tier_counters"] is not None
    if "--check-sim" in argv:
        assert got["sim_match"] == {0: True, 1: True}


def test_full_width_cache_holds_the_image_rows(monkeypatch, capsys):
    """Under ``--full-width`` the cache is sized from the cached rows, image
    rows included: here a narrow paligemma-3b with 64 image rows (more than
    the reference's 32 rows of slack) serves a 128-token context from a
    cache of 128 + 64 + 32 rows, and a request generates after its load."""
    narrow = dataclasses.replace(registry.get("paligemma-3b").tiny(), n_prefix_tokens=64, dtype="float32")
    monkeypatch.setattr(registry, "get", lambda name: narrow)
    got = serve.run([*ARCH, *CTX, "--full-width", "--requests", "1", "--fixed-level", "0", "--check-sim",
                     "--device", "cpu"])
    capsys.readouterr()
    assert got["engine"].capacity == 128 + 64 + 32
    (s,) = got["sessions"]
    assert s.status == "ok" and s.caches.length.tolist() == [128 + 64] and got["sim_match"] == {0: True}
    assert len(got["generated"][0]) > 0
