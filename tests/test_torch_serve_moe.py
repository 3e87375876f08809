"""The port's launcher against the reference's on the MoE family:
``--arch qwen2-moe-a2.7b`` (``.tiny()``: 8 experts, top-2, 2 shared), on
the same inputs as ``tests/test_torch_serve.py`` (the reference's weights
and prefill, one pair of calibration reports; ``_torch_serve_world``).

Three of that file's sim-transport cases, each line equal once wall-clock
fields are masked: a closed loop checked against the simulator (all its
chunks recomputed as TEXT at this size), a wave of two pinned to level 2
(two requests' runs decoded in stacked calls), and an open loop on two
rows that generates through MoE decode steps and preempts.
"""
import pytest
import torch

from _torch_serve_world import CTX, SIM_CASES, both, make_assets, make_world, mask

torch.set_num_threads(1)

ARCH = ["--arch", "qwen2-moe-a2.7b"]
CASES = ("closed-check-sim", "wave-of-2", "open-loop-generate-preempt")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return make_assets(tmp_path_factory.mktemp("serve-moe"), "qwen2-moe-a2.7b")


@pytest.fixture
def world(assets, monkeypatch):
    return make_world(assets, monkeypatch)


@pytest.mark.parametrize("case", CASES)
def test_moe_sim_lines_equal_reference(world, case):
    argv = [*ARCH, *CTX, *SIM_CASES[case]]
    got, ref = both(world, argv)
    assert mask(got["lines"]) == mask(ref)
    assert world["checked"] and world["checked"][-1] == (1, 128)
    assert got["cfg"].family == "moe" and got["cfg"].name == "qwen2-moe-a2.7b-tiny"
    n = int(argv[argv.index("--requests") + 1])
    assert len(got["sessions"]) == n
    if "--check-sim" in argv:
        assert got["sim_match"] == {r: True for r in range(n)}
    if "--fixed-level" in argv:
        assert all(s.n_runs > 0 for s in got["sessions"])
    if "--arrivals" in argv:
        assert got["open_loop"].n_failed == 0 and got["open_loop"].n_gen_tokens > 0
