"""Whole runs on the CPU at small sizes: the result line, and ``correct``
coming out false when the timed path is broken underneath."""
import time

import pytest
import torch

from _tiny import MANIFEST, tiny
from pbench.report import execute

CELLS = [w["name"] for w in MANIFEST.data["workloads"]]


def _run(workload, trace=False, seconds=1.0, seed=2**31 + 99):
    arch, traffic = tiny(workload)
    return execute(MANIFEST, workload, seed, seconds, trace, "cpu", time.time_ns(), arch=arch, traffic=traffic)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run(workload, trace):
    out = _run(workload, trace)
    line = out["line"]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    want = {m["name"] for m in MANIFEST.metrics(workload, trace)}
    if not trace:
        assert set(line["metrics"]) == want
    else:  # off the card the device trace's metrics find nothing to read
        assert set(line["metrics"]) <= want and line["metrics"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _decode_state_unchanged(orig):
    def step(self, tokens, caches, active):
        held = (caches.kv_k.clone(), caches.kv_v.clone(), caches.length.clone())
        logits, new = orig(self, tokens, caches, active)
        new.kv_k.copy_(held[0])
        new.kv_v.copy_(held[1])
        return logits, new._replace(length=held[2])
    return step


def _decode_token_altered(orig):
    def step(self, tokens, caches, active):
        logits, new = orig(self, tokens, caches, active)
        return logits.roll(1, dims=-1), new
    return step


def _one_row_token_altered(orig):
    def step(self, tokens, caches, active):
        logits, new = orig(self, tokens, caches, active)
        logits = logits.clone()
        logits[0] = logits[0].roll(1, dims=-1)
        return logits, new
    return step


def _question_token_altered(orig):
    def question(self, tokens, caches, widths):
        logits, new = orig(self, tokens, caches, widths)
        return logits.roll(1, dims=-1), new
    return question


def _half_the_batch_left_out(orig):
    def insert(self, caches, kv_new, rows, starts, run_tokens):
        h = len(rows) // 2
        if h == 0:
            return caches._replace(length=caches.length.clone())
        n = sum(int(t) for t in run_tokens[:h])
        return orig(self, caches, kv_new[:, :, :n], rows[:h], starts[:h], run_tokens[:h])
    return insert


FAULTS = {
    "decode_step_returns_state_unchanged": (_decode_state_unchanged, "decode_step_rows"),
    "decode_token_altered": (_decode_token_altered, "decode_step_rows"),
    "one_row_token_altered": (_one_row_token_altered, "decode_step_rows"),
    "question_token_altered": (_question_token_altered, "prefill_extend_rows"),
    "half_the_batch_left_out_of_the_load": (_half_the_batch_left_out, "insert_runs"),
}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    from repro_torch.serving.engine import Engine

    make, name = FAULTS[fault]
    monkeypatch.setattr(Engine, name, make(getattr(Engine, name)))
    line = _run(workload)["line"]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_small_size(workload):
    import control

    arch, traffic = tiny(workload)
    r = control.readings(MANIFEST, workload, 7, 1.0, True, device="cpu", arch=arch, traffic=traffic)
    assert r["correct"] is True, r["program"]
    assert r["control_correct"] is False, r["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(workload):
    """The control at the cell's own size: the program's run is correct, the
    float8 reference in its place is not, by the run's own verdict (on the
    card: ``python -m pytest portbench/tests -m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import control

    r = control.readings(MANIFEST, workload, 2**31 + 5, 3.0, True)
    assert r["correct"] is True, r["program"]
    assert r["control_correct"] is False, r["control"]
