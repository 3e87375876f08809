"""BENCHMARK.json keeps the benchmark's rules of form, and every name in it
finds its files."""
import json
from pathlib import Path

import pytest

from _tiny import MANIFEST
from pbench.manifest import NAME, UNIT, Manifest

ROOT = Path(__file__).resolve().parents[2]
D = MANIFEST.data
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_no_problems_and_size():
    assert MANIFEST.problems() == []
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_keys_and_command():
    assert set(D) == KEYS["top"]
    assert D["command"] == ["python3", "portbench/run.py"] and D["paths"] == ["portbench"]
    assert isinstance(D["run_seconds"], int) and 1 <= D["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert 1200 + (2 + 14 * 24) * (D["run_seconds"] + 60) + 24 * 2 * 90 <= 43200
    for c in D["configs"]:
        assert set(c) == KEYS["config"]
    for w in D["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] == 1
    for kind in ("end_to_end", "per_layer"):
        for m in D[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]


@pytest.mark.parametrize("m", D["end_to_end"] + D["per_layer"], ids=lambda m: m["name"])
def test_metric_form(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
        assert m["unit"] == "%"


def test_every_cell_reports_setup_another_and_a_layer():
    for w in D["workloads"]:
        e2e = {m["name"] for m in MANIFEST.metrics(w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = MANIFEST.metrics(w["name"], traced=True)
        assert layers and all(m["moves"] in e2e for m in layers)


def test_each_roofline_has_an_mfu_beside_it():
    for m in D["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in x["name"].split(".") and x["moves"] == m["moves"]
                       and set(x["workloads"]) >= set(m["workloads"]) for x in D["per_layer"])


@pytest.mark.parametrize("c", D["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_published_widths(c):
    f = json.loads((ROOT / c["file"]).read_text())
    assert f["source"] == c["source"] and f["reduced"] == c["reduced"] == []
    a = f["arch"]
    assert a["d_model"] == f["hidden_size"] and a["n_layers"] == f["num_hidden_layers"]
    assert a["n_heads"] == f["num_attention_heads"] and a["n_kv_heads"] == f["num_key_value_heads"]
    assert a["d_head"] * a["n_heads"] == f["hidden_size"] and a["vocab_size"] == f["vocab_size"]
    if a["family"] == "moe":
        assert a["d_ff"] == f["moe_intermediate_size"] and a["n_experts"] == f["num_experts"]
        assert a["moe_topk"] == f["num_experts_per_tok"]
        assert a["n_shared_experts"] * a["d_ff"] == f["shared_expert_intermediate_size"]
    else:
        assert a["d_ff"] == f["intermediate_size"]
    assert a["tie_embeddings"] == f["tie_word_embeddings"] and a["rope_theta"] == f["rope_theta"]


def test_longest_request_within_the_published_context():
    for w in D["workloads"]:
        t = MANIFEST.traffic_path(w["traffic"])
        traffic = json.loads(t.read_text())
        longest = traffic["context_tokens"]["max"] + traffic["question_tokens"] + traffic["answer_tokens"]
        assert longest <= MANIFEST.config(w["config"])["max_position_embeddings"]


def test_problems_are_found():
    bad = json.loads(json.dumps(D))
    bad["workloads"][0]["name"] = "has space"
    bad["per_layer"][0]["workloads"] = [D["workloads"][-1]["name"]]
    assert len(Manifest(bad, ROOT).problems()) >= 2
