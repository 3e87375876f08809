"""``BENCHMARK.json`` and the files it names: each cell's configuration,
traffic mix and limits, and each metric's reader, all found by name.

* a configuration: the file its ``configs`` entry names;
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a cell's limits and check sizes: ``portbench/cells/<workload>.json``;
* a metric's reader: ``portbench/metrics/<metric>.py``, whose ``read(run)``
  returns the number or None when it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

__all__ = ["Manifest", "NAME", "UNIT", "load_reader"]


def load_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Manifest:
    def __init__(self, data: dict, root: Path = ROOT):
        self.data = data
        self.root = Path(root)

    @classmethod
    def load(cls, root: Path = ROOT) -> "Manifest":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()), root)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic_path(name: str) -> Path:
        return HERE / "traffic" / f"{name}.json"

    @staticmethod
    def cell(name: str) -> dict:
        return json.loads((HERE / "cells" / f"{name}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> List[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        untraced, its per-layer ones traced."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.data[kind] if workload in m.get("workloads", [workload])]

    def problems(self) -> List[str]:
        """What in the manifest breaks the benchmark's rules of form."""
        out: List[str] = []
        d = self.data
        names: Dict[str, set] = {"configs": set(), "workloads": set(), "metrics": set()}

        def name_ok(what: str, n: str) -> None:
            if not isinstance(n, str) or not NAME.match(n):
                out.append(f"{what}: bad name {n!r}")

        for c in d["configs"]:
            name_ok("config", c["name"])
            for key in c["reduced"]:
                name_ok(f"config {c['name']} reduced", key)
            if c["name"] in names["configs"]:
                out.append(f"config {c['name']} twice")
            names["configs"].add(c["name"])
            if not (self.root / c["file"]).is_file():
                out.append(f"config {c['name']}: no file {c['file']}")
        pairs = set()
        for w in d["workloads"]:
            name_ok("workload", w["name"])
            name_ok(f"workload {w['name']} traffic", w["traffic"])
            if w["name"] in names["workloads"]:
                out.append(f"workload {w['name']} twice")
            names["workloads"].add(w["name"])
            if w["config"] not in names["configs"]:
                out.append(f"workload {w['name']}: unknown config {w['config']}")
            if (w["config"], w["traffic"]) in pairs:
                out.append(f"workload {w['name']}: its pair of config and traffic is taken")
            pairs.add((w["config"], w["traffic"]))
            if w["chips"] not in (1, 4):
                out.append(f"workload {w['name']}: {w['chips']} chips")
            if not self.traffic_path(w["traffic"]).is_file():
                out.append(f"workload {w['name']}: no traffic file for {w['traffic']}")
            if not (HERE / "cells" / f"{w['name']}.json").is_file():
                out.append(f"workload {w['name']}: no cell file")
            if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"] or "\t" in w["why"]:
                out.append(f"workload {w['name']}: why of {len(w['why'])} characters")
        e2e = {m["name"]: m for m in d["end_to_end"]}
        for kind in ("end_to_end", "per_layer"):
            for m in d[kind]:
                name_ok(kind, m["name"])
                if m["name"] in names["metrics"]:
                    out.append(f"metric {m['name']} twice")
                names["metrics"].add(m["name"])
                if not UNIT.match(m["unit"]):
                    out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
                if m["better"] not in ("lower", "higher"):
                    out.append(f"metric {m['name']}: better {m['better']!r}")
                if not (HERE / "metrics" / f"{m['name']}.py").is_file():
                    out.append(f"metric {m['name']}: no reader")
                for w in m.get("workloads", []):
                    if w not in names["workloads"]:
                        out.append(f"metric {m['name']}: unknown workload {w}")
        for m in d["per_layer"]:
            moved = e2e.get(m["moves"])
            if moved is None:
                out.append(f"per-layer {m['name']} moves unknown {m['moves']}")
                continue
            cells = m.get("workloads", sorted(names["workloads"]))
            for w in cells:
                if w not in moved.get("workloads", [w]):
                    out.append(f"per-layer {m['name']}: cell {w} does not report {m['moves']}")
        for w in names["workloads"]:
            rep = [m for m in d["end_to_end"] if w in m.get("workloads", [w])]
            if "setup_s" not in {m["name"] for m in rep} or len(rep) < 2:
                out.append(f"workload {w}: needs setup_s and another end-to-end metric")
            if not [m for m in d["per_layer"] if w in m.get("workloads", [w])]:
                out.append(f"workload {w}: no per-layer metric")
        return out

