"""A run's result line: the cell's metrics by their readers, the device,
the traced run's breakdown, and the numbers compared beside their limits."""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch

from pbench import yardstick
from pbench.cell import run_cell
from pbench.manifest import Manifest, load_reader
from pbench.traffic import Traffic

__all__ = ["execute", "breakdown"]


def breakdown(record, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the longest idle gaps
    of the window labelled by the harness span the host was in."""
    a, b = record.window
    by_name: Dict[str, float] = {}
    for name, s, e in record.device:
        k = yardstick.kernel_name(name)
        by_name[k] = by_name.get(k, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged = yardstick.merge_intervals((s, e) for _, s, e in record.device)
    holes = sorted(yardstick.gaps(merged, a, b), key=lambda g: g[0] - g[1])[:top]
    idle = [[record.spans.label_at((s + e) // 2), (e - s) / 1e9] for s, e in holes]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def execute(manifest: Manifest, workload: str, seed: int, seconds: float, trace: bool, device, t_start_ns: int,
            arch: Optional[dict] = None, traffic: Optional[Traffic] = None) -> dict:
    """Run ``workload`` once; returns ``line`` (the result's JSON object)
    and ``checks`` (name -> value and limit).  ``arch`` and ``traffic``
    stand in for the cell's own (the tests run small ones on the CPU)."""
    w = manifest.workload(workload)
    cfg = manifest.config(w["config"])
    cell = manifest.cell(workload)
    arch = arch if arch is not None else cfg["arch"]
    traffic = traffic if traffic is not None else Traffic.load(manifest.traffic_path(w["traffic"]))
    out = run_cell(arch, traffic, seed, seconds, trace, device, t_start_ns, cell["check"]["waves"], cell["limits"])
    record = out["record"]
    metrics = {}
    for m in manifest.metrics(workload, trace):
        v = load_reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = torch.device(device)
    info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": out["peak"],
    }
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": info}
    if trace and record.device is not None:
        merged = yardstick.merge_intervals((s, e) for _, s, e in record.device)
        info["busy_s"] = yardstick.covered(merged, *record.window) / 1e9
        info["window_s"] = record.window_s
        line["breakdown"] = breakdown(record)
        inside = sum(yardstick.covered(merged, a, b) for _, a, b in record.spans.items)
        print(f"device time inside the harness's spans: {inside / max(1, info['busy_s'] * 1e9):.4f} "
              f"of {info['busy_s']:.4f} s busy", file=sys.stderr)
    line["checks"] = out["checks"]
    return {"line": line, "checks": out["checks"], "record": record}
