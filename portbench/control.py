#!/usr/bin/env python3
"""Readings for a cell's limits: the program's numbers on many seeds and
the control's (the float8 reference in the program's place) on some, each
seed a run of the cell with a short window, all in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 4]

Prints one JSON line a seed: the program's numbers, whether the run is
correct under the cell's limits, and where asked the control's numbers and
whether they would pass the same limits (``control_correct``), by the same
verdict a run gives.
The benchmark's own runs never run the control.
"""
import time

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def readings(manifest, workload: str, seed: int, seconds: float, control: bool, device="cuda:0",
             arch=None, traffic=None) -> dict:
    """One seed's run of ``workload``: the program's numbers, its
    ``correct``, and with ``control`` the control's numbers."""
    from pbench import check
    from pbench.cell import run_cell, verdict
    from pbench.traffic import Traffic

    w = manifest.workload(workload)
    cell = manifest.cell(workload)
    arch = arch if arch is not None else manifest.config(w["config"])["arch"]
    traffic = traffic if traffic is not None else Traffic.load(manifest.traffic_path(w["traffic"]))
    ctl = {}

    def both(*args, **kw):
        got = check.judge(*args, control=control, **kw)
        ctl.update(got.pop("control", {}))
        return got

    out = run_cell(arch, traffic, seed, seconds, False, device, time.time_ns(), cell["check"]["waves"],
                   cell["limits"], judge_fn=both)
    control_correct = None
    if ctl:
        ctl["failed_requests"] = 0.0  # the control serves every request
        control_correct = verdict(ctl, cell["limits"])[1]
    return {"seed": seed, "correct": out["correct"], "program": out["numbers"],
            "control": ctl or None, "control_correct": control_correct,
            "waves": len(out["record"].waves)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    from pbench.manifest import Manifest

    manifest = Manifest.load(ROOT)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(manifest, args.workload, s, args.seconds, s in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
