#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
``BENCHMARK.json`` names the cells; ``portbench/pbench/cell.py`` says what
a run does.  The port (``src/repro_torch``) builds its kernels into
``build/`` inside the checkout.
"""
import time

T_START_NS = time.time_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pbench.guard import forbidden_loaded
    from pbench.manifest import Manifest

    manifest = Manifest.load(ROOT)
    chips = manifest.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    from pbench.report import execute

    out = execute(manifest, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START_NS)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {bad}; no module of JAX or of the JAX package may be loaded",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(out["line"]) + "\n")
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
