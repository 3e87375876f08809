#!/usr/bin/env python3
"""Run one cell of the port's benchmark once with the program's own tracer
(``repro_torch.tracing``) on, and print its result with what the program's
spans and counters show.

    python3 portbench/trace_program.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 1`` the tracer records while the profiler does (the traced
window, ``pbench.program.ProgramTrace``); the line gains the readers of
``pbench.program`` under ``program_metrics``, the idle gaps labelled by the
program span the host was in under ``breakdown.program_idle_gaps``, and each
program span's count and summed milliseconds in the window under
``program_spans``.  With ``--trace 0`` the tracer records the whole run with
no profiler: comparing its ``output_tokens_per_s`` with ``run.py``'s on the
same seed gives what the tracer costs when on.  Like ``run.py``, the last
line of standard output is the result's JSON object.
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

READERS = ("load_crc_ms", "load_crc_passes", "load_unpack_ms", "load_h2d_ms", "load_sync_wait_ms",
           "step_enqueue_ms", "step_attn_host_ms", "step_ffn_host_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/trace_program.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import threading

    import torch
    from pbench import cell, program
    from pbench.manifest import Manifest, load_reader
    from pbench.report import execute
    from repro_torch import tracing

    manifest = Manifest.load(ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < manifest.workload(args.workload)["chips"]:
        print(f"portbench: {args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    traces = []

    class Kept(program.ProgramTrace):
        def start(self) -> None:
            traces.append(self)
            super().start()

    cell.DeviceTrace = Kept
    if not args.trace:
        tracing.enable()
    out = execute(manifest, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START_NS)
    record, line = out["record"], out["line"]
    if args.trace:
        record.program = traces[0].program
    else:
        tracing.disable()
        spans, counters = tracing.drain()
        record.program = {"spans": spans, "counters": counters, "main": threading.get_ident()}
    line["program_metrics"] = {name: v for name in READERS if (v := load_reader(name)(record)) is not None}
    prog = program.collected(record)
    by_name = {}
    for s in prog["spans"] if prog else []:
        n, ms = by_name.get(s.name, (0, 0.0))
        by_name[s.name] = (n + 1, ms + (s.t1_ns - s.t0_ns) / 1e6)
    line["program_spans"] = {k: {"count": n, "ms": ms} for k, (n, ms) in sorted(by_name.items())}
    line["program_counters"] = dict(record.program["counters"]) if record.program else {}
    if "breakdown" in line:
        line["breakdown"]["program_idle_gaps"] = program.label_gaps(record)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
