"""Multi-pod dry run: run every (arch x shape x mesh) cell once on meta
tensors, as one rank of a fake process group.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell under GSPMD on 256 (16 data x 16 model) or 512 (2 pods x 16 x 16)
forced host devices and reads XLA's analyses.  The port has no compiler
between the model and the card, so it runs the cell instead, as rank 0 of a
``"fake"`` process group (``FakeStore``: every collective returns at once,
moving nothing) of world 256 or 512, on a ``DeviceMesh`` of the production
shape built from that group (``launch.mesh.make_production_mesh`` needs
real cards).  Every input is a meta tensor placed on the mesh
(``launch.specs``), so nothing is allocated and no kernel runs: the step's
ops are evaluated for their shapes only, and ``kernels.ops`` takes the
card's route with the plain versions in the kernels' place.  Each cell runs
once, under:

* ``hlo_stats.FlopCounter``: one rank's FLOPs (``cost.flops``), each K3/K4
  call by its plain version's product FLOPs;
* ``hlo_stats.CollectiveCounter``: one rank's collectives, priced by the
  reference's ring wire-byte model (``collectives``);
* ``torch.distributed._tools.mem_tracker.MemTracker``: the peak of what the
  step allocates beside its arguments (``memory.temp_size_in_bytes``;
  outputs included), or ``{"error": ...}`` where it cannot run.

Record keys kept from the reference, with the same meaning: ``status``,
``reason``, ``error``, ``traceback``; ``memory.argument_size_in_bytes`` and
``output_size_in_bytes`` (one rank's bytes, from the DTensors' local
shapes); ``memory.temp_size_in_bytes``; ``cost.flops``;
``collectives.{counts,result_bytes,wire_bytes,total_wire_bytes}``;
``extrapolated`` (``_reduced_pair`` and ``_extrapolate``: the depth-1 and
depth-2 cells, extended linearly to the full depth).  ``trace_s`` (the
run's wall seconds) stands in for ``lower_s`` and ``compile_s``.

Reference keys and flags with no torch meaning, left out:
* ``bytes accessed`` and ``optimal_seconds`` (``cost``), and
  ``transcendentals``: XLA's cost model of a compiled program; eager ops
  have none, and ``torch.utils.flop_counter`` counts products only;
* ``generated_code_size_in_bytes``: no code is generated;
* ``alias_size_in_bytes`` and ``--donate``: buffer donation is an XLA
  compile option; the port's decode step writes its caches in place and its
  train step makes a new state, whatever a flag says;
* ``hlo_lines`` and ``--save-hlo``: there is no HLO.
``extrapolated`` keeps ``flops``, ``wire_bytes``, ``counts`` and
``total_wire_bytes``.  Eager code runs every layer, so the full-depth
numbers are counted directly and the extrapolation only checks that the
stack is homogeneous: it is not where DTensor places a depth-1 stack
otherwise than deeper ones (mamba2-370m's train step).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --jobs 4 --mesh both --out results/dryrun_torch
Each cell runs in a child process of its own (the fake group is one per
process; isolated failures); the parent never starts a process group.
Records go to ``<out>/<arch>.<shape>.<mesh>[.<tag>].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


def fake_mesh(shape, axes):
    """This process as rank 0 of a fake process group of ``prod(shape)``
    ranks, and the ``DeviceMesh`` of ``shape`` and ``axes`` over it."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _locals(tree) -> list:
    """One rank's tensors of ``tree``: a DTensor's local block, a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import tree_leaves

    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)]


def local_bytes(tree) -> int:
    """One rank's bytes of the tensors of ``tree``."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def _mem_tracker():
    """``MemTracker`` over one rank's local tensors: an op on DTensors is
    left to DTensor first, and the ops of DTensor's shape propagation (fake
    tensors of global shapes, under a fake mode, no memory) are left out,
    as torch 2.13's tracker does by itself (2.11's counts their factory
    calls at global shapes)."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if active_fake_mode() is not None or any(issubclass(t, FakeTensor) for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Tracker()


def run_counted(cell, mesh, mesh_size: int, *, memory: bool = True):
    """Run ``cell.fn`` once on its inputs under the rules, counting: returns
    (outputs, FLOPs, ``hlo_stats.CollectiveStats``, temp bytes or an error
    string, wall seconds)."""
    from repro_torch.launch import hlo_stats
    from repro_torch.models import sharding as shlib

    flops, colls = hlo_stats.FlopCounter(), hlo_stats.CollectiveCounter()
    tracker = _mem_tracker() if memory else None
    temp = None
    if tracker is not None:  # the arguments are there before the step: tracked, then taken off the peak
        tracker.track_external(*_locals(cell.inputs))
    t0 = time.perf_counter()
    with shlib.use_rules(mesh, cell.rules), colls, flops:
        with tracker if tracker is not None else contextlib.nullcontext():
            out = cell.fn(*cell.inputs)
    trace_s = time.perf_counter() - t0
    if tracker is not None:
        try:
            peak = tracker.get_tracker_snapshot("peak")
            temp = int(sum(v["Total"] for v in peak.values())) - local_bytes(cell.inputs)
        except Exception as e:  # pragma: no cover - MemTracker's own faults
            temp = f"{type(e).__name__}: {e}"
    return out, flops.flops, hlo_stats.collective_stats(colls.records, mesh_size), temp, trace_s


def _reduced_pair(cfg):
    """Two reduced-depth configs + (k1, k2, K) in layer units.

    ``F(K) = F(k1) + (F(k2) - F(k1)) * (K - k1) / (k2 - k1)``, exact for
    homogeneous stacks.  The reference needs it because XLA's cost analysis
    counts a loop body once; the port's eager code counts every layer, so
    here it checks the stack instead (module docstring).
    """
    if cfg.family == "hybrid":
        e = cfg.shared_block_every
        c1 = dataclasses.replace(cfg, n_layers=e, scan_unroll=True)
        c2 = dataclasses.replace(cfg, n_layers=2 * e, scan_unroll=True)
        return c1, c2, (1, 2, cfg.n_layers // e)
    if cfg.family == "encdec":
        c1 = dataclasses.replace(cfg, n_layers=2, enc_layers=1, dec_layers=1, scan_unroll=True)
        c2 = dataclasses.replace(cfg, n_layers=4, enc_layers=2, dec_layers=2, scan_unroll=True)
        return c1, c2, (1, 2, cfg.enc_layers)
    c1 = dataclasses.replace(cfg, n_layers=1, scan_unroll=True)
    c2 = dataclasses.replace(cfg, n_layers=2, scan_unroll=True)
    return c1, c2, (1, 2, cfg.n_layers)


def _cell_metrics(cfg, shape, mesh, overrides, n_chips):
    """Run one config's cell; return its FLOPs and collectives."""
    from repro_torch.launch.specs import make_cell

    _, flops, st, _, _ = run_counted(make_cell(cfg, shape, mesh, overrides), mesh, n_chips, memory=False)
    return {"flops": float(flops), "wire_bytes": dict(st.wire_bytes), "counts": dict(st.counts)}


def _extrapolate(m1, m2, k1, k2, K):
    def lin(a, b):
        return a + (b - a) * (K - k1) / (k2 - k1)

    out = {
        "flops": lin(m1["flops"], m2["flops"]),
        "wire_bytes": {k: lin(m1["wire_bytes"][k], m2["wire_bytes"][k]) for k in m1["wire_bytes"]},
        "counts": {k: lin(m1["counts"][k], m2["counts"][k]) for k in m1["counts"]},
    }
    out["total_wire_bytes"] = float(sum(out["wire_bytes"].values()))
    return out


def run_cell(arch: str, shape: str, mesh_kind: str, rules_json: str = "", cfg_json: str = "") -> dict:
    """One cell's record.  Starts this process's fake process group on
    ``mesh_kind``'s production shape (unless the cell is skipped)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.specs import cell_applicable, make_cell

    cfg = registry.get(arch)
    if cfg_json:
        cfg = dataclasses.replace(cfg, **json.loads(cfg_json))
    ok, why = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = fake_mesh(*MESHES[mesh_kind])
    n_chips = mesh.size()
    overrides = json.loads(rules_json) if rules_json else {}
    overrides = {k: (tuple(v) if isinstance(v, list) else v) for k, v in overrides.items()}
    try:
        cell = make_cell(cfg, shape, mesh, overrides)
        out, flops, st, temp, trace_s = run_counted(cell, mesh, n_chips)
        rec["trace_s"] = round(trace_s, 2)
        rec["torch"] = torch.__version__
        rec["memory"] = {"error": temp} if isinstance(temp, str) else {
            "argument_size_in_bytes": local_bytes(cell.inputs),
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": temp,
        }
        rec["cost"] = {"flops": float(flops)}
        rec["collectives"] = {
            "counts": st.counts,
            "result_bytes": st.result_bytes,
            "wire_bytes": st.wire_bytes,
            "total_wire_bytes": st.total_wire_bytes,
        }
        del out, cell
        try:
            c1, c2, (k1, k2, K) = _reduced_pair(cfg)
            m1 = _cell_metrics(c1, shape, mesh, overrides, n_chips)
            m2 = _cell_metrics(c2, shape, mesh, overrides, n_chips)
            rec["extrapolated"] = _extrapolate(m1, m2, k1, k2, K)
            rec["extrapolated"]["points"] = {"k1": k1, "k2": k2, "K": K, "m1": m1, "m2": m2}
        except Exception as e:
            rec["extrapolated"] = {"error": f"{type(e).__name__}: {e}"}
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def record_name(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    return f"{arch}.{shape}.{mesh_kind}{'.' + tag if tag else ''}.json"


def _write(out_dir: str, name: str, rec: dict) -> None:
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--rules", default="", help="JSON logical-rule overrides")
    ap.add_argument("--cfg", default="", help="JSON ArchConfig field overrides")
    ap.add_argument("--tag", default="", help="suffix for the output file name")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required")
        if len(meshes) > 1:  # one fake group a process: each mesh in a child
            return _run_children([(args.arch, args.shape, mk) for mk in meshes], args)
        rec = run_cell(args.arch, args.shape, meshes[0], args.rules, args.cfg)
        _write(args.out, record_name(args.arch, args.shape, meshes[0], args.tag), rec)
        print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "error", "trace_s")}))
        return 0

    from repro_torch.launch.specs import all_cells

    jobs = []
    for arch, shape, (ok, why) in all_cells():
        for mk in meshes:
            if not ok:
                rec = {"arch": arch, "shape": shape, "mesh": mk, "status": "skipped", "reason": why}
                _write(args.out, record_name(arch, shape, mk, args.tag), rec)
                print(f"[dryrun] skip {arch} {shape} {mk}: {why[:60]}")
                continue
            jobs.append((arch, shape, mk))
    return _run_children(jobs, args)


def _run_children(jobs, args) -> int:
    """One child process a cell, at most ``args.jobs`` at once; the children's
    exit codes decide ours."""
    running, results = [], []

    def reap(block: bool):
        while running:
            for item in list(running):
                p, *cell = item
                if p.poll() is not None:
                    running.remove(item)
                    results.append((*cell, p.returncode))
                    print(f"[dryrun] done {' '.join(cell)} rc={p.returncode}", flush=True)
            if not block or len(running) < args.jobs:
                return
            time.sleep(0.5)

    for arch, shape, mk in jobs:
        reap(block=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--mesh", mk, "--out", args.out]
        for flag in ("rules", "cfg", "tag"):
            if getattr(args, flag):
                cmd += [f"--{flag}", getattr(args, flag)]
        running.append((subprocess.Popen(cmd, env=os.environ.copy()), arch, shape, mk))
    while running:
        reap(block=False)
        time.sleep(0.5)
    n_fail = sum(1 for *_, rc in results if rc != 0)
    print(f"[dryrun] all done: {len(results)} ran, {n_fail} subprocess failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
