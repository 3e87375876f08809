"""Time K1 and K5 of this checkout against other builds of ``csrc/kvquant.cu``
on one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.kvquant_ab --old OLD.cu [--variant OTHER.cu ...]

Each given source is built with the library's flags (``_build.NVCC_FLAGS``)
into its own shared library under ``build/kvquant_ab/``.  ``--old`` takes a
source whose K1/K5 entry points have no vector-width argument (the
one-thread-per-element kernels, e.g. ``git show 9fd2a6a:src/repro_torch/
kernels/csrc/kvquant.cu``); ``--variant`` takes a patched copy of this
checkout's source, with its signatures.  ptxas' registers and spills print
for every K1/K5 instantiation of every build.  At the main path's shapes (K5: kv
``(64,154,10,320)`` f32; K1: d_sym ``(256,154,9,320)`` uint16 -> bf16) each
build is held to the plain version (K5 bit for bit, K1 by its bf16 rule) and
timed in turns, the others around this checkout's (old, new, new, old):
device time from the profiler and CUDA-event time, per call.  The last line
is one JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.kvquant import kv_dequant_tokens_plain, kv_quant_plain, vector_width
from repro_torch.kernels.timing import bound_ms, device_ms, time_ms

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the K1/K5 entry points before they took the vector width
_SIGNATURES_WITHOUT_V = {
    "kv_dequant_tokens": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "kv_quant": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
}


def ptxas_summary(log: str) -> dict:
    """K1's and K5's mangled kernel names -> "R registers, S spill bytes",
    from ``ptxas -v``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = f"{int(m.group(1)) + int(m.group(2))} spill bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, " + out.get(fn, "")
    return {k: v for k, v in out.items() if re.search(r"\d(quant_kernel|dequant_tokens_kernel)[IE]", k)}


def build(src: Path):
    """``src`` -> (its loaded library, ptxas' log)."""
    out_dir = _build.BUILD_DIR.parent / "kvquant_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{src.stem}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(src),
                        "-o", str(lib_path)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(lib_path)), r.stdout + r.stderr


def callers(lib, with_v: bool):
    """K5 and K1 (bf16 out) through ``lib``'s C entry points."""
    sigs = _build._SIGNATURES if with_v else _SIGNATURES_WITHOUT_V
    for name in ("kv_quant", "kv_dequant_tokens"):
        getattr(lib, name).argtypes = sigs[name]
        getattr(lib, name).restype = ctypes.c_int

    def k5(kv, bins, qmax):
        B, G, g, C = kv.shape
        out = torch.empty((B, G, g - 1, C), dtype=torch.uint16, device=kv.device)
        v = (vector_width(C, kv, out),) if with_v else ()
        _build.check(lib.kv_quant(kv.data_ptr(), bins.data_ptr(), out.data_ptr(), B, G, g - 1, C, qmax,
                                  *v, torch.cuda.current_stream().cuda_stream), "kv_quant")
        return out

    def k1(d, a, bins, qmax):
        B, G, gm1, C = d.shape
        out = torch.empty((B, G, gm1 + 1, C), dtype=torch.bfloat16, device=d.device)
        v = (vector_width(C, d, a, out),) if with_v else ()
        _build.check(lib.kv_dequant_tokens(d.data_ptr(), a.data_ptr(), bins.data_ptr(), out.data_ptr(),
                                           B, G, gm1, C, qmax, 1, *v, torch.cuda.current_stream().cuda_stream),
                     "kv_dequant_tokens")
        return out

    return k5, k1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="a kvquant.cu whose K1/K5 take no vector width")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="a kvquant.cu with this checkout's signatures")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kvquant_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    builds = {"new": callers(_build.load_library(), True)}
    ptxas = {"new": ptxas_summary((_build.BUILD_DIR / "kvquant.log").read_text())}
    for src, with_v in [(s, False) for s in args.old] + [(s, True) for s in args.variant]:
        lib, log = build(src)
        builds[src.stem] = callers(lib, with_v)
        ptxas[src.stem] = ptxas_summary(log)
    for name, regs in ptxas.items():
        for fn, what in regs.items():
            print(f"ptxas {name}: {fn}: {what}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    qmax = 127
    kv = torch.randn(64, 154, 10, 320, generator=gen, device=dev).cumsum(dim=2)
    kbins = torch.rand(64, generator=gen, device=dev) * 0.4 + 0.05
    d = torch.randint(0, 2 * qmax + 1, (256, 154, 9, 320), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    a = torch.randn(256, 154, 320, generator=gen, device=dev)
    dbins = torch.rand(256, generator=gen, device=dev) * 0.2 + 0.01
    want5 = kv_quant_plain(kv, kbins, qmax=qmax)
    want1 = kv_dequant_tokens_plain(d, a, dbins, qmax=qmax, out_dtype=torch.bfloat16)
    for name, (k5, k1) in builds.items():
        if not torch.equal(k5(kv, kbins, qmax), want5):
            raise RuntimeError(f"kvquant_ab: K5 of {name} is not bit-exact with its plain version")
        x = ops.bf16_ulp_excess(k1(d, a, dbins, qmax), want1, **ops.BF16_TOL["kv_dequant_tokens"])
        if x > 1:
            raise RuntimeError(f"kvquant_ab: K1 of {name} is {x:.3g} times its rule off its plain version")
    del want5, want1

    others = [n for n in builds if n != "new"]
    turns = others + ["new", "new"] + others[::-1]
    runs = {
        "kv_quant": ("quant_kernel", lambda k5, k1: k5(kv, kbins, qmax),
                     bound_ms(kv.numel() * 4 + 64 * 4 + 64 * 154 * 9 * 320 * 2, 6 * 64 * 154 * 9 * 320)),
        "kv_dequant_tokens": ("dequant_tokens_kernel", lambda k5, k1: k1(d, a, dbins, qmax),
                              bound_ms(d.numel() * 2 + a.numel() * 4 + 256 * 4 + 256 * 154 * 10 * 320 * 2,
                                       3 * d.numel())),
    }
    result = {"card": smi, "turns": turns, "kernels": {}}
    for kernel, (fn_name, call, bound) in runs.items():
        rows = {n: {"device_ms": [], "ms": []} for n in builds}
        for n in turns:
            fn = lambda: call(*builds[n])  # noqa: E731
            rows[n]["device_ms"].append(device_ms(fn, fn_name, iters=args.iters))
            rows[n]["ms"].append(time_ms(fn, iters=args.iters))
        for n, r in rows.items():
            print(f"{kernel} {n}: device ms {r['device_ms']}  event ms {r['ms']}  bound {bound[0]:.4f} ms ({bound[1]})")
        result["kernels"][kernel] = {"bound_ms": bound[0], "bound_by": bound[1], **rows}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
