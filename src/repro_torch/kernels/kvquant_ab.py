"""Time K1, K2, K5 and K6 of this checkout against other builds of
``csrc/kvquant.cu`` on one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.kvquant_ab --other OTHER.cu [--other ...]

Each given source is built with the library's flags (``_build.NVCC_FLAGS``)
into its own shared library under ``build/kvquant_ab/``.  Each of its four C
entry points is called with or without the vector width V (the argument
before the stream) as the source declares it: in ``git show
201e068:src/repro_torch/kernels/csrc/kvquant.cu`` K1 and K5 take V, K2 and
K6 do not.  ptxas' registers and spills print for every instantiation of
the four kernels of every build.  At the main path's shapes (K5: kv
``(64,154,10,320)`` f32; K1: d_sym ``(256,154,9,320)`` uint16 -> bf16; K2:
d_sym ``(192,154,9,320)`` -> bf16; K6: d_sym ``(64,154,9,320)`` -> f32)
each build is held to the plain versions (K1 by its bf16 rule, the others
bit for bit) and timed in turns, the others around this checkout's (old,
new, new, old): device time from the profiler and CUDA-event time, per
call.  The last line is one JSON object with the card's name and power
limit.
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
from repro_torch.kernels.kvquant import (
    kv_dequant_plain,
    kv_dequant_tokens_plain,
    kv_lossless_tokens_plain,
    kv_quant_plain,
    vector_width,
)
from repro_torch.kernels.timing import bound_ms, device_ms, time_ms

# C entry point -> its kernel's function name
KERNELS = {
    "kv_quant": "quant_kernel",
    "kv_dequant_tokens": "dequant_tokens_kernel",
    "kv_lossless_tokens": "lossless_tokens_kernel",
    "kv_dequant": "dequant_kernel",
}
_MANGLED = re.compile(r"\d(quant|dequant|dequant_tokens|lossless_tokens)_kernelI(13__nv_bfloat16|f)?(?:Li(\d))?E")
_TYPES = {"13__nv_bfloat16": "__nv_bfloat16", "f": "float"}


def ptxas_summary(log: str) -> dict:
    """The four kernels' instantiations (``dequant_kernel<float, 8>``) ->
    "R registers, S spill bytes", from ``ptxas -v``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = _MANGLED.search(m.group(1))
            fn = k and f"{k.group(1)}_kernel<{', '.join(filter(None, (_TYPES.get(k.group(2)), k.group(3))))}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = f"{int(m.group(1)) + int(m.group(2))} spill bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, " + out.get(fn, "")
    return out


def takes_vector_width(source: str) -> dict:
    """Each ``extern "C"`` entry point of ``source`` -> whether it takes ``int V``."""
    return {m.group(1): re.search(r"\bint V\b", m.group(2)) is not None
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', source)}


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


def callers(lib, with_v: dict) -> dict:
    """Entry point name -> K5, K1 (bf16 out), K2 (bf16 out) or K6 (f32 out)
    through ``lib``; ``with_v[name]`` says whether it takes V."""
    for name in KERNELS:
        sig = _build._SIGNATURES[name]
        getattr(lib, name).argtypes = sig if with_v[name] else sig[:-2] + sig[-1:]
        getattr(lib, name).restype = ctypes.c_int

    def launch(name, tensors, *args):
        """``args`` up to V; V (where the entry takes it, by this checkout's
        rule) and the stream follow.  ``tensors``: the inputs, then out."""
        v = (vector_width(tensors[0].shape[-1], *tensors[:-1], out=tensors[-1]),) if with_v[name] else ()
        _build.check(getattr(lib, name)(*args, *v, torch.cuda.current_stream().cuda_stream), name)

    def k5(kv, bins, qmax):
        B, G, g, C = kv.shape
        out = torch.empty((B, G, g - 1, C), dtype=torch.uint16, device=kv.device)
        launch("kv_quant", (kv, out), kv.data_ptr(), bins.data_ptr(), out.data_ptr(), B, G, g - 1, C, qmax)
        return out

    def k1(d, a, bins, qmax):
        B, G, gm1, C = d.shape
        out = torch.empty((B, G, gm1 + 1, C), dtype=torch.bfloat16, device=d.device)
        launch("kv_dequant_tokens", (d, a, out), d.data_ptr(), a.data_ptr(), bins.data_ptr(), out.data_ptr(),
               B, G, gm1, C, qmax, 1)
        return out

    def k2(d, a, s):
        B, G, gm1, C = d.shape
        out = torch.empty((B, G, gm1 + 1, C), dtype=torch.bfloat16, device=d.device)
        launch("kv_lossless_tokens", (d, a, out), d.data_ptr(), a.data_ptr(), s.data_ptr(), out.data_ptr(),
               B, G, gm1, C, 1)
        return out

    def k6(d, a, bins, qmax):
        B, G, gm1, C = d.shape
        out = torch.empty((B, G, gm1, C), dtype=torch.float32, device=d.device)
        launch("kv_dequant", (d, a, out), d.data_ptr(), a.data_ptr(), bins.data_ptr(), out.data_ptr(),
               B, G, gm1, C, qmax, 0)
        return out

    return {"kv_quant": k5, "kv_dequant_tokens": k1, "kv_lossless_tokens": k2, "kv_dequant": k6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another kvquant.cu to time against this checkout's (repeatable)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kvquant_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    own = takes_vector_width((_build.CSRC / "kvquant.cu").read_text())
    builds = {"new": callers(_build.load_library(), own)}
    ptxas = {"new": ptxas_summary((_build.BUILD_DIR / "kvquant.log").read_text())}
    for src in args.other:
        lib, log = build(src)
        builds[src.stem] = callers(lib, takes_vector_width(src.read_text()))
        ptxas[src.stem] = ptxas_summary(log)
    for name, regs in ptxas.items():
        for fn, what in regs.items():
            print(f"ptxas {name}: {fn}: {what}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    qmax = 127

    def symbols(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.uint16)

    kv = torch.randn(64, 154, 10, 320, generator=gen, device=dev).cumsum(dim=2)
    kbins = torch.rand(64, generator=gen, device=dev) * 0.4 + 0.05
    d1, a1 = symbols(2 * qmax + 1, 256, 154, 9, 320), torch.randn(256, 154, 320, generator=gen, device=dev)
    bins1 = torch.rand(256, generator=gen, device=dev) * 0.2 + 0.01
    d2, a2 = symbols(509, 192, 154, 9, 320), symbols(256, 192, 154, 320)
    s2 = (torch.rand(192, 154, generator=gen, device=dev) * 0.05 + 1e-3).half().float()
    d6, a6 = symbols(2 * qmax + 1, 64, 154, 9, 320), torch.randn(64, 154, 320, generator=gen, device=dev)
    bins6 = torch.rand(64, generator=gen, device=dev) * 0.2 + 0.01
    inputs = {
        "kv_quant": (kv, kbins, qmax),
        "kv_dequant_tokens": (d1, a1, bins1, qmax),
        "kv_lossless_tokens": (d2, a2, s2),
        "kv_dequant": (d6, a6, bins6, qmax),
    }
    want = {
        "kv_quant": kv_quant_plain(kv, kbins, qmax=qmax),
        "kv_dequant_tokens": kv_dequant_tokens_plain(d1, a1, bins1, qmax=qmax, out_dtype=torch.bfloat16),
        "kv_lossless_tokens": kv_lossless_tokens_plain(d2, a2, s2, out_dtype=torch.bfloat16),
        "kv_dequant": kv_dequant_plain(d6, a6, bins6, qmax=qmax, out_dtype=torch.float32),
    }
    for name, fns in builds.items():
        for kernel, fn in fns.items():
            got = fn(*inputs[kernel])
            if kernel == "kv_dequant_tokens":
                x = ops.bf16_ulp_excess(got, want[kernel], **ops.BF16_TOL[kernel])
                if x > 1:
                    raise RuntimeError(f"kvquant_ab: K1 of {name} is {x:.3g} times its rule off its plain version")
            elif not torch.equal(got, want[kernel]):
                raise RuntimeError(f"kvquant_ab: {kernel} of {name} is not bit-exact with its plain version")
    del want

    out_bytes = {  # the output each kernel writes
        "kv_quant": 64 * 154 * 9 * 320 * 2,
        "kv_dequant_tokens": 256 * 154 * 10 * 320 * 2,
        "kv_lossless_tokens": 192 * 154 * 10 * 320 * 2,
        "kv_dequant": d6.numel() * 4,
    }
    ops_count = {
        "kv_quant": 6 * 64 * 154 * 9 * 320,
        "kv_dequant_tokens": 3 * d1.numel(),
        "kv_lossless_tokens": 2 * a2.numel() + 3 * d2.numel(),
        "kv_dequant": 3 * d6.numel(),
    }
    others = [n for n in builds if n != "new"]
    turns = others + ["new", "new"] + others[::-1]
    result = {"card": smi, "turns": turns, "ptxas": ptxas, "kernels": {}}
    for kernel, fn_name in KERNELS.items():
        nbytes = sum(t.numel() * t.element_size() for t in inputs[kernel] if isinstance(t, torch.Tensor))
        bound = bound_ms(nbytes + out_bytes[kernel], ops_count[kernel])
        rows = {n: {"device_ms": [], "ms": []} for n in builds}
        for n in turns:
            fn = lambda: builds[n][kernel](*inputs[kernel])  # noqa: E731
            rows[n]["device_ms"].append(device_ms(fn, fn_name, iters=args.iters))
            rows[n]["ms"].append(time_ms(fn, iters=args.iters))
        for n, r in rows.items():
            print(f"{kernel} {n}: device ms {r['device_ms']}  event ms {r['ms']}  bound {bound[0]:.4f} ms ({bound[1]})")
        result["kernels"][kernel] = {"bound_ms": bound[0], "bound_by": bound[1], **rows}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
