"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
an object with a plain C interface, the objects are linked into one shared
library, and the library is loaded with ``ctypes``.  PyTorch's headers are
never included, so a build takes seconds, not minutes.  The sources compile
in parallel, one ``nvcc`` each.

The build runs at first use, never at import: the CPU tests import every
module on machines without ``nvcc``.  It lands in ``build/torch_kernels/`` at
the repository root, under a name keyed by a hash of the sources and flags,
so an edited source rebuilds and concurrent processes never load a half
written library (each builds in a private directory and renames).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["CSRC", "BUILD_DIR", "HEAD_DIMS", "aligned16", "load_library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# the head dims K3's and K4's kernels are built for (their `switch (D)`)
HEAD_DIMS = (32, 64, 80, 128, 256)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every entry returns cudaError_t as int)
_SIGNATURES = {
    # kvquant.cu
    "kv_dequant_tokens": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    "kv_lossless_tokens": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "kv_quant": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "kv_dequant": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P),
    # decode_attention.cu
    "decode_attention": (
        _P, _P, _P, _P, _P, _P,  # q k v kv_len out part
        _I, _I, _I, _I, _I, _I,  # B Hq Hkv S D n_splits
        _L, _L, _L, _L, _L, _L,  # q strides (b, h), k strides (b, s, h), v stride b
        _L, _L,  # v strides (s, h)
        _I, _F, _I, _I, _P,  # split_size scale q_dtype kv_dtype stream
    ),
    # flash_attention.cu
    "flash_attention": (
        _P, _P, _P, _P, _P,  # q k v prefix_len out
        _I, _I, _I, _I, _I, _I,  # B Hq Hkv Tq Tk D
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v/o strides (b, t, h)
        _I, _I, _F, _I, _P,  # causal use_prefix scale dtype stream
    ),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return str(path)


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, sources) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, running = [], {}
        t0 = time.perf_counter()
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            log = open(Path(tmp) / (src.stem + ".log"), "w")  # ptxas -v: registers, spills
            running[src] = (log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT,
            ))
        failed = []
        while running:
            for src, (log, proc) in list(running.items()):
                if proc.poll() is None:
                    continue
                log.write(f"nvcc {src.name}: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s\n")
                log.close()
                del running[src]
                if proc.returncode:
                    failed.append(f"{src.name}:\n{(Path(tmp) / (src.stem + '.log')).read_text()}")
            time.sleep(0.1)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = Path(tmp) / target.name
        subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *map(str, objs)],
            check=True, capture_output=True, text=True,
        )
        for log in Path(tmp).glob("*.log"):
            os.replace(log, target.parent / log.name)
        os.replace(lib, target)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            sources = sorted(CSRC.glob("*.cu"))
            target = BUILD_DIR / f"libtorch_kernels_{_source_hash(sources)}.so"
            if not target.exists():
                _build(target, sources)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its base address and every stride but the last are
    multiples of 16 bytes, as the kernels' 16-byte row copies need; else a
    contiguous copy (any of ``HEAD_DIMS`` makes that aligned)."""
    es = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)
