"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library with
a plain C interface and loaded through :mod:`ctypes`. The build runs at
first use, one ``nvcc`` process per source, all started together, into
``build/kernels/<hash>/`` at the repository root; the hash covers the
sources, the headers they share and the flags, so an edited source
rebuilds and a stale library is never loaded. Nothing here runs at import
time: the CPU-only test machines import every module and have no ``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so every float
operation rounds on its own, as in the plain PyTorch versions (no fused
multiply-add): where a kernel sums in the plain version's order, the two
agree bit for bit.
``--use_fast_math`` is deliberately absent: it makes division approximate
and would break the ``rint(x / s)`` quantizer semantics.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("norm_quant", "peg_quant", "int8_matmul", "int8_attend_decode",
           "paged_attend_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
# C signatures, in the order of the extern "C" declarations in csrc/.
SIGNATURES = {
    "norm_quant": {"norm_quant": [_P, _I] + [_P] * 5 + [_I] * 3 + [_F] +
                   [_I] * 8 + [_P]},
    "peg_quant": {"peg_quant": [_P, _I, _P, _P, _P, _L] + [_I] * 6 + [_P]},
    "int8_matmul": {"int8_matmul": [_P] * 11 + [_I] * 14 + [_P]},
    "int8_attend_decode": {"int8_attend_decode": [_P] * 17 + [_I] * 8 +
                           [_F] + [_I] * 7 + [_P] * 3},
    "paged_attend_decode": {
        "paged_int8_attend_decode": [_P] * 17 + [_I] * 10 + [_F] +
        [_I] * 7 + [_P] * 3,
        "paged_attend_decode": [_P] * 3 + [_I] + [_P] * 8 + [_I] * 10 +
        [_F] + [_I] * 6 + [_P] * 3},
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit required)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):     # sources and shared headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds spent
    (0.0 when everything was already built). Raises with nvcc's output on a
    failed build."""
    out = build_dir()
    missing = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not missing:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for one source (built on first use)."""
    if name not in _LIBS:
        build_all()
        handle = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = handle
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError != 0)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
