"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The three kernels are compiled together into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/libnmpc_kernels_<hash>.so csrc/*.cu

The library lands in ``<package>/_build/`` (git-ignored), named by a hash of
the sources, so an edited kernel is rebuilt on its next use. Nothing is
built when the package is imported: ``library()`` builds on the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer, and the stream, as c_void_p
SIGNATURES = {
    "dyncore_launch": [_P, _P, _P, _P, _P, _I, _P],
    "lingram_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "riccati_rollout_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P],
}


class _Lib:
    handle = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that runs them")


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnmpc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if _Lib.handle is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _Lib.handle = lib
    return _Lib.handle


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
