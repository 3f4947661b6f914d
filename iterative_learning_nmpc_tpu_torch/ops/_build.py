"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o _build/<name>_<hash>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libnmpc_kernels_<hash>.so _build/*_<hash>.o

The library lands in ``<package>/_build/`` (git-ignored), named by a hash of
the sources, so an edited kernel is rebuilt on its next use. Nothing is
built when the package is imported: ``library()`` builds on the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points, each returning an int: every pointer, and the stream, as c_void_p
SIGNATURES = {
    "dyncore_launch": [_P, _P, _P, _P, _P, _I, _P],
    "dyncore_attributes": [_P],
    "lingram_launch": [_P] * 11 + [_I, _I, _P],
    "lingram_row_floats": [],
    "lingram_attributes": [_P],
    "riccati_rollout_launch": [_P] * 16 + [_I, _I, _F, _F, _F, _P],
    "riccati_sweep_terminal_launch": [_P] * 13 + [_I, _I, _F, _F, _F, _P],
    "riccati_sweep_launch": [_P] * 9 + [_I, _I, _F, _F, _P],
    "forward_rollout_launch": [_P] * 5 + [_I, _I, _F, _P],
    "riccati_attributes": [_P],
    "dynjac_launch": [_P, _P, _P, _P, _P, _P, _I, _P],
    "dynjac_attributes": [_P],
    "policy_pd_launch": [_P] * 13 + [_I] * 6 + [_F, _F, _P],
    "policy_pd_smem_bytes": [_I] * 5,
    "policy_pd_attributes": [_I] * 5 + [_P],
    "policy_pd_bf16_launch": [_P] * 13 + [_I] * 7 + [_F, _F, _P],
    "policy_pd_bf16_attributes": [_I] * 6 + [_P],
    "fma_chain_launch": [_P, _P, _P, _I, _I, _I, _P],
    "node_solve_block_launch": [_P] * 9 + [_I, _P],
    "node_solve_warp_launch": [_P] * 9 + [_I, _P],
    "node_solve_thread_launch": [_P] * 9 + [_I, _P],
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


def _run(procs) -> None:
    """Wait for every nvcc process; raise with the failures' output."""
    errors = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc, tag = _nvcc(), f"{out.stem.rsplit('_', 1)[1]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{f.stem}_{tag}.o" for f in cu]
    procs = []
    for src, obj in zip(cu, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    _run(procs)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        obj.unlink()
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


def ptxas_report(src: Path) -> dict:
    """{kernel: (registers, stack bytes, spill store bytes, spill load
    bytes)} of one source, from ``nvcc -Xptxas -v`` with the build's flags;
    a template instance is named ``kernel<args>``."""
    out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                          "-o", os.devnull], capture_output=True, text=True,
                         check=True).stderr
    report, name, stack = {}, None, (0, 0, 0)
    for line in out.splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+?kernel)((?:I(?:Li\d+E)+E)?)", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), *stack)
            name = None
    return report
