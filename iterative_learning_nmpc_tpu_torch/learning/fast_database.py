"""ctypes binding of the native C++ replay store (``native/fastbuffer.cpp``).

Counterpart of ``iterative_learning_nmpc_tpu/learning/fast_database.py``,
with the same API: O(1) vectorized ring append, Welford mean/std, weighted
sampling and contiguous gather (the role the reference's torch dataloaders
play).

The library is built from the repository's ``native/fastbuffer.cpp`` at
first use, with the flags of ``native/Makefile`` (``g++ -O3 -std=c++17
-fPIC -Wall -Wextra -shared``), into the port's git-ignored ``_build/``,
named by a hash of the source; the tracked ``native/libfastbuffer.so`` is
neither read nor rebuilt. A build failure raises: ``FastDatabase`` never
hands back a ``Database`` in its place (``native_available`` is the probe).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "fastbuffer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_lib = None


def library_path() -> Path:
    """Where the library built from the current source lands."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastbuffer_{h}.so"


def build() -> Path:
    """Compile ``native/fastbuffer.cpp`` into ``_build/`` unless the library
    of this source is there; raises ``RuntimeError`` with the compiler's
    output when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and move it in place: concurrent builders
    # (test workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                           text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {SOURCE}: {e}") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n{r.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _ensure_built() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    c_i64, c_dp, c_ip = ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    lib.fb_create.restype = ctypes.c_void_p
    lib.fb_create.argtypes = [c_i64] * 4
    lib.fb_destroy.argtypes = [ctypes.c_void_p]
    lib.fb_len.restype = c_i64
    lib.fb_len.argtypes = [ctypes.c_void_p]
    lib.fb_append.argtypes = [ctypes.c_void_p, c_i64, c_dp, c_dp, c_dp, c_ip, c_dp]
    lib.fb_mean_std.argtypes = [ctypes.c_void_p, c_dp, c_dp]
    lib.fb_gather.argtypes = [ctypes.c_void_p, c_ip, c_i64, c_dp, c_dp, c_dp, c_dp]
    lib.fb_sample_indices.argtypes = [ctypes.c_void_p, c_i64, c_dp, ctypes.c_uint64, c_ip]
    lib.fb_save.restype = c_i64
    lib.fb_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fb_load.restype = ctypes.c_void_p
    lib.fb_load.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _ensure_built()
        return True
    except Exception:
        return False


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class FastDatabase:
    """Native-backed replay store with the Database sampling surface."""

    def __init__(self, limit: int, state_dim: int = 44, action_dim: int = 12,
                 goal_dim: int = 3, _handle=None):
        self._lib = _ensure_built()
        self.state_dim, self.action_dim, self.goal_dim = state_dim, action_dim, goal_dim
        self.limit = int(limit)
        self._h = _handle if _handle is not None else self._lib.fb_create(
            self.limit, state_dim, action_dim, goal_dim
        )

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.fb_destroy(self._h)
        except Exception:
            pass

    def __len__(self):
        return int(self._lib.fb_len(self._h))

    def append(self, states, actions, goals=None, traj_ids=None, times=None):
        states = np.ascontiguousarray(np.atleast_2d(states), dtype=np.float64)
        actions = np.ascontiguousarray(np.atleast_2d(actions), dtype=np.float64)
        n = len(states)
        g = (np.ascontiguousarray(np.atleast_2d(goals), dtype=np.float64)
             if goals is not None else None)
        ids = (np.ascontiguousarray(traj_ids, dtype=np.int64)
               if traj_ids is not None else None)
        ts = (np.ascontiguousarray(times, dtype=np.float64)
              if times is not None else None)
        self._lib.fb_append(
            self._h, n, _dptr(states), _dptr(actions),
            _dptr(g) if g is not None else None,
            _iptr(ids) if ids is not None else None,
            _dptr(ts) if ts is not None else None,
        )

    def mean_std(self):
        mean = np.zeros(self.state_dim)
        std = np.zeros(self.state_dim)
        self._lib.fb_mean_std(self._h, _dptr(mean), _dptr(std))
        return mean, std

    def sample(self, n: int, weights: Optional[np.ndarray] = None, seed: int = 0):
        """Weighted sample of n rows -> (states, actions, goals)."""
        idx = np.zeros(n, dtype=np.int64)
        w = (np.ascontiguousarray(weights, dtype=np.float64)
             if weights is not None else None)
        self._lib.fb_sample_indices(
            self._h, n, _dptr(w) if w is not None else None,
            ctypes.c_uint64(seed), _iptr(idx),
        )
        return self.gather(idx)

    def gather(self, idx: np.ndarray):
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        n = len(idx)
        s = np.zeros((n, self.state_dim))
        a = np.zeros((n, self.action_dim))
        g = np.zeros((n, self.goal_dim))
        t = np.zeros(n)
        self._lib.fb_gather(self._h, _iptr(idx), n, _dptr(s), _dptr(a), _dptr(g), _dptr(t))
        return s, a, g

    def save(self, path: str) -> None:
        rc = self._lib.fb_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"fb_save failed for {path}")

    @classmethod
    def load(cls, path: str, state_dim=44, action_dim=12, goal_dim=3):
        lib = _ensure_built()
        h = lib.fb_load(path.encode())
        if not h:
            raise IOError(f"fb_load failed for {path}")
        return cls(1, state_dim, action_dim, goal_dim, _handle=h)
