"""The port's native replay store (``learning/fast_database.py``) against the
JAX package's binding of the same C++ source, on the CPU.

Both load ``native/fastbuffer.cpp``: the JAX binding the tracked
``native/libfastbuffer.so``, the port its own build of the source in its
git-ignored ``_build/`` (the tracked library stays byte for byte as it
is). The same appends, ring overflow, gathers, statistics and seeded
weighted samples give equal arrays, and a buffer saved by either loads in
the other. A failed build raises. No JAX; ~2 s of worker time (one g++
build on a cold tree).
"""
import hashlib
import os

import numpy as np
import pytest

from iterative_learning_nmpc_tpu.learning import fast_database as jfd
from iterative_learning_nmpc_tpu_torch.learning import fast_database as tfd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = os.path.join(ROOT, "native", "libfastbuffer.so")
# sha256 of the tracked library as the repository ships it
TRACKED_SHA256 = "28ac6a280f5abbb1739ecb9571289f3eb0468cf41fa4c041c2f0bc24701feb6d"


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def filled(mod, rng, limit=64, n_appends=5):
    db = mod.FastDatabase(limit=limit, state_dim=6, action_dim=3, goal_dim=2)
    for i in range(n_appends):
        n = 17 + i
        db.append(rng.normal(size=(n, 6)), rng.normal(size=(n, 3)), rng.normal(size=(n, 2)),
                  traj_ids=np.full(n, i), times=np.arange(n) * 1e-3)
    return db


def test_port_builds_its_own_library_and_leaves_native_alone():
    assert tfd.native_available()
    lib = tfd.library_path()
    assert lib.exists() and lib.parent.name == "_build"
    assert os.path.realpath(str(lib)) != os.path.realpath(TRACKED)
    assert sha(TRACKED) == TRACKED_SHA256


@pytest.mark.parametrize("limit,n_appends", [(1000, 3), (64, 5)])   # no wrap, ring overflow
def test_same_rows_statistics_and_samples_as_jax(limit, n_appends):
    t = filled(tfd, np.random.default_rng(0), limit, n_appends)
    j = filled(jfd, np.random.default_rng(0), limit, n_appends)
    assert len(t) == len(j) == min(limit, sum(17 + i for i in range(n_appends)))
    idx = np.random.default_rng(1).integers(0, len(t), 40)
    for a, b in zip(t.gather(idx), j.gather(idx)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.mean_std(), j.mean_std()):
        np.testing.assert_array_equal(a, b)
    w = np.random.default_rng(2).uniform(size=len(t))
    w[::3] = 0.0
    for seed in (0, 42):
        for a, b in zip(t.sample(300, weights=w, seed=seed), j.sample(300, weights=w, seed=seed)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t.sample(50, seed=seed), j.sample(50, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_save_load_across_bindings(tmp_path):
    t = filled(tfd, np.random.default_rng(3))
    p = str(tmp_path / "t.bin")
    t.save(p)
    j = jfd.FastDatabase.load(p, state_dim=6, action_dim=3, goal_dim=2)
    q = str(tmp_path / "j.bin")
    j.save(q)
    t2 = tfd.FastDatabase.load(q, state_dim=6, action_dim=3, goal_dim=2)
    idx = np.arange(len(t))
    for a, b in zip(t.gather(idx), t2.gather(idx)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IOError):
        tfd.FastDatabase.load(str(tmp_path / "missing.bin"))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fastbuffer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tfd, "SOURCE", bad)
    monkeypatch.setattr(tfd, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tfd, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build"):
        tfd.FastDatabase(limit=4)
    assert not tfd.native_available()
