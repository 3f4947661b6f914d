"""The port's replay database (``learning/database.py``) against the JAX
package's, on the same seeded rows: the ring buffer and its overflow, the
normalisation that skips the gait-phase column, the training arrays and
statistics, item access, HDF5 and npz snapshots read across the packages
in both directions, the snapshot read by its suffix, and the sampling
helpers of ``learning/train.py``. numpy and h5py only, no JAX compile:
~5 s of worker time (most of it importing the JAX trainer's module).
"""
import os

import numpy as np
import pytest

from iterative_learning_nmpc_tpu.learning import database as jdb
from iterative_learning_nmpc_tpu.learning import train as jtrain
from iterative_learning_nmpc_tpu_torch.learning import database as tdb
from iterative_learning_nmpc_tpu_torch.learning import train as ttrain

FIELDS = ("states", "actions", "vc_goals", "cc_goals", "traj_ids", "traj_times", "ood")


def rows(rng, n, cc=False):
    """n seeded rows: 44-dim states (column 0 a phase in [0, 1)), 12-dim
    actions, 3-dim vc goals, 5-dim cc goals when asked, ids, times, flags."""
    s = rng.normal(0.0, 1.0, (n, 44)) * rng.uniform(0.1, 3.0, 44)
    s[:, 0] = rng.uniform(0.0, 1.0, n)
    s[:, 7] = 0.25                       # a constant column: std 0 counts as 1
    return dict(states=s, actions=rng.normal(0.0, 0.4, (n, 12)),
                vc_goals=rng.uniform(-0.3, 0.3, (n, 3)),
                cc_goals=rng.normal(0.0, 1.0, (n, 5)) if cc else None,
                traj_id=rng.integers(0, 50, n), times=rng.uniform(0.0, 2.0, n),
                ood=rng.uniform(size=n) < 0.2)


def fill(db, chunks):
    for c in chunks:
        db.append(c["states"], c["actions"], vc_goals=c["vc_goals"], cc_goals=c["cc_goals"],
                  traj_id=c["traj_id"], times=c["times"], ood=c["ood"])
    return db


def assert_same(a, b):
    """Two databases with equal contents, order, statistics and arrays."""
    assert len(a) == len(b)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x[a._order()], y[b._order()], err_msg=f)
    Xa, Ya = a.training_arrays()
    Xb, Yb = b.training_arrays()
    np.testing.assert_array_equal(Xa, Xb)
    np.testing.assert_array_equal(Ya, Yb)
    for u, v in zip(a.get_database_mean_std(), b.get_database_mean_std()):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(a.ood_array(), b.ood_array())


@pytest.mark.parametrize("goal_type", ["vc", "cc"])
def test_ring_buffer_and_statistics_match_jax(goal_type):
    """Chunks of 70, 45 and 60 rows into a limit of 128 (the last two wrap
    and overflow): every array, the start, the statistics (column 0 left
    unnormalised), the training arrays and item access equal the JAX
    Database's."""
    rng = np.random.default_rng(0)
    chunks = [rows(rng, n, cc=goal_type == "cc") for n in (70, 45, 60)]
    j = fill(jdb.Database(limit=128, goal_type=goal_type), chunks)
    t = fill(tdb.Database(limit=128, goal_type=goal_type), chunks)
    assert len(t) == 128 and t.start == j.start == (70 + 45 + 60 - 128) % 128
    assert_same(t, j)
    X, _ = t.training_arrays()
    np.testing.assert_array_equal(X[:, 0], t.states_array()[:, 0].astype(np.float32))
    for i in (0, 5, 127):
        for u, v in zip(t[i], j[i]):
            np.testing.assert_array_equal(u, v)
    # without normalisation the inputs pass through
    j2 = fill(jdb.Database(limit=500, norm_input=False, goal_type=goal_type), chunks)
    t2 = fill(tdb.Database(limit=500, norm_input=False, goal_type=goal_type), chunks)
    assert t2.get_database_mean_std() is None and j2.get_database_mean_std() is None
    np.testing.assert_array_equal(t2.training_arrays()[0], j2.training_arrays()[0])


def test_statistics_follow_appends():
    """The lazy statistics are recomputed after an append."""
    rng = np.random.default_rng(1)
    a, b = rows(rng, 40), rows(rng, 30)
    t = fill(tdb.Database(limit=1000), [a])
    m0 = t.get_database_mean_std()[0].copy()
    fill(t, [b])
    j = fill(jdb.Database(limit=1000), [a, b])
    assert not np.array_equal(m0, t.get_database_mean_std()[0])
    assert_same(t, j)


@pytest.mark.parametrize("fmt", ["hdf5", "npz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_read_across_packages(tmp_path, fmt, writer):
    """A snapshot written by one package and read by the other (and by the
    writer itself) gives the writer's rows back; the JAX npz keeps only the
    four groups of its format, the port's adds ids, times and flags."""
    rng = np.random.default_rng(2)
    chunks = [rows(rng, 90), rows(rng, 60)]
    src = fill((tdb if writer == "port" else jdb).Database(limit=100), chunks)
    path = str(tmp_path / f"agg.{fmt}")
    if fmt == "hdf5":
        src.save_as_hdf5(path)
    else:
        src.save_as_npz(path)
    for mod in (tdb, jdb):
        db = mod.Database(limit=1000)
        if fmt == "hdf5":
            db.load_saved_database(path)
        else:
            db.load_from_npz(path)
        assert len(db) == 100
        full = fmt == "hdf5" or (writer == "port" and mod is tdb)
        for f in FIELDS if full else ("states", "actions", "vc_goals"):
            x, y = getattr(db, f), getattr(src, f)
            if y is None:
                assert x is None, f
            else:
                np.testing.assert_array_equal(x[db._order()], y[src._order()], err_msg=f)
        if full:
            assert_same(db, src)


def test_load_by_suffix_and_config(tmp_path):
    """``Database.load`` reads .hdf5 and .npz by their suffix and refuses
    others; a snapshot with a config writes its pickle beside it, as the
    JAX package's HDF5 snapshot does."""
    rng = np.random.default_rng(3)
    src = fill(tdb.Database(limit=64), [rows(rng, 50)])
    for name in ("a.hdf5", "b.npz"):
        path = str(tmp_path / name)
        (src.save_as_hdf5 if name.endswith("hdf5") else src.save_as_npz)(
            path, config={"tag": name})
        assert os.path.exists(str(tmp_path / (name.split(".")[0] + "_config.pkl")))
        db = tdb.Database(limit=64)
        db.load(path)
        assert_same(db, src)
    with pytest.raises(ValueError, match="unknown dataset format"):
        tdb.Database(limit=4).load(str(tmp_path / "c.csv"))


def test_sampling_helpers_match_jax():
    """make_sample_weights and compute_ood_mask equal the JAX trainer's."""
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=300) < 0.3
    for m in (None, mask):
        np.testing.assert_array_equal(ttrain.make_sample_weights(300, m, 5.0),
                                      jtrain.make_sample_weights(300, m, 5.0))
    states, nominal = rng.normal(0, 2.0, (300, 44)), rng.normal(0, 1.0, (80, 44))
    times, nom_t = rng.uniform(-0.1, 2.2, 300), rng.permutation(np.linspace(0, 2, 80))
    for thr in (14.0, 15.5):
        got = ttrain.compute_ood_mask(states, nominal, times, nom_t, thr)
        np.testing.assert_array_equal(got, jtrain.compute_ood_mask(states, nominal, times,
                                                                   nom_t, thr))
        assert 0 < got.sum() < 300
