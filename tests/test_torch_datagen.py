"""The port's BC data collection (``learning/datagen.py``) and dataset file
utilities (``learning/dataset_utils.py``) against the JAX package's, on the
CPU.

- ``DataCollection`` and ``PretrainDataCollection`` with the rollouts
  stood in for by one deterministic fake on both sides (rows written as the
  recorder writes them; pushes above 66 N "fall", so that retries run): the
  same rollout calls in the same order (commands, restart states and
  times, force draws, replanning points, file names), and the port's npz
  snapshot holds the JAX HDF5 snapshot's rows, ids, times and OOD flags;
  snapshots are numbered by the ``database_*.npz`` already there;
- ``save_training_dataset_with_ood`` on synthesized npz rollouts equal to
  the JAX one (as the JAX ``tests/test_learning.py`` OOD test builds them);
- ``merge_npz`` and ``find_rollouts`` equal to the JAX ones;
  ``download_dataset`` raises ``RuntimeError`` without ``huggingface_hub``;
- ``PretrainDataCollection`` skips a goal whose rollout diverged, and lets
  any other error of the rollout (CUDA, out of memory, a kernel build)
  through.

Marked slow: the real ``DataCollection.run`` (Go2 trot, 0.3 m/s, 0.2 s
nominal, two replanning points, 0.2 s pushed restarts; three MPC rollouts in
MuJoCo) against the JAX run in ``tests/data/go2_learning_pipeline_golden.npz``
(~25 s on the CPU). Tier-1 worker time ~3 s, no JAX compile.
"""
import glob
import os
import sys

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu.learning import database as jdb
from iterative_learning_nmpc_tpu.learning import datagen as jdg
from iterative_learning_nmpc_tpu.learning import dataset_utils as jdu
from iterative_learning_nmpc_tpu.learning import rollouts as jroll
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jgo2
from iterative_learning_nmpc_tpu_torch.learning import datagen as tdg
from iterative_learning_nmpc_tpu_torch.learning import dataset_utils as tdu
from iterative_learning_nmpc_tpu_torch.learning import rollouts as troll
from iterative_learning_nmpc_tpu_torch.learning.database import Database
from iterative_learning_nmpc_tpu_torch.mpc.controller import SolverDiverged
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_learning_pipeline_golden.npz")
ROW_TOL = {"q": 1e-4, "v": 1e-2, "state": 1e-2, "action": 5e-3}


class FakeRollouts:
    """One deterministic stand-in for ``rollout_mpc`` shared by both
    packages: writes recorder-contract rows seeded by the call, logs the
    call, and reports a push above 66 N as a fall."""

    def __init__(self, result_cls):
        self.result_cls, self.log = result_cls, []

    def __call__(self, spec, sim_time=2.0, v_des=np.zeros(3), gait_name="trot", record_dir="",
                 start_state=None, start_time=0.0, force_schedule=None, nominal_flag=True,
                 replanning_point=0, nth_traj=0, **_):
        f = force_schedule[0] if force_schedule else None
        sub = os.path.basename(record_dir)          # goal_<g> for a pretrain goal
        call = (round(float(sim_time), 9), tuple(np.round(np.asarray(v_des, float), 12)),
                sub if sub.startswith("goal_") else "", None if start_state is None else
                tuple(np.round(np.concatenate(start_state), 12)), float(start_time),
                None if f is None else (f.start, f.end, tuple(f.force)), nominal_flag,
                replanning_point, nth_traj)
        self.log.append(call)
        fell = f is not None and np.linalg.norm(f.force) > 66.0
        n = int(round(sim_time / 1e-3))
        rng = np.random.default_rng(len(self.log))
        t = float(start_time) + np.arange(n) * 1e-3
        q = np.tile(np.r_[0.0, 0.0, 0.3, 1.0, np.zeros(15)], (n, 1)) + 1e-3 * rng.normal(size=(n, 19))
        name = ("traj_nominal_x.npz" if nominal_flag else f"traj_{replanning_point}_{nth_traj}.npz")
        path = os.path.join(record_dir, name)
        os.makedirs(record_dir, exist_ok=True)
        state = rng.normal(size=(n, 44)) + (5.0 if fell else 0.0) * (t[:, None] > t[n // 2])
        np.savez(path, time=t, q=q, v=rng.normal(size=(n, 18)), state=state,
                 action=rng.normal(size=(n, 12)), vc_goals=np.tile(v_des, (n, 1)),
                 cc_goals=rng.normal(size=(n, 8)))
        return self.result_cls(sim=None, record_path="" if fell else path,
                               early_termination=fell)


def run_both(tmp_path, monkeypatch, pretrain):
    out = {}
    for name, mod, roll, spec in (("jax", jdg, jroll, jgo2()),
                                  ("port", tdg, troll, go2_spec(device="cpu"))):
        fake = FakeRollouts(roll.RolloutResult)
        if mod is jdg:
            monkeypatch.setattr(jdg, "rollout_mpc", fake)
        else:
            monkeypatch.setattr(troll, "rollout_mpc", fake)
        kw = dict(record_dir=str(tmp_path / name), sim_time_nominal=0.6, sim_time_perturbed=0.05,
                  replan_freq_steps=100, num_perturbations_per_replanning=2, max_retries=3,
                  seed=4)
        if pretrain:
            cfg = mod.PretrainConfig(n_goals=2, ood_threshold=4.0, **kw)
            dc = mod.PretrainDataCollection(spec, cfg)
        else:
            cfg = mod.DataCollectionConfig(**kw)
            dc = mod.DataCollection(spec, cfg)
        out[name] = (dc.run(), fake.log)
    return out


@pytest.mark.parametrize("pretrain", [False, True])
def test_collection_pipeline_as_jax(tmp_path, monkeypatch, pretrain):
    out = run_both(tmp_path, monkeypatch, pretrain)
    (jpath, jlog), (tpath, tlog) = out["jax"], out["port"]
    assert tlog == jlog and len(tlog) > 3
    assert any(c[5] is not None and np.linalg.norm(c[5][2]) > 66.0 for c in tlog)  # retried
    assert jpath.endswith("database_0.hdf5") and tpath.endswith("database_0.npz")
    assert os.path.exists(os.path.splitext(tpath)[0] + "_config.pkl")
    j = jdb.Database(limit=10**6)
    j.load_saved_database(jpath)
    t = Database(limit=10**6)
    t.load(tpath)
    assert len(t) == len(j) > 0
    o = t._order()
    np.testing.assert_array_equal(t.states_array(), j.states_array())
    np.testing.assert_array_equal(t.actions_array(), j.actions_array())
    np.testing.assert_array_equal(t.goals_array(), j.goals_array())
    np.testing.assert_array_equal(t.traj_ids[o], j.traj_ids[j._order()])
    np.testing.assert_array_equal(t.traj_times[o], j.traj_times[j._order()])
    np.testing.assert_array_equal(t.ood_array(), j.ood_array())
    if pretrain:
        assert t.ood_array().any() and not t.ood_array().all()


def test_snapshots_are_numbered(tmp_path, monkeypatch):
    monkeypatch.setattr(troll, "rollout_mpc", FakeRollouts(troll.RolloutResult))
    cfg = tdg.DataCollectionConfig(record_dir=str(tmp_path), sim_time_nominal=0.2,
                                   sim_time_perturbed=0.05, replan_freq_steps=100,
                                   num_perturbations_per_replanning=1)
    dc = tdg.DataCollection(go2_spec(device="cpu"), cfg)
    paths = [dc.save_training_dataset([p]) for p in [dc.run_unperturbed().record_path] * 2]
    assert [os.path.basename(p) for p in paths] == ["database_0.npz", "database_1.npz"]


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("failed to build kernel: nvcc exited with 1"),
])
def test_pretrain_lets_card_errors_through(tmp_path, monkeypatch, error):
    """A goal whose nominal rollout diverges is skipped, as in the JAX
    package; any other failure of the rollout (on the card: a CUDA error,
    out of memory, a kernel that did not build) propagates instead of
    shrinking the dataset."""
    fake = FakeRollouts(troll.RolloutResult)
    calls = {"n": 0}

    def rollout(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise SolverDiverged("solver diverged: cost nan")
        if kw.get("nominal_flag", True) and calls["n"] > 1:
            raise error
        return fake(*a, **kw)

    monkeypatch.setattr(troll, "rollout_mpc", rollout)
    cfg = tdg.PretrainConfig(record_dir=str(tmp_path), n_goals=3, sim_time_nominal=0.2,
                             sim_time_perturbed=0.05, replan_freq_steps=100,
                             num_perturbations_per_replanning=1)
    with pytest.raises(type(error), match=str(error).split(".")[0][:20]):
        tdg.PretrainDataCollection(go2_spec(device="cpu"), cfg).run()
    assert calls["n"] == 2              # the diverged goal was skipped, the error was not


def synth_rollouts(rec, rng):
    """The JAX tests/test_learning.py OOD case: a nominal and a perturbed
    rollout drifting far from it after half its rows."""
    n = 40
    t = np.arange(n) * 1e-3
    nom_states = rng.normal(size=(n, 44)) * 0.1
    pert_states = nom_states.copy()
    pert_states[n // 2:] += 10.0
    paths = []
    for name, states in (("nominal.npz", nom_states), ("perturbed.npz", pert_states)):
        p = os.path.join(rec, name)
        np.savez(p, state=states, action=rng.normal(size=(n, 12)),
                 vc_goals=np.tile([0.3, 0.0, 0.0], (n, 1)), cc_goals=rng.normal(size=(n, 3)),
                 time=t, q=np.zeros((n, 19)), v=np.zeros((n, 18)))
        paths.append(p)
    return paths


def test_save_training_dataset_with_ood_matches_jax(tmp_path):
    rec = str(tmp_path / "rec")
    os.makedirs(rec)
    nom, pert = synth_rollouts(rec, np.random.default_rng(0))
    groups = [(nom, [nom, pert])]
    jout = jdg.PretrainDataCollection(jgo2(), jdg.PretrainConfig(record_dir=rec)) \
        .save_training_dataset_with_ood(groups)
    tout = tdg.PretrainDataCollection(go2_spec(device="cpu"), tdg.PretrainConfig(
        record_dir=rec)).save_training_dataset_with_ood(groups)
    j = jdb.Database(limit=10_000)
    j.load_saved_database(jout)
    t = Database(limit=10_000)
    t.load(tout)
    np.testing.assert_array_equal(t.ood_array(), j.ood_array())
    np.testing.assert_array_equal(t.states_array(), j.states_array())
    ood = t.ood_array()
    assert len(t) == 80 and ood[:60].sum() == 0 and ood[60:].all()


def test_merge_npz_and_find_rollouts_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for i, n in enumerate((5, 7, 3)):
        keys = {"state": rng.normal(size=(n, 44)), "action": rng.normal(size=(n, 12)),
                "time": np.arange(n) * 1e-3, "extra": np.zeros(n)}
        if i != 1:
            keys["vc_goals"] = rng.normal(size=(n, 3))
        np.savez(tmp_path / f"traj_{i}.npz", **keys)
    np.savez(tmp_path / "other.npz", state=np.zeros((1, 44)))
    assert tdu.find_rollouts(str(tmp_path)) == jdu.find_rollouts(str(tmp_path))
    assert tdu.find_rollouts(str(tmp_path), "*.npz") == jdu.find_rollouts(str(tmp_path), "*.npz")
    paths = tdu.find_rollouts(str(tmp_path))
    t = np.load(tdu.merge_npz(paths, str(tmp_path / "t.npz")))
    j = np.load(jdu.merge_npz(paths, str(tmp_path / "j.npz")))
    assert sorted(t.files) == sorted(j.files) == ["action", "state", "time", "vc_goals"]
    for k in j.files:
        np.testing.assert_array_equal(t[k], j[k])


def test_download_dataset_raises_without_hub(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        tdu.download_dataset(local_dir="/nonexistent")


@pytest.mark.slow
def test_data_collection_run_matches_the_jax_golden(tmp_path, monkeypatch):
    """The real run: Go2 trot at 0.3 m/s, MPC rollouts in MuJoCo on the CPU,
    against the JAX run's force draws, replanning points, file names, row
    counts and the rows of the first 0.1 s of every rollout."""
    g = np.load(GOLDEN)
    draws = []
    sample = tdg.sample_force_perturbation

    def recorded(*a, **k):
        fw = sample(*a, **k)
        draws.append(np.r_[fw.start, fw.end, fw.force])
        return fw

    monkeypatch.setattr(tdg, "sample_force_perturbation", recorded)
    rec = str(tmp_path / "dc")
    cfg = tdg.DataCollectionConfig(record_dir=rec, sim_time_nominal=0.2, sim_time_perturbed=0.2,
                                   v_des=(0.3, 0.0, 0.0), replan_freq_steps=100,
                                   num_perturbations_per_replanning=1, seed=0)
    dc = tdg.DataCollection(go2_spec(device="cpu"), cfg, device="cpu")
    path = dc.run()
    np.testing.assert_array_equal(np.asarray(draws), g["dc_draws"])
    nominal = glob.glob(os.path.join(rec, "traj_nominal_*.npz"))[0]
    others = sorted(glob.glob(os.path.join(rec, "traj_[0-9]*.npz")))
    assert dc.get_replanning_points(nominal) == g["dc_points"].tolist()
    assert [os.path.basename(p) for p in others] == g["dc_files"].tolist()
    db = Database(limit=10**6)
    db.load(path)
    assert len(db) == int(g["dc_rows"])
    for i, p in enumerate([nominal] + others):
        d = np.load(p)
        early = d["time"] - d["time"][0] < 0.1
        for k, tol in ROW_TOL.items():
            ref = g[f"dc_{i}_{k}"]
            assert d[k].shape == ref.shape
            err = float(np.abs(d[k][early] - ref[early]).max())
            assert err <= tol, (i, k, err)
