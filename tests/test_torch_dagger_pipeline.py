"""The port's host-plant SafeDAgger (``learning/dagger.py``:
``SafeDaggerDataCollection``, ``SafeDaggerPipeline``) against the JAX
package's, on the CPU.

- ``SafeDaggerDataCollection.collect``: one combined-controller rollout in
  MuJoCo (the shipped policy, 0.15 m/s, 0.2 s, delay 20, latch 60) against
  the JAX run in ``tests/data/go2_learning_pipeline_golden.npz``: the same
  expert labels at every step, the same expert ratio, the aggregate of the
  expert rows written as ``agg_dataset.npz``, the rows of the first 0.1 s
  within the closed loops' tolerances.
- ``SafeDaggerPipeline.run`` with the rollouts and the trainer stood in for
  on both sides: the same tags, aggregation chain, "too small, skip
  training" decisions, warm starts and returned policy as the JAX loop.
- One real iteration of the port's pipeline (stand-in rollout rows, the
  port's trainer on the CPU): the new policy loads and serves.

~12 s of worker time (the combined rollout's MPC boot and first solve take
most of it); no JAX compile.
"""
import glob
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu.learning import dagger as jdag
from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy
from iterative_learning_nmpc_tpu_torch.learning import dagger as tdag
from iterative_learning_nmpc_tpu_torch.learning import rollouts as troll
from iterative_learning_nmpc_tpu_torch.learning.database import Database
from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, read_payload
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_learning_pipeline_golden.npz")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
ROW_TOL = {"q": 1e-4, "v": 1e-2, "state": 1e-2, "action": 5e-3}


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def test_collect_matches_the_jax_golden(g, tmp_path):
    cfg = tdag.SafeDaggerConfig(record_dir=str(tmp_path), sim_time=0.2, delay_steps=20,
                                mpc_min_steps=60)
    col = tdag.SafeDaggerDataCollection(go2_spec(device="cpu"), cfg, device="cpu")
    agg = col.collect(ARTIFACT, (0.15, 0.0, 0.0), None, "goal0_iter0")
    assert agg == os.path.join(str(tmp_path), "goal0_iter0", "agg_dataset.npz")
    (traj,) = glob.glob(os.path.join(str(tmp_path), "goal0_iter0", "traj_*.npz"))
    d = np.load(traj)
    np.testing.assert_array_equal(d["is_expert"], g["sd_is_expert"])
    assert col.expert_ratio_history == [float(g["sd_ratio"])]
    db = Database(limit=10**6)
    db.load(agg)
    assert len(db) == int(g["sd_agg_rows"]) == int(g["sd_is_expert"].sum()) > 0
    np.testing.assert_array_equal(db.states_array(), d["state"][d["is_expert"] > 0])
    early = d["time"] < 0.1
    for k, tol in ROW_TOL.items():
        err = float(np.abs(d[k][early] - g["sd_" + k][early]).max())
        assert err <= tol, (k, err)


class FakeCombined:
    """A stand-in for ``rollout_combined`` shared by both packages: 200
    recorder rows whose expert share grows with each call."""

    def __init__(self, result_cls):
        self.result_cls, self.calls = result_cls, []

    def __call__(self, spec, policy_path, sim_time=10.0, v_des=np.zeros(3), record_dir="",
                 delay_steps=100, mpc_min_steps=2500, **_):
        self.calls.append((os.path.basename(policy_path), tuple(np.asarray(v_des, float)),
                           os.path.basename(record_dir), sim_time, delay_steps, mpc_min_steps))
        n, k = 200, len(self.calls)
        rng = np.random.default_rng(k)
        exp = np.zeros(n, int)
        exp[50:50 + 25 * k] = 1
        rec = SimpleNamespace(data=dict(
            state=rng.normal(size=(n, 44)), action=rng.normal(size=(n, 12)),
            vc_goals=np.tile(v_des, (n, 1)), cc_goals=rng.normal(size=(n, 8)),
            time=np.arange(n) * 1e-3, is_expert=exp))
        return self.result_cls(sim=None, record_path="", early_termination=False, recorder=rec)


class FakeBC:
    """A stand-in for the trainer: logs what it was given, returns the path
    the real trainer returns."""

    log = []

    def __init__(self, cfg, device=None):
        self.cfg = cfg

    def run(self, db, warm_start_path=None, **_):
        c = self.cfg
        FakeBC.log.append((c.run_name, len(db), os.path.basename(warm_start_path),
                           c.batch_size, c.n_epochs, c.learning_rate, c.seed))
        return os.path.join(c.save_dir, f"policy_{c.run_name}_final.pkl")


def test_pipeline_flow_as_jax(tmp_path, monkeypatch):
    from iterative_learning_nmpc_tpu.learning import rollouts as jroll
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jgo2

    out = {}
    for name, mod, spec in (("jax", jdag, jgo2()), ("port", tdag, go2_spec(device="cpu"))):
        fake = FakeCombined((jroll if mod is jdag else troll).RolloutResult)
        if mod is jdag:
            monkeypatch.setattr(jdag, "rollout_combined", fake)
        else:
            monkeypatch.setattr(troll, "rollout_combined", fake)
        FakeBC.log = []
        monkeypatch.setattr(mod, "BehavioralCloning", FakeBC)
        cfg = mod.SafeDaggerConfig(record_dir=str(tmp_path / name), sim_time=0.2,
                                   goals=((0.15, 0, 0), (0.0, 0, 0)), n_iterations_per_goal=2,
                                   batch_size=60, delay_steps=20, mpc_min_steps=60)
        kw = dict(device="cpu") if mod is tdag else {}
        pipe = mod.SafeDaggerPipeline(spec, cfg, ARTIFACT, **kw)
        final = pipe.run()
        out[name] = dict(final=os.path.relpath(final, str(tmp_path / name))
                         if final != ARTIFACT else final,
                         ratios=pipe.collector.expert_ratio_history, calls=fake.calls,
                         bc=list(FakeBC.log),
                         dataset=os.path.relpath(pipe.dataset_path, str(tmp_path / name)))
    jo, to = out["jax"], out["port"]
    assert to["calls"] == jo["calls"] and len(to["calls"]) == 4
    assert to["ratios"] == jo["ratios"]
    # iteration 0 of goal 0 aggregates 25 rows (< batch 60): no training
    assert to["bc"] == jo["bc"] and [b[0] for b in to["bc"]] == [
        "goal0_iter1", "goal1_iter0", "goal1_iter1"]
    assert to["final"] == jo["final"] == os.path.join("policies", "policy_goal1_iter1_final.pkl")
    assert to["dataset"] == os.path.join("goal1_iter1", "agg_dataset.npz")
    assert jo["dataset"] == os.path.join("goal1_iter1", "agg_dataset.hdf5")


def test_one_real_iteration_trains_and_serves(tmp_path, monkeypatch):
    monkeypatch.setattr(troll, "rollout_combined", FakeCombined(troll.RolloutResult))
    cfg = tdag.SafeDaggerConfig(record_dir=str(tmp_path), sim_time=0.2, goals=((0.15, 0, 0),),
                                n_iterations_per_goal=1, batch_size=16, n_epochs=1)
    # an initial dataset to aggregate onto
    init = Database(limit=1000)
    rng = np.random.default_rng(0)
    init.append(rng.normal(size=(40, 44)), rng.normal(size=(40, 12)),
                vc_goals=np.tile([0.15, 0, 0], (40, 1)))
    init_path = init.save_as_npz(str(tmp_path / "init.npz"))
    pipe = tdag.SafeDaggerPipeline(go2_spec(device="cpu"), cfg, ARTIFACT,
                                   initial_dataset=init_path, device="cpu")
    final = pipe.run()
    assert final == os.path.join(str(tmp_path), "policies", "policy_goal0_iter0_final.pkl")
    db = Database(limit=1000)
    db.load(pipe.dataset_path)
    assert len(db) == 40 + 25
    served = ServedPolicy(*policy_from_numpy(read_payload(final), device="cpu"), device="cpu")
    x = torch.zeros(3, 44)
    act, tau = served(x, torch.zeros(3, 3), torch.zeros(3, 12), torch.zeros(3, 12), 20.0, 1.5)
    assert act.shape == (3, 12) and bool(torch.isfinite(act).all())
