"""The port's ``run_dagger`` and ``collect_plant_batch`` CLIs
(``iterative_learning_nmpc_tpu_torch/examples/``), in-process on the CPU
with tiny budgets: ``run_dagger`` (the shipped policy, 0.03 s, one
iteration: the policy keeps control through the delay, so no expert row,
no aggregate and no training) and ``collect_plant_batch`` (one env, 0.03 s:
30 expert rows, the rows' npz and the ``database_plant.npz`` snapshot);
each ends with the ``launches`` line ``run_mpc`` prints. ~8 s of worker
time (one combined rollout in MuJoCo, one cold plan at B=1); no JAX.
"""
import os

import numpy as np
import torch

from iterative_learning_nmpc_tpu_torch.examples import collect_plant_batch, run_dagger
from iterative_learning_nmpc_tpu_torch.learning.database import Database

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")


def test_run_dagger(tmp_path, capsys):
    rec = str(tmp_path / "dagger")
    assert run_dagger.main(["--policy", ARTIFACT, "--device", "cpu", "--record_dir", rec,
                            "--sim_time", "0.03", "--iters", "1", "--goals", "0.15,0,0",
                            "--epochs", "1"]) == 0
    out = capsys.readouterr().out
    # the policy keeps control through the 100-step delay: no expert row,
    # no aggregate, no training
    assert f"final policy: {ARTIFACT}" in out and "no expert rows collected" in out
    assert not os.path.exists(os.path.join(rec, "goal0_iter0", "agg_dataset.npz"))
    assert os.path.exists(os.path.join(rec, "config.yaml")) and "launches: " in out


def test_collect_plant_batch(tmp_path, capsys):
    pb = str(tmp_path / "plant")
    assert collect_plant_batch.main(["--device", "cpu", "--out", pb, "--n_envs", "1",
                                     "--sim_time", "0.03", "--n_pushes", "0"]) == 0
    out = capsys.readouterr().out
    rows = np.load(os.path.join(pb, "plant_rows.npz"))
    assert rows["state"].shape == (30, 44) and rows["is_expert"].all()
    db = Database(limit=1000)
    db.load(os.path.join(pb, "database_plant.npz"))
    assert len(db) == 30 and "env-sim-s/s" in out and "launches: " in out
