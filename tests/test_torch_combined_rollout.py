"""The port's SafeDAgger rollout (``learning/rollouts.rollout_combined``:
``CombinedController`` over ``PolicyController`` and ``LocomotionMPC`` in the
host MuJoCo plant) against the JAX package's run, on the CPU.

Go2 trot, the shipped policy (``assets/policy_go2_trot_ondevice_dagger.pkl``),
0.3 m/s, ``delay_steps`` 100, ``mpc_min_steps`` 200, monitor v2, 0.2 s,
against ``tests/data/go2_host_loop_golden.npz``
(``scripts/make_torch_host_loop_golden.py``): the MPC's boot offset and
first plan within rel|dU| <= 1e-3 (both controllers run from the first
step), the recorder rows of the first 40 steps (the policy drives them:
its actions are within 1e-4 of JAX's) and ``is_expert`` / ``mode_log`` over
all 200 steps: the velocity-tracking monitor hands over to the expert at
step 99, as in the JAX run. No JAX controller is built; ~7 s of worker
time.
"""
import os

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.learning import rollouts as troll
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from test_torch_rollouts import GOLDEN, REL_GATE, check_rows, recording_mpc, rel

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_rollout_combined_matches_golden(golden, tmp_path, monkeypatch):
    seen = {}

    class Combined(troll.CombinedController):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["c"] = self

    monkeypatch.setattr(troll, "LocomotionMPC", recording_mpc(troll))
    monkeypatch.setattr(troll, "CombinedController", Combined)
    res = troll.rollout_combined(
        go2_spec(device="cpu"), ARTIFACT, sim_time=0.2,
        v_des=np.array([float(golden["roll_v"]), 0.0, 0.0]), record_dir=str(tmp_path),
        delay_steps=int(golden["delay_steps"]), mpc_min_steps=int(golden["mpc_min_steps"]),
        device="cpu")
    first = troll.LocomotionMPC.first
    assert first["boot_offset"] == int(golden["comb_boot_offset"])
    du = rel(first["U"], golden["comb_U"])
    assert du <= REL_GATE, du
    assert res.sim.n_steps == 200 and not res.sim.fell
    d, g = check_rows(res.recorder, golden, "comb")
    np.testing.assert_array_equal(d["is_expert"], g["is_expert"])
    np.testing.assert_array_equal(np.asarray(seen["c"].mode_log), golden["comb_mode_log"])
    assert int(np.argmax(golden["comb_mode_log"])) == 99
    assert os.path.exists(res.record_path)
