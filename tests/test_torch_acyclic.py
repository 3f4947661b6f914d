"""The port's ``AcyclicMPC`` against the JAX package's, on the CPU, through
``tests/data/go2_acyclic_golden.npz`` (``scripts/make_torch_controller_modes_golden.py``,
JAX on the CPU), with the gates of the JAX package's
tests/test_gait_and_variants.py:

- 6 cm square patches at the standing footholds under the trot's contact
  sequence, 15 first-solve iterations, 0.2 m/s: what the plant consumes
  before the next replan (the first node's inputs and the first 40 ms of
  the interpolated plan) within the bench's rel |dU| / (1 + |U|) gate of
  1e-3, the whole horizon within 1e-2 (below: the solve stops on a short
  line-search step, and its tail moves by the fp32 rounding of its input),
  the stance feet inside the patch radius (3 cm) + 3 mm, the base between
  0.18 and 0.42 m;
- the standing hop (nodes 10..13 all flight, 30 first-solve iterations):
  the plan within the gate, flight forces exactly 0, an apex more than
  5 cm above the start, an upward takeoff velocity above 0.2 m/s.

~9 s of worker time (45 SQP iterations of one problem).
"""
import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.models import dynamics as dyn
from iterative_learning_nmpc_tpu_torch.mpc.acyclic import AcyclicMPC
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

torch.set_num_threads(1)
GATE = 1.0e-3
GOLDEN = "tests/data/go2_acyclic_golden.npz"


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def spec():
    return go2_spec(device="cpu")


def test_patch_plan_matches_jax(spec, golden):
    g = golden
    mpc = AcyclicMPC(spec, gait_name="trot", n_sqp_first=15, solve_async=False,
                     compute_timings=False, device="cpu")
    assert mpc.config_opt.max_iter_first == 15 and mpc.restrict_cnt
    N = mpc.config_opt.n_nodes
    mpc.set_contact_sequence(g["seq"])
    mpc.set_patches(g["centers"], np.zeros(g["seq"].shape, np.float32), g["sizes"])
    mpc.set_command(np.array([0.2, 0.0, 0.0]), 0.0)
    plan = mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    X, U = mpc._X_prev[0], mpc._U_prev[0]
    # the consumed part: measured 1.3e-4 (U, node 0). The whole horizon:
    # measured 3.5e-3 at node 24; the port's own plan moves by 2.1e-3 when
    # the start height moves by 1e-7 m (a few fp32 ulps), as the solve stops
    # after 11 iterations on a step of alpha 0.1
    assert rel(U[0].numpy(), g["U_patch"][0]) <= GATE
    steps = mpc.replanning_steps
    for k, ref in ((0, g["q_plan"]), (4, g["tau_ff"])):
        assert rel(plan[k][:steps], ref[:steps]) <= GATE, k
    assert rel(U.numpy(), g["U_patch"]) <= 1e-2
    q_plan = plan[0]
    assert q_plan.shape[1] == 18 and np.isfinite(q_plan).all()
    feet = dyn.foot_positions(spec, X[:, :18]).numpy()[:, :, :2]
    cnt = mpc.acyclic_planner.get_sequence(0, N + 1).T
    p_feet = g["centers"][:, 0, :2]
    dist = np.linalg.norm(feet - p_feet[None], axis=2) * cnt
    assert dist.max() < 0.03 + 3e-3, dist.max()
    assert np.all(q_plan[:, 2] > 0.18) and np.all(q_plan[:, 2] < 0.42)


def test_hop_plan_matches_jax(spec, golden):
    g = golden
    mpc = AcyclicMPC(spec, gait_name="trot", n_sqp_first=30, solve_async=False,
                     device="cpu")
    N = mpc.config_opt.n_nodes
    mpc.set_contact_sequence(g["hop_cnt"])
    mpc.set_command(np.array([0.0, 0.0, 0.0]), 0.0)
    mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    X, U = mpc._X_prev[0].numpy(), mpc._U_prev[0].numpy()
    assert rel(U, g["U_hop"]) <= GATE
    F = U[:, 18:].reshape(N, 4, 3)
    assert np.abs(F[10:14]).max() == 0.0
    assert X[:, 2].max() > X[0, 2] + 0.05
    assert X[11, 20] > 0.2
