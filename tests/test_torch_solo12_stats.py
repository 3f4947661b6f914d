"""Solo12's replan cost in the port: the SQP and inner AL iteration counts
of a replan against the JAX package's, on the CPU.

``LocomotionMPC(solo12_spec())`` (sync, phase-aligned boot) from the state
of ``tests/data/solo12_trot_golden.npz``: the cold first solve, then an RTI
replan from the same state. Their ``SolveStats.sqp_iters`` and ``qp_iters``
equal the JAX package's (``tests/data/go2_host_loop_golden.npz``,
``scripts/make_torch_host_loop_golden.py``: 6 and 1, then 1 and 1), and
the costs agree within 1e-3 relative. So a Solo12 replan runs the same
iterations as the reference and its 2-3x Go2's wall on the card is speed,
not extra work. ~7 s of worker time (the port's cold boot on the CPU).
"""
import os

import numpy as np
import torch

from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def test_solo12_replan_iterations_match_jax():
    golden = np.load(os.path.join(DATA, "go2_host_loop_golden.npz"))
    g = np.load(os.path.join(DATA, "solo12_trot_golden.npz"))
    mpc = LocomotionMPC(solo12_spec(device="cpu"), gait_name="trot", solve_async=False,
                        device="cpu")
    stats, plan = [], mpc._plan

    def recording(*a):
        out = plan(*a)
        stats.append(out[0].stats)
        return out

    mpc._plan = recording
    mpc.set_command(g["v_des"])
    mpc.optimize(g["q0"], g["v0"])
    mpc.first_solve = False
    mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    sqp = np.array([int(s.sqp_iters[0]) for s in stats])
    qp = np.array([int(s.qp_iters[0]) for s in stats])
    cost = np.array([float(s.cost[0]) for s in stats])
    np.testing.assert_array_equal(sqp, golden["solo12_sqp_iters"])
    np.testing.assert_array_equal(qp, golden["solo12_qp_iters"])
    np.testing.assert_allclose(cost, golden["solo12_cost"], rtol=1e-3)
    assert sqp[0] < mpc.config_opt.max_iter_first      # stopped at nlp_tol
