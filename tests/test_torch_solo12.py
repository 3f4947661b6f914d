"""The port's controller on the second robot, Solo12, against the JAX
package's, on the CPU, through ``tests/data/solo12_trot_golden.npz``
(``scripts/make_torch_controller_modes_golden.py``: JAX's
``LocomotionMPC(solo12_spec())``, trot, sync mode, phase-aligned cold boot,
0.2 m/s, from the standing state). No JAX controller is compiled here.

The boot's probe costs agree loosely (three GN iterations from a cold
start in fp32), and it picks the golden's offset. Solo12 is mirror-
symmetric (its trunk CoM is on the axis), so offsets half a cycle apart
swap the diagonal pairs of a mirror-image problem and tie up to rounding
(369.7854 and 369.7856 in the golden): the tie's other offset is accepted
when the two costs are within 1e-5 of each other. The first plan (15
iterations) is within the bench's rel |dU| / (1 + |U|) gate of 1e-3.
~9 s of worker time.
"""
import numpy as np
import torch

from iterative_learning_nmpc_tpu_torch.mpc import controller as controller_module
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec

torch.set_num_threads(1)
GATE = 1.0e-3
GOLDEN = "tests/data/solo12_trot_golden.npz"


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def test_solo12_boot_and_first_plan_match_jax(monkeypatch):
    g = np.load(GOLDEN)
    mpc = LocomotionMPC(solo12_spec(device="cpu"), gait_name="trot", solve_async=False,
                        device="cpu")
    assert (mpc.Kp, mpc.Kd, mpc.config_gait.nom_height) == (6.0, 0.3, 0.22)
    seen = {}
    boot = controller_module.merit_phase_boot
    monkeypatch.setattr(controller_module, "merit_phase_boot",
                        lambda *a, **k: seen.setdefault("boot", boot(*a, **k)))
    mpc.set_command(g["v_des"])
    q_plan, _, _, _, tau_ff = mpc.optimize(g["q0"], g["v0"])
    mpc.close()
    costs, ref = seen["boot"][2].numpy(), g["probe_costs"]
    np.testing.assert_allclose(costs, ref, rtol=1e-2)
    off, gold = mpc.boot_offsets[0], int(g["boot_offset"])
    C = len(costs)
    assert off == gold or (off == (gold + C // 2) % C
                           and abs(costs[off] - costs[gold]) <= 1e-5 * costs[gold])
    if off != gold:
        # the tie's other offset: the plan at the golden's offset, unbooted
        mpc = LocomotionMPC(mpc.spec, gait_name="trot", solve_async=False,
                            phase_aligned_boot=False, device="cpu")
        mpc.set_command(g["v_des"])
        mpc.current_opt_node = gold
        q_plan, _, _, _, tau_ff = mpc.optimize(g["q0"], g["v0"])
        mpc.close()
    assert rel(mpc._U_prev[0].numpy(), g["U"]) <= GATE
    assert rel(q_plan, g["q_plan"]) <= GATE and rel(tau_ff, g["tau_ff"]) <= GATE
