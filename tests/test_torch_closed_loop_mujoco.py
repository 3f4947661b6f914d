"""Go2's push recovery and turning with the port's ``LocomotionMPC`` in the
port's host MuJoCo plant (``sim/mujoco_sim.Simulator``), on the CPU: the
scenarios and gates of the JAX package's ``tests/test_closed_loop.py:33-59``.

- push: zero command, 40 N in x and 20 N in y on the trunk over 0.7-0.9 s,
  1.6 s: no fall, base height in (0.2, 0.4) m;
- turning: 0.2 m/s with ``w_yaw`` 0.4, 2.0 s: no fall, the final yaw
  past 0.4 rad, |pitch| and |roll| under 0.3 rad.

Marked slow, as their JAX twins are: the port's controller replans 40-50
times on the CPU (a cold boot of ~7 s, then ~0.26 s an RTI replan), ~19 s
and ~21 s a loop, past the ~15 s a tier-1 file may take.
"""
import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.sim.mujoco_sim import ForceWindow, Simulator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def spec():
    return go2_spec(device="cpu")


@pytest.mark.slow
def test_go2_trot_survives_push(spec):
    sim = Simulator(spec)
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, device="cpu")
    mpc.set_command(np.array([0.0, 0.0, 0.0]))
    push = [ForceWindow(start=0.7, end=0.9, force=np.array([40.0, 20.0, 0.0]))]
    res = sim.run(sim_time=1.6, controller=mpc, force_schedule=push)
    mpc.close()
    assert not res.fell, f"robot fell after push: {res}"
    assert 0.2 < sim.data.qpos[2] < 0.4


@pytest.mark.slow
def test_go2_trot_turning(spec):
    sim = Simulator(spec)
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, device="cpu")
    mpc.set_command(np.array([0.2, 0.0, 0.0]), w_yaw=0.4)
    res = sim.run(sim_time=2.0, controller=mpc)
    mpc.close()
    assert not res.fell
    ypr = tnp.matrix_to_ypr(tnp.quat_wxyz_to_matrix(sim.data.qpos[3:7]))
    assert ypr[0] > 0.4, ypr
    assert abs(ypr[1]) < 0.3 and abs(ypr[2]) < 0.3
