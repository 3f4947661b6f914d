"""Learner/expert switching controller with a runtime safety monitor
(SafeDAgger).

Counterpart of ``iterative_learning_nmpc_tpu/learning/combined_controller.py``
(the reference's ``DAgger/utils/Rollout_combined_controller.py``):

- both the policy and the MPC compute every step, so the expert's plan
  stays warm;
- the monitors: "v1" (fall and stall), "v2" (``learning/safety.
  check_unsafe_state_v2``: roll/pitch, height, the per-joint bounds,
  velocity tracking) and "dummy" (the expert after 2 s of sim time);
- the hysteresis latch (``SwitchLatch``): the policy alone for the first
  ``delay_steps``, the MPC latched for at least ``mpc_min_steps`` once
  engaged;
- ``mpc_active`` / ``mode_log`` record which controller drove each step,
  for expert relabeling.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..models import transforms_np as tnp
from .safety import check_unsafe_state_v2


class SwitchLatch:
    """The SafeDAgger hysteresis switch of one environment (the reference's
    ``set_current_control_mode``, ``Rollout_combined_controller.py:449-482``):
    "policy" for the first ``delay_steps`` updates; then the monitor hands
    control to "mpc", which keeps it for at least ``mpc_min_steps`` updates
    and until the monitor reads safe. The monitor is called only where its
    reading decides the mode."""

    def __init__(self, delay_steps: int = 100, mpc_min_steps: int = 2500):
        self.delay_steps = delay_steps
        self.mpc_min_steps = mpc_min_steps
        self.reset()

    def reset(self) -> None:
        self.mode = "policy"
        self.step_counter = 0
        self.mpc_active_counter = 0

    def update(self, unsafe: Callable[[], bool]) -> str:
        """One control step; returns the mode that drives it."""
        self.step_counter += 1
        if self.step_counter < self.delay_steps:
            self.mode = "policy"
        elif self.mode == "mpc":
            self.mpc_active_counter += 1
            if self.mpc_active_counter >= self.mpc_min_steps and not unsafe():
                self.mode = "policy"
                self.mpc_active_counter = 0
        elif unsafe():
            self.mode = "mpc"
            self.mpc_active_counter = 0
        return self.mode


class CombinedController:
    def __init__(
        self,
        simulator,
        mpc_controller,
        policy_controller,
        v_des: np.ndarray = np.zeros(3),
        delay_steps: int = 100,
        mpc_min_steps: int = 2500,
        monitor: str = "v2",
    ):
        """mpc_controller: a ``mpc/controller.LocomotionMPC``;
        policy_controller: a ``PolicyController``; simulator: what they
        share (its ``spec``)."""
        self.sim = simulator
        self.mpc_controller = mpc_controller
        self.policy_controller = policy_controller
        self.v_des = np.asarray(v_des, dtype=np.float64)
        # both sub-controllers track the goal; without it the latched expert
        # tracks a zero command and stands
        mpc_controller.set_command(self.v_des)
        policy_controller.set_command(self.v_des)
        self.latch = SwitchLatch(delay_steps, mpc_min_steps)
        self.monitor = monitor

        self.mpc_active = False
        self.policy_active = True
        self.torques_dof = np.zeros(simulator.spec.nv)
        self.diverged = False
        self.mode_log = []

    @property
    def delay_steps(self) -> int:
        return self.latch.delay_steps

    @property
    def mpc_min_steps(self) -> int:
        return self.latch.mpc_min_steps

    @property
    def control_mode(self) -> str:
        return self.latch.mode

    @property
    def step_counter(self) -> int:
        return self.latch.step_counter

    @property
    def mpc_active_counter(self) -> int:
        return self.latch.mpc_active_counter

    def set_command(self, v_des, w_yaw: float = 0.0):
        self.v_des = np.asarray(v_des, dtype=np.float64)
        self.mpc_controller.set_command(self.v_des, w_yaw)
        self.policy_controller.set_command(self.v_des, w_yaw)

    # ------------------------------------------------------------------
    def check_unsafe_state_v1(self, mj_data) -> bool:
        """Fall/stall monitor (`Rollout_combined_controller.py:306-357`)."""
        q = np.asarray(mj_data.qpos)
        v = np.asarray(mj_data.qvel)
        ypr = tnp.matrix_to_ypr(tnp.quat_wxyz_to_matrix(q[3:7]))
        roll, pitch = ypr[2], ypr[1]
        unsafe_pose = (
            abs(roll) > np.deg2rad(30)
            or abs(pitch) > np.deg2rad(10)
            or q[2] < 0.18
            or q[2] > 0.45
            or np.linalg.norm(v[3:6]) > 5.0
        )
        stall = abs(self.v_des[0]) > 0.05 and abs(v[0]) < 0.015
        return bool(unsafe_pose or stall)

    def check_unsafe_state_v2(self, mj_data) -> bool:
        """Pose + joint-limit + velocity-tracking monitor (`:367-446`)."""
        return check_unsafe_state_v2(np.asarray(mj_data.qpos), np.asarray(mj_data.qvel),
                                     self.v_des)

    def _unsafe(self, mj_data) -> bool:
        if self.monitor == "v1":
            return self.check_unsafe_state_v1(mj_data)
        if self.monitor == "dummy":
            # the expert after 2 s of sim time: exercises the switch and the
            # relabeling deterministically
            return mj_data.time > 2.0
        return self.check_unsafe_state_v2(mj_data)

    # ------------------------------------------------------------------
    def set_current_control_mode(self, mj_data) -> None:
        self.latch.update(lambda: self._unsafe(mj_data))

    def compute_torques_dof(self, mj_data) -> None:
        # both controllers run every step; the MPC plan stays warm
        self.policy_controller.compute_torques_dof(mj_data)
        self.mpc_controller.compute_torques_dof(mj_data)
        self.set_current_control_mode(mj_data)
        self.mpc_active = self.control_mode == "mpc"
        self.policy_active = not self.mpc_active
        active = self.mpc_controller if self.mpc_active else self.policy_controller
        self.torques_dof = np.asarray(active.torques_dof).copy()
        self.mode_log.append(self.mpc_active)
        self.diverged = self.mpc_controller.diverged
