"""Learned-policy and replay controllers for a plant that calls
``compute_torques_dof(data)`` each step (``sim/mujoco_sim.Simulator``).

Counterpart of ``iterative_learning_nmpc_tpu/learning/policy_controller.py``:

- PolicyController: per step, the 44-dim state from the plant (the feet
  from the simulator's ``data.geom_xpos``), normalised on the host in
  float64 as the JAX controller does (columns 1: of the state, the
  velocity goal appended: 47 inputs), one forward pass of the network
  served by ``learning/network.ServedPolicy`` on its device (kernel 8 at
  B=1 on the card, where the route is "kernel"), then joint PD toward the
  predicted targets on the host in float64:
      tau = kp (a - q_joints) - kd v_joints
  The network's action is the only thing taken from the device, so the
  plant sees the torques the JAX controller would form from that action.
- ReplayController: open-loop replay of recorded PD-target or raw-torque
  sequences.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..interop import policy_from_numpy
from .network import ServedPolicy, read_payload
from .recorder import assemble_state, get_phase_percentage


class PolicyController:
    def __init__(
        self,
        simulator,
        policy_path: str,
        v_des: np.ndarray = np.zeros(3),
        kp: float = 20.0,
        kd: float = 1.5,
        gait_period: float = 0.5,
        use_phase: bool = False,
        device=None,
    ):
        """simulator: anything with ``spec``, ``foot_geoms`` (the foot geom
        ids, FL, FR, RL, RR) and ``data.geom_xpos``. v_des routes a
        goal-scheduled bundle to the nearest-goal member once, at
        construction. device: where the network runs, by default the CUDA
        card."""
        self.sim = simulator
        self.device = resolve_device(device)
        net, norm = policy_from_numpy(read_payload(policy_path, v_des=v_des), device=self.device)
        self.served = ServedPolicy(net, norm, device=self.device)
        if norm is not None:
            mu_s, sd_s, mu_g, sd_g = (t.cpu().numpy() for t in norm)
            self.state_mean = mu_s
            self.state_std = np.where(sd_s > 1e-8, sd_s, 1.0)
            self.goal_mean, self.goal_std = mu_g, sd_g
        else:
            self.state_mean = None
        self.v_des = np.asarray(v_des, dtype=np.float64)
        self.kp, self.kd = kp, kd
        self.gait_period = gait_period
        self.use_phase = use_phase
        self.nu = simulator.spec.nu
        self.torques_dof = np.zeros(simulator.spec.nv)
        self.diverged = False
        self.last_action = np.zeros(self.nu)
        self.inference_ms = []
        # the first call builds the kernel; keep it out of the control steps
        self._forward(np.zeros(self.served.layers[0][0].shape[0], np.float32),
                      np.zeros(self.nu), np.zeros(self.nu))

    def set_command(self, v_des, w_yaw: float = 0.0):
        self.v_des = np.asarray(v_des, dtype=np.float64)

    def policy_input(self, mj_data) -> np.ndarray:
        """The network's (47,) float32 input: the normalised state and goal."""
        q = np.asarray(mj_data.qpos)
        v = np.asarray(mj_data.qvel)
        feet_pos = np.array([self.sim.data.geom_xpos[g] for g in self.sim.foot_geoms])
        phase = get_phase_percentage(mj_data.time, self.gait_period, self.use_phase)
        state = assemble_state(q, v, feet_pos, phase)
        if self.state_mean is not None:
            state[1:] = (state[1:] - self.state_mean[1:]) / self.state_std[1:]
        goal = (self.v_des - self.goal_mean) / self.goal_std if self.state_mean is not None else self.v_des
        return np.concatenate([state, goal]).astype(np.float32)

    def _forward(self, x: np.ndarray, q_j: np.ndarray, v_j: np.ndarray) -> np.ndarray:
        """One served forward pass at B=1: the inputs cross to the device in
        one copy, the action comes back in one."""
        n = len(x)
        xs = torch.as_tensor(np.concatenate([x, q_j, v_j]).astype(np.float32)[None]).to(self.device)
        act, _ = self.served.serve(xs[:, :n], xs[:, n:n + self.nu], xs[:, n + self.nu:],
                                   self.kp, self.kd)
        return act[0].cpu().numpy()

    def compute_torques_dof(self, mj_data) -> None:
        x = self.policy_input(mj_data)
        q_j = np.asarray(mj_data.qpos)[7:]
        v_j = np.asarray(mj_data.qvel)[6:]
        t0 = time.perf_counter()
        a = self._forward(x, q_j, v_j)
        self.inference_ms.append((time.perf_counter() - t0) * 1e3)
        self.last_action = a
        tau = self.kp * (a - q_j) - self.kd * v_j
        self.torques_dof[-self.nu:] = tau


class ReplayController:
    """Open-loop replay of a recorded trajectory (PD-target or torque mode)."""

    def __init__(
        self,
        simulator,
        actions: np.ndarray,
        mode: str = "pd_target",
        kp: float = 20.0,
        kd: float = 1.5,
    ):
        assert mode in ("pd_target", "torque")
        self.sim = simulator
        self.actions = np.asarray(actions)
        self.mode = mode
        self.kp, self.kd = kp, kd
        self.nu = simulator.spec.nu
        self.torques_dof = np.zeros(simulator.spec.nv)
        self.diverged = False
        self.step = 0

    def compute_torques_dof(self, mj_data) -> None:
        k = min(self.step, len(self.actions) - 1)
        a = self.actions[k]
        if self.mode == "pd_target":
            q_j = np.asarray(mj_data.qpos)[7:]
            v_j = np.asarray(mj_data.qvel)[6:]
            tau = self.kp * (a - q_j) - self.kd * v_j
        else:
            tau = a
        self.torques_dof[-self.nu:] = tau
        self.step += 1
