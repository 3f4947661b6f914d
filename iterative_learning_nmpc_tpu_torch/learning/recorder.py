"""Per-step rollout recorder producing the dataset contract.

Counterpart of ``iterative_learning_nmpc_tpu/learning/recorder.py`` (the
reference's ``StateDataRecorder``, ``Behavior_Cloning/utils/Rollout_MPC.py:131-307``):
the same keys, rows and npz file names. Per-step npz rows with keys
{time, q, v, ctrl, feet_pos_w, base_wrt_feet, state, action, vc_goals,
cc_goals, contact_vec, is_expert}, where

  state(44) = [phase(1), qvel(18), qpos[2:](17), base_wrt_feet(8)]
  action(12) = (tau + kd * v_joints) / kp + q_joints   (realized PD target)

As in the JAX package, the generated MJCF's actuators are already in
FL,FR,RL,RR order, so the reference's FR/FL/RR/RL reorder dance
(`Rollout_MPC.py:279-284`) is unnecessary — the recorded `ctrl` and `action`
are both in FL,FR,RL,RR order.
"""
from __future__ import annotations

import os
import time as _time

import numpy as np

from ..sim.mujoco_sim import DataRecorder, Simulator


def get_phase_percentage(t: float, period: float, enabled: bool = False) -> float:
    """Gait-phase in [0, 1). The reference currently hard-disables this to 0
    in the policy paths (`RolloutPolicy.py:89-97`); keep the same default."""
    if not enabled:
        return 0.0
    return (t % period) / period


def assemble_state(q_mj: np.ndarray, v_mj: np.ndarray, feet_pos_w: np.ndarray,
                   phase: float = 0.0) -> np.ndarray:
    """The 44-dim policy state (`Rollout_MPC.py:270-275`)."""
    base_wrt_feet = np.zeros(8)
    for i in range(4):
        base_wrt_feet[2 * i: 2 * i + 2] = (q_mj[:3] - feet_pos_w[i])[:2]
    return np.concatenate([[phase], v_mj, q_mj[2:], base_wrt_feet])


class StateDataRecorder(DataRecorder):
    def __init__(
        self,
        simulator: Simulator,
        record_dir: str = "",
        record_step: int = 1,
        v_des: np.ndarray = np.zeros(3),
        current_time: float = 0.0,
        nominal_flag: bool = True,
        replanning_point: int = 0,
        nth_traj_per_replanning: int = 0,
        kp: float = 20.0,
        kd: float = 1.5,
        gait_period: float = 0.5,
        use_phase: bool = False,
    ):
        super().__init__(record_dir, record_step)
        self.sim = simulator
        self.kp = kp
        self.kd = kd
        self.vc_goals = np.asarray(v_des, dtype=np.float64)
        self.current_time = current_time
        self.nominal_flag = nominal_flag
        self.replanning_point = replanning_point
        self.nth_traj_per_replanning = nth_traj_per_replanning
        self.gait_period = gait_period
        self.use_phase = use_phase
        self._rng = np.random.default_rng(0)
        self.reset()

    def reset(self) -> None:
        self.data = {
            k: []
            for k in (
                "time", "q", "v", "ctrl", "feet_pos_w", "base_wrt_feet",
                "state", "action", "vc_goals", "cc_goals", "contact_vec",
                "is_expert",
            )
        }

    def record(self, mj_data, is_expert: bool = True) -> None:
        q = np.asarray(mj_data.qpos).copy()
        v = np.asarray(mj_data.qvel).copy()
        ctrl = np.asarray(mj_data.ctrl).copy()
        t = round(mj_data.time + self.current_time, 4)

        feet_pos = np.array(
            [self.sim.data.geom_xpos[gid] for gid in self.sim.foot_geoms]
        )
        in_contact = self.sim.feet_in_contact()
        contact_vec = np.array(
            [int(leg in in_contact) for leg in ("FL", "FR", "RL", "RR")]
        )
        phase = get_phase_percentage(t, self.gait_period, self.use_phase)
        state = assemble_state(q, v, feet_pos, phase)
        action = (ctrl + self.kd * v[6:]) / self.kp + q[7:]

        self.data["time"].append(t)
        self.data["q"].append(q)
        self.data["v"].append(v)
        self.data["ctrl"].append(ctrl)
        self.data["feet_pos_w"].append(feet_pos.reshape(-1))
        self.data["base_wrt_feet"].append(state[-8:].copy())
        self.data["state"].append(state)
        self.data["action"].append(action)
        self.data["vc_goals"].append(self.vc_goals.copy())
        self.data["cc_goals"].append(self._rng.normal(0.0, 0.1, 8))
        self.data["contact_vec"].append(contact_vec)
        self.data["is_expert"].append(int(is_expert))

    def save(self) -> str:
        if not self.record_dir:
            self.record_dir = os.getcwd()
        os.makedirs(self.record_dir, exist_ok=True)
        stamp = _time.strftime("%Y%m%d_%H%M%S")
        if self.nominal_flag:
            path = os.path.join(self.record_dir, f"traj_nominal_{stamp}.npz")
        else:
            path = os.path.join(
                self.record_dir,
                f"traj_{self.replanning_point}_{self.nth_traj_per_replanning}.npz",
            )
        np.savez(path, **{k: np.asarray(vv) for k, vv in self.data.items()})
        return path
