"""Rollout drivers for data generation and evaluation in the host MuJoCo
plant (``sim/mujoco_sim.Simulator``).

Counterpart of ``iterative_learning_nmpc_tpu/learning/rollouts.py``: the
same numpy draws in the same order. The controllers run on ``device`` (by
default the CUDA card); MuJoCo steps on the host. The reference's L3
rollout layer:
- `rollout_mpc`: config-driven single MPC rollout with recording and
  early-termination detection (`Behavior_Cloning/utils/Rollout_MPC.py:309-516`),
  including mid-trajectory restarts (`DAgger/utils/RolloutMPC.py:324-439`)
  and timed force perturbations.
- `rollout_policy`: learned-policy rollout (`RolloutPolicy.py:404-463`).
- `rollout_combined`: SafeDAgger combined-controller rollout
  (`Rollout_combined_controller.py:512-631`) labeling expert steps.
- `sample_force_perturbation`: random base pushes, 50-70 N for 0.2-0.4 s
  (`data_collection_force_perturbation.py:213-248`).
- `nullspace_perturbation`: contact-consistent state noise via the contact
  Jacobian nullspace projector with feasibility resampling
  (`RolloutMPC_shift_phase_percentage.py:460-546`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import dynamics as dyn
from ..models import transforms_np as tnp
from ..mpc.controller import LocomotionMPC
from ..robots.spec import RobotSpec
from ..sim.mujoco_sim import ForceWindow, SimResult, Simulator
from .combined_controller import CombinedController
from .policy_controller import PolicyController
from .recorder import StateDataRecorder


@dataclass
class RolloutResult:
    sim: SimResult
    record_path: str = ""
    early_termination: bool = False
    recorder: Optional[StateDataRecorder] = None


def early_termination(res: SimResult, requested_time: float, tol: float = 1e-2) -> bool:
    """The reference deletes rollouts that ended early
    (`Rollout_MPC.py:446-463, 505-514`)."""
    return res.sim_time < requested_time - tol or res.fell or res.diverged


def sample_force_perturbation(
    rng: np.random.Generator,
    t_min: float,
    t_max: float,
    magnitude=(50.0, 70.0),
    duration=(0.2, 0.4),
) -> ForceWindow:
    mag = rng.uniform(*magnitude)
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    start = rng.uniform(t_min, t_max)
    return ForceWindow(start=start, end=start + rng.uniform(*duration),
                       force=mag * direction)


def nullspace_perturbation(
    spec: RobotSpec,
    q: np.ndarray,
    v: np.ndarray,
    contact_feet: np.ndarray,
    rng: np.random.Generator,
    scale_q: float = 0.05,
    scale_v: float = 0.2,
    max_tries: int = 100,
    swing_clearance: float = 0.02,
    stance_tol: float = 0.03,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (dq, dv) in the nullspace of the stacked contact constraint
    Ac = [[J, 0], [Jdot, J]] so contacts stay consistent, resampling until
    feasibility holds: swing feet keep >= swing_clearance, stance feet stay
    within |z| <= stance_tol of the ground. The Jacobians are float32, on
    the spec's device, as the JAX package's are.
    """
    dev = spec.device
    qj = torch.as_tensor(np.asarray(q), dtype=torch.float32, device=dev)
    vj = torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
    # Jdot by a jvp of the Jacobian along v
    J_all, Jdot_all = (t.cpu().numpy() for t in torch.func.jvp(
        lambda qq: dyn.foot_jacobians(spec, qq), (qj,), (vj,)))   # (4, 3, nv)

    active = np.flatnonzero(contact_feet)
    nv = spec.nv
    if len(active):
        J = J_all[active].reshape(-1, nv)
        Jd = Jdot_all[active].reshape(-1, nv)
        Ac = np.block([[J, np.zeros_like(J)], [Jd, J]])
        N = np.eye(2 * nv) - np.linalg.pinv(Ac) @ Ac
    else:
        N = np.eye(2 * nv)

    ground = float(spec.foot_radius)
    for _ in range(max_tries):
        raw = np.concatenate([
            rng.normal(0.0, scale_q, nv), rng.normal(0.0, scale_v, nv)
        ])
        delta = N @ raw
        q_new = np.asarray(q) + delta[:nv]
        v_new = np.asarray(v) + delta[nv:]
        feet = dyn.foot_positions(spec, torch.as_tensor(
            q_new, dtype=torch.float32, device=dev)).cpu().numpy()
        ok = True
        for i in range(4):
            if contact_feet[i]:
                ok &= abs(feet[i, 2] - ground) <= stance_tol
            else:
                ok &= feet[i, 2] >= ground + swing_clearance
        if ok:
            return q_new, v_new
    return np.asarray(q).copy(), np.asarray(v).copy()


# ---------------------------------------------------------------------------
def rollout_mpc(
    spec: RobotSpec,
    sim_time: float = 2.0,
    v_des: np.ndarray = np.zeros(3),
    gait_name: str = "trot",
    record_dir: str = "",
    record: bool = True,
    start_state: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    start_time: float = 0.0,
    force_schedule: Optional[Sequence[ForceWindow]] = None,
    nominal_flag: bool = True,
    replanning_point: int = 0,
    nth_traj: int = 0,
    simulator: Optional[Simulator] = None,
    solve_async: bool = False,
    device=None,
) -> RolloutResult:
    """One expert (MPC) rollout, optionally restarted mid-trajectory from
    `start_state` (mujoco chart) with perturbation forces applied. device:
    the MPC's (by default the CUDA card)."""
    sim = simulator or Simulator(spec)
    if start_state is not None:
        sim.reset(q_mj=np.asarray(start_state[0]), v_mj=np.asarray(start_state[1]))
    else:
        sim.reset()

    mpc = LocomotionMPC(spec, gait_name=gait_name, solve_async=solve_async, device=device)
    mpc.set_command(np.asarray(v_des, dtype=np.float64))
    if start_state is not None and start_time > 0.0:
        # continue the gait phase from the nominal timeline
        mpc.set_phase(start_time)

    recorder = None
    if record:
        recorder = StateDataRecorder(
            sim,
            record_dir=record_dir,
            v_des=np.asarray(v_des),
            current_time=start_time,
            nominal_flag=nominal_flag,
            replanning_point=replanning_point,
            nth_traj_per_replanning=nth_traj,
            kp=mpc.Kp,
            kd=1.5,
            gait_period=mpc.config_gait.nominal_period,
        )
    res = sim.run(
        sim_time=sim_time,
        controller=mpc,
        data_recorder=recorder,
        force_schedule=force_schedule,
    )
    early = early_termination(res, sim_time)
    path = ""
    if recorder is not None and not early:
        path = recorder.save()
    return RolloutResult(sim=res, record_path=path, early_termination=early,
                         recorder=recorder)


def rollout_mpc_phase_shift(
    spec: RobotSpec,
    nominal_path: str,
    step: int,
    rng: np.random.Generator,
    sim_time: float = 1.5,
    v_des: np.ndarray = np.zeros(3),
    gait_name: str = "trot",
    record_dir: str = "",
    nth_traj: int = 0,
    scale_q: float = 0.05,
    scale_v: float = 0.2,
    device=None,
) -> RolloutResult:
    """Nullspace-perturbed mid-trajectory restart at a recorded replanning
    point, keeping the gait phase aligned with the nominal timeline
    (reference `RolloutMPC_shift_phase_percentage.py:288,460-546`)."""
    data = np.load(nominal_path)
    q_mj = data["q"][step]
    v_mj = data["v"][step]
    t0 = float(data["time"][step])
    contact = data["contact_vec"][step]

    q, v = tnp.convert_from_mujoco(q_mj, v_mj)
    q_p, v_p = nullspace_perturbation(
        spec, q, v, contact, rng, scale_q=scale_q, scale_v=scale_v
    )
    q_mj_p, v_mj_p = tnp.convert_to_mujoco(q_p, v_p)
    return rollout_mpc(
        spec,
        sim_time=sim_time,
        v_des=v_des,
        gait_name=gait_name,
        record_dir=record_dir,
        start_state=(q_mj_p, v_mj_p),
        start_time=t0,
        nominal_flag=False,
        replanning_point=step,
        nth_traj=nth_traj,
        device=device,
    )


def rollout_policy(
    spec: RobotSpec,
    policy_path: str,
    sim_time: float = 2.0,
    v_des: np.ndarray = np.zeros(3),
    start_state: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    record_dir: str = "",
    record: bool = False,
    simulator: Optional[Simulator] = None,
    device=None,
) -> RolloutResult:
    sim = simulator or Simulator(spec)
    if start_state is not None:
        sim.reset(q_mj=np.asarray(start_state[0]), v_mj=np.asarray(start_state[1]))
    else:
        sim.reset()
    policy = PolicyController(sim, policy_path, v_des=v_des, device=device)
    recorder = (
        StateDataRecorder(sim, record_dir=record_dir, v_des=np.asarray(v_des))
        if record
        else None
    )
    res = sim.run(sim_time=sim_time, controller=policy, data_recorder=recorder)
    early = early_termination(res, sim_time)
    path = recorder.save() if (recorder and not early) else ""
    return RolloutResult(sim=res, record_path=path, early_termination=early,
                         recorder=recorder)


def rollout_combined(
    spec: RobotSpec,
    policy_path: str,
    sim_time: float = 10.0,
    v_des: np.ndarray = np.zeros(3),
    gait_name: str = "trot",
    record_dir: str = "",
    monitor: str = "v2",
    delay_steps: int = 100,
    mpc_min_steps: int = 2500,
    simulator: Optional[Simulator] = None,
    start_state: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    force_schedule: Optional[Sequence[ForceWindow]] = None,
    device=None,
) -> RolloutResult:
    """SafeDAgger rollout: policy with MPC fallback; records is_expert per
    step for expert relabeling. `start_state` (mujoco chart) lets in-plant
    data collection diversify rollout starts the way the reference's
    perturbed-restart expert rollouts do (`DAgger/utils/RolloutMPC.py:
    324-439`); `force_schedule` applies timed base pushes during the
    combined rollout (the reference's fault-injection windows,
    `RolloutMPC_force_at_interval.py:384-390`, here driving expert
    takeover -> recovery demonstrations). Defaults keep the reference's
    clean home start."""
    sim = simulator or Simulator(spec)
    if start_state is not None:
        sim.reset(q_mj=np.asarray(start_state[0]),
                  v_mj=np.asarray(start_state[1]))
    else:
        sim.reset()
    mpc = LocomotionMPC(spec, gait_name=gait_name, solve_async=False, device=device)
    policy = PolicyController(sim, policy_path, v_des=v_des, device=device)
    combined = CombinedController(
        sim, mpc, policy, v_des=v_des, delay_steps=delay_steps,
        mpc_min_steps=mpc_min_steps, monitor=monitor,
    )
    combined.set_command(np.asarray(v_des))

    recorder = StateDataRecorder(
        sim, record_dir=record_dir, v_des=np.asarray(v_des),
        gait_period=mpc.config_gait.nominal_period,
    )

    class _RecorderShim:
        """Route is_expert into the recorder rows."""

        record_step = 1

        def record(self, mj_data):
            recorder.record(mj_data, is_expert=combined.mpc_active)

    res = sim.run(sim_time=sim_time, controller=combined,
                  data_recorder=_RecorderShim(), stop_on_fall=True,
                  force_schedule=force_schedule)
    early = early_termination(res, sim_time)
    path = recorder.save() if len(recorder.data["time"]) else ""
    return RolloutResult(sim=res, record_path=path, early_termination=early,
                         recorder=recorder)
