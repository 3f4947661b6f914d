"""Batched-expert PLANT collector: many MuJoCo envs, ONE batched replan on
the card.

Counterpart of ``iterative_learning_nmpc_tpu/learning/plant_batch.py``.
The host-plant data bottleneck is the expert: one combined rollout solves
one problem a replan. Here:

- E MuJoCo instances step on the host at 1 kHz (``Simulator.step``): PD
  torques from the interpolated plans, the safety monitor and the rows are
  host numpy;
- every replanning interval (40 ms) ALL envs replan in ONE call of the
  controller's own plan function at B=E (``LocomotionMPC._plan``: warm-start
  shift, GN-SQP, Hermite interpolation, RNEA feed-forward; the batch
  route: kernels 2, 3 and 1), the per-env warm starts and AL duals kept on
  the device between calls, the cold start one ``solver.cold_start`` at
  B=E; the consumed interval (``keep`` = 41 rows of q, v and tau_ff) comes
  to the host in one copy a replan;
- the per-env base references come from ``mpc.controller.
  velocity_tracking_refs``, the controller's own assembly (the JAX
  collector has its own copy, which sets the yaw references to
  ``round(q[3], 1)`` where the controller blends toward the tracked yaw;
  the two agree while |yaw| < 0.05).

This is the reference's ``rollout_combined_controller`` / ``Rollout_MPC``
data generation (``DAgger/utils/Rollout_combined_controller.py:512-631``,
``Behavior_Cloning/utils/Rollout_MPC.py:309-516``) run many envs at a time
in the same deployment plant.

Modes:
- expert-only (``policy_path=None``): batched force-perturbed expert
  rollouts from noisy starts (the BC DataCollection role);
- combined (``policy_path=...``): the policy serves all E envs in one
  ``ServedPolicy`` call a control step (kernel 8 at B=E on the card), each
  env driven by the bundle member nearest its own goal
  (``network.payload_members``; the JAX collector loads the bundle
  without a goal and serves every env with its first member), and each
  env's switch is one ``combined_controller.SwitchLatch`` over
  ``safety.check_unsafe_state_v2`` with the collector's height bounds, the
  controller's latch. The JAX collector inlines its own copy of the latch,
  which first consults the monitor at step index ``delay_steps``; the
  latch, counting its updates from 1, consults it at ``delay_steps - 1``.

The template controller is built with ``phase_aligned_boot=False``, the
reference collector's choice (its ``:89``): the cold start does not probe
the gait-phase offset.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..interop import policy_from_numpy
from ..models import transforms_np as tnp
from ..mpc.controller import LocomotionMPC, velocity_tracking_refs
from ..robots.spec import RobotSpec
from ..sim.mujoco_sim import Simulator
from ..solver.sqp import make_params
from .combined_controller import SwitchLatch
from .network import ServedPolicy, payload_members
from .recorder import assemble_state
from .rollouts import sample_force_perturbation
from .safety import UNSAFE_HEIGHT_BOUNDS, check_unsafe_state_v2

POLICY_KP, POLICY_KD = 20.0, 1.5


@dataclass
class BatchRolloutResult:
    # ragged per-env row lists stacked to arrays
    state: np.ndarray          # (rows, 44)
    action: np.ndarray         # (rows, 12)
    vc_goals: np.ndarray       # (rows, 3)
    cc_goals: np.ndarray       # (rows, 8)
    time: np.ndarray           # (rows,)
    env_id: np.ndarray         # (rows,)
    is_expert: np.ndarray      # (rows,)
    sim_time: np.ndarray       # (E,) survived seconds per env
    fell: np.ndarray           # (E,) bool
    expert_ratio: float = 0.0
    wall_s: float = 0.0
    env_sim_s: float = 0.0
    # (E, steps) monitor readings where the latch consulted it (1 unsafe,
    # 0 safe), -1 elsewhere; empty in expert-only mode
    monitor: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.int8))
    replan_ms: List[float] = field(default_factory=list)   # wall of each replan


class BatchedPlantCollector:
    """E-env MuJoCo collection with a single batched replan on ``device``
    (by default the CUDA card)."""

    def __init__(
        self,
        spec: RobotSpec,
        n_envs: int = 16,
        gait_name: str = "trot",
        policy_path: Optional[str] = None,
        monitor_height_bounds=None,
        delay_steps: int = 100,
        mpc_min_steps: int = 2500,
        device=None,
    ):
        self.device = resolve_device(device)
        self.spec = spec
        self.E = n_envs
        self.delay_steps = delay_steps
        self.mpc_min_steps = mpc_min_steps
        self.monitor_height_bounds = tuple(monitor_height_bounds or UNSAFE_HEIGHT_BOUNDS)
        self.policy_path = policy_path
        # template controller: configs, solver, planner, the plan function
        self.mpc = LocomotionMPC(spec, gait_name=gait_name, solve_async=False,
                                 compute_timings=False, phase_aligned_boot=False,
                                 device=self.device)
        self.N = self.mpc.config_opt.n_nodes
        self.replan_steps = self.mpc.replanning_steps      # 40
        self.keep = self.replan_steps + 1
        self.Kp, self.Kd = self.mpc.Kp, self.mpc.Kd
        self._tl = spec.torque_limit.detach().cpu().numpy().astype(np.float64)

    def close(self) -> None:
        self.mpc.close()

    # ------------------------------------------------------------------
    def _batched_params(self, sims, ref_xy, v_des, node):
        """The E problems' OCPParams on the device: the shared contact
        schedule and references from one ``make_params``, the per-env x0
        and base references (``velocity_tracking_refs``, the controller's
        assembly, at zero yaw rate) in one copy."""
        mpc, N, E = self.mpc, self.N, len(sims)
        cnt = mpc.contact_planner.get_contacts(node, N + 1).astype(np.float32)
        peak = (mpc.contact_planner.get_peaks(node, N + 1).astype(np.float32)
                if mpc.config_opt.opt_peak else 1.0 - cnt)
        per_env = np.zeros((E, 60), np.float32)
        for e, sim in enumerate(sims):
            q, v = tnp.convert_from_mujoco(np.asarray(sim.data.qpos), np.asarray(sim.data.qvel))
            base_ref, base_ref_e = velocity_tracking_refs(
                q, ref_xy[e], 0.0, v_des[e], np.zeros(3), mpc.config_gait.nom_height,
                mpc.config_opt.time_horizon)
            per_env[e] = np.concatenate([q, v, base_ref, base_ref_e])
        p = make_params(mpc.solver, per_env[0, :36], cnt, peak=peak,
                        base_ref=per_env[0, 36:48], base_ref_e=per_env[0, 48:],
                        joint_ref=mpc.joint_ref.astype(np.float32),
                        step_height=mpc.config_gait.step_height + mpc._ground,
                        ground_height=mpc._ground)
        d = torch.as_tensor(per_env, device=self.device)
        return p.map(lambda t: t.expand(E, *t.shape[1:]).contiguous()).replace(
            x0=d[:, :36].contiguous(), base_ref=d[:, 36:48].contiguous(),
            base_ref_e=d[:, 48:].contiguous())

    def _policies(self, v_des):
        """(served policies, member of each env) for the envs' goals."""
        payloads, member = payload_members(self.policy_path, v_des)
        served = [ServedPolicy(*policy_from_numpy(p, device=self.device), device=self.device)
                  for p in payloads]
        return served, member

    def _policy_actions(self, served, member, states44, v_des, sims, active):
        """The policy's PD targets (E, 12) for every env (rows of fallen envs
        zero, as the reference's): one copy to the device, one call of each
        member's ``ServedPolicy`` on its rows, one copy back."""
        E = self.E
        obs = np.zeros((E, 71), np.float32)
        for e, sim in enumerate(sims):
            if active[e]:
                obs[e, :44] = states44[e]
                obs[e, 47:59] = np.asarray(sim.data.qpos[7:])
                obs[e, 59:] = np.asarray(sim.data.qvel[6:])
                obs[e, 44:47] = v_des[e]
        d = torch.as_tensor(obs, device=self.device)
        act = torch.zeros(E, 12, device=self.device)
        for g, pol in enumerate(served):
            rows = torch.as_tensor(np.flatnonzero(member == g), device=self.device)
            x = d[rows]
            act[rows] = pol(x[:, :44], x[:, 44:47], x[:, 47:59], x[:, 59:],
                            POLICY_KP, POLICY_KD)[0]
        return act.cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------------
    def collect(
        self,
        v_des: np.ndarray,              # (E, 3)
        sim_time: float = 10.0,
        joint_noise: float = 0.03,
        vel_noise: float = 0.05,
        n_pushes: int = 0,
        seed: int = 0,
        record_expert_only_rows: bool = False,
    ) -> BatchRolloutResult:
        t_wall = time.time()
        E, N = self.E, self.N
        rng = np.random.default_rng(seed)
        v_des = np.asarray(v_des, np.float64)
        assert v_des.shape == (E, 3)

        sims: List[Simulator] = []
        pushes = []
        for e in range(E):
            sim = Simulator(self.spec)
            sim.reset()
            if e > 0 and joint_noise > 0:       # env 0 keeps the clean start
                q0 = np.asarray(sim.data.qpos).copy()
                v0 = np.asarray(sim.data.qvel).copy()
                q0[7:] += rng.normal(0, joint_noise, 12)
                v0[:3] += rng.normal(0, vel_noise, 3)
                sim.reset(q_mj=q0, v_mj=v0)
            sims.append(sim)
            if n_pushes > 0 and e % 2 == 1:     # half the envs get pushes
                seg = sim_time / n_pushes
                pushes.append([
                    sample_force_perturbation(rng, i * seg + 1.0, (i + 1) * seg - 0.5)
                    for i in range(n_pushes)])
            else:
                pushes.append([])

        combined = self.policy_path is not None
        if combined:
            served, member = self._policies(v_des)
            latches = [SwitchLatch(self.delay_steps, self.mpc_min_steps) for _ in range(E)]

        # device-side per-env solver state
        ref_xy = np.stack([np.asarray(s.data.qpos[:2], np.float64).copy() for s in sims])
        params = self._batched_params(sims, ref_xy, v_des, node=0)
        Xp, Up = self.mpc.solver.cold_start(params)
        lam = torch.zeros(E, N, 18, device=self.device)
        lami = torch.zeros(E, N, 36, device=self.device)

        # host loop state
        T = int(round(sim_time / 1e-3))
        active = np.ones(E, bool)
        monitor = np.full((E, T), -1, np.int8) if combined else np.zeros((0, 0), np.int8)
        rows = {k: [] for k in ("state", "action", "vc", "cc", "t", "env", "exp")}
        n_expert = 0
        n_rows = 0
        node = 0
        first = True
        replan_ms = []
        q_plan = v_plan = tau_plan = None

        for step in range(T):
            t = step * 1e-3
            if t >= (node + 1) * self.mpc.dt_nodes and not first:
                node += 1
            if step % self.replan_steps == 0:
                t0 = time.perf_counter()
                params = self._batched_params(sims, ref_xy, v_des, node)
                n_iter = (self.mpc.config_opt.max_iter_first if first
                          else self.mpc.config_opt.max_iter)
                sol, lam, plan = self.mpc._plan(Xp, Up, lam, lami, 0 if first else 1,
                                                params, n_iter)
                Xp, Up, lami = sol.X, sol.U, sol.lam_ineq
                k = self.keep
                plan_cat = torch.cat([plan[0][:, :k], plan[1][:, :k], plan[4][:, :k]],
                                     -1).cpu().numpy().astype(np.float64)  # (E, keep, 48)
                q_plan = plan_cat[..., :18]
                v_plan = plan_cat[..., 18:36]
                tau_plan = plan_cat[..., 36:]
                replan_ms.append((time.perf_counter() - t0) * 1e3)
                first = False
                k_plan = 0
            else:
                k_plan = min(step % self.replan_steps, self.keep - 1)

            # per-env pre-step state, computed once and shared by the
            # policy observations and the rows
            states44 = [None] * E
            for e, sim in enumerate(sims):
                if not active[e]:
                    continue
                feet = np.array([sim.data.geom_xpos[g] for g in sim.foot_geoms])
                states44[e] = assemble_state(np.asarray(sim.data.qpos),
                                             np.asarray(sim.data.qvel), feet)

            tau_pol = None
            if combined:
                act = self._policy_actions(served, member, states44, v_des, sims, active)
                tau_pol = np.zeros((E, 12))
                for e, sim in enumerate(sims):
                    if active[e]:
                        qj = np.asarray(sim.data.qpos[7:])
                        vj = np.asarray(sim.data.qvel[6:])
                        tau_pol[e] = POLICY_KP * (act[e] - qj) - POLICY_KD * vj

            cc_batch = rng.normal(0.0, 0.1, (E, 8))
            for e, sim in enumerate(sims):
                if not active[e]:
                    continue
                q_mj = np.asarray(sim.data.qpos)
                v_mj = np.asarray(sim.data.qvel)

                if combined:
                    def unsafe(e=e, q_mj=q_mj, v_mj=v_mj):
                        u = check_unsafe_state_v2(q_mj, v_mj, v_des[e],
                                                  height_bounds=self.monitor_height_bounds)
                        monitor[e, step] = u
                        return u

                    use_expert = latches[e].update(unsafe) == "mpc"
                else:
                    use_expert = True

                qj, vj = q_mj[7:], v_mj[6:]
                tau_exp = (tau_plan[e, k_plan]
                           + self.Kp * (q_plan[e, k_plan, 6:] - qj)
                           + self.Kd * (v_plan[e, k_plan, 6:] - vj))
                tau = tau_exp if use_expert else tau_pol[e]
                tau = np.clip(tau, -self._tl, self._tl)

                # record BEFORE stepping (recorder contract): action is the
                # realized PD target of the APPLIED torque
                if use_expert or not record_expert_only_rows:
                    rows["state"].append(states44[e])
                    rows["action"].append((tau + POLICY_KD * vj) / POLICY_KP + qj)
                    rows["vc"].append(v_des[e])
                    rows["cc"].append(cc_batch[e])
                    rows["t"].append(t)
                    rows["env"].append(e)
                    rows["exp"].append(int(use_expert))
                    n_expert += int(use_expert)
                n_rows += 1

                sim.data.ctrl[:] = tau
                sim.data.xfrc_applied[sim.trunk_body][:] = 0.0
                for fw in pushes[e]:
                    if fw.start <= t < fw.end:
                        f6 = np.zeros(6)
                        f6[:3] = fw.force
                        sim.data.xfrc_applied[sim.trunk_body][:] += f6
                sim.step()
                if sim._bad_collision():
                    active[e] = False
                ref_xy[e] += np.round(v_des[e][:2], 2) * 1e-3
            if not active.any():
                break

        wall = time.time() - t_wall
        sim_s = np.array([s.data.time for s in sims])
        return BatchRolloutResult(
            state=np.asarray(rows["state"]),
            action=np.asarray(rows["action"]),
            vc_goals=np.asarray(rows["vc"]),
            cc_goals=np.asarray(rows["cc"]),
            time=np.asarray(rows["t"]),
            env_id=np.asarray(rows["env"]),
            is_expert=np.asarray(rows["exp"]),
            sim_time=sim_s,
            fell=~active,
            expert_ratio=n_expert / max(n_rows, 1),
            wall_s=wall,
            env_sim_s=float(sim_s.sum()),
            monitor=monitor[:, :step + 1] if combined else monitor,
            replan_ms=replan_ms,
        )
