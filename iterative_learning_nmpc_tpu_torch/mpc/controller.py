"""Closed-loop locomotion MPC controller.

Counterpart of ``iterative_learning_nmpc_tpu/mpc/controller.py``
(``LocomotionMPC``):

- A replan (warm-start shift of the primal and of both AL duals, the
  GN-SQP solve of ONE problem, Hermite interpolation to the control rate,
  zero-order-hold inputs and feed-forward RNEA torques along the plan) runs
  on the solver's device; the plan crosses to host numpy once per replan.
  The 1 kHz ``compute_torques_dof`` is numpy only and never touches the
  device.
- The first solve runs ``max_iter_first`` SQP iterations, later ones
  ``max_iter`` (RTI). A cold boot first picks the gait-phase offset with
  ``solver.warmstart.merit_phase_boot`` (``phase_aligned_boot``; cyclic
  unrestricted planners only).
- ``contact_planner`` picks the footstep planner: "" the cyclic
  ``ContactPlanner`` (no footstep restriction), "raibert" the Raibert
  heuristic from the base state and the command, "custom" a user table
  (``contact_planner.set_contact_locations``). The last two restrict the
  contacts: active feet are pinned to the planned xy (``restrict = 1``,
  ``cnt_loc``) and the base reference follows the footsteps.
- ``interactive_goal`` reads the velocity command from a
  ``utils/interactive.SetVelocityGoal`` teleop at every replan, and the
  terminal base reference then follows the measured base instead of the
  integrated command.
- Asynchronous replanning: a one-worker ``ThreadPoolExecutor`` solves while
  the plant steps, with the delay compensation
  ``ceil(replan_time / sim_dt) - 1``; ``async_sim_latency`` models the
  solver latency in simulated seconds.

A plant couples to it through ``compute_torques_dof(data)``: ``data`` has
``time``, ``qpos`` and ``qvel`` in MuJoCo layout, and the controller leaves
its joint torques in ``torques_dof[-nu:]``.
"""
from __future__ import annotations

import math
import time
import traceback
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..gait.planner import ContactPlanner, CustomContactPlanner, RaibertContactPlanner
from ..models import dynamics as dyn
from ..models import transforms_np as tnp
from ..mpc.config import get_quadruped_config
from ..mpc.interpolate import interpolate_plan
from ..robots.spec import RobotSpec
from ..solver.sqp import TrajOptSolver, make_params
from ..solver.warmstart import contact_windows, merit_phase_boot, peak_windows
from ..utils.profiling import print_timings, time_fn


class SolverDiverged(RuntimeError):
    """A plan whose cost is not finite: the solver diverged."""


def velocity_tracking_refs(q: np.ndarray, ref_xy, ref_yaw: float, v_des, w_des,
                           height: float, t_horizon: float, frame_yaw=None):
    """The velocity-tracking running and terminal base references (12,) each
    of one chart state ``q``: the terminal one at the tracked reference
    (``ref_xy``, ``ref_yaw``) advanced by the command over the horizon, the
    running one three quarters of the way there from the rounded base
    position, at ``height``, roll, pitch and the terminal vertical motion
    flat. ``v_des`` is the body-frame command, turned into the world by
    ``frame_yaw`` (the integrated command's yaw; ``ref_yaw`` when None) and
    rounded to 0.01 m/s as the JAX package does; ``w_des`` is [wx, wy, wz].
    ``LocomotionMPC`` and ``learning/plant_batch`` both assemble their
    references here."""
    frame_yaw = ref_yaw if frame_yaw is None else frame_yaw
    base_ref = np.zeros(12)
    base_ref[:2] = np.round(q[:2], 2)
    base_ref[2] = height
    base_ref[3] = round(q[3], 1)

    R_WB = tnp.ypr_to_matrix(np.array([frame_yaw, 0.0, 0.0]))
    v_des_glob = np.round(R_WB @ v_des, 2)
    base_ref[6:9] = v_des_glob
    # chart angular slots are [yaw, pitch, roll] rates; w_des is [wx, wy, wz]
    base_ref[9:12] = w_des[::-1]

    base_ref_e = base_ref.copy()
    R_yaw = tnp.ypr_to_matrix(np.array([w_des[2] * t_horizon, 0.0, 0.0]))
    base_ref_e[6:9] = R_yaw @ base_ref[6:9]
    base_ref_e[:2] = ref_xy[:2] + v_des_glob[:2] * t_horizon
    base_ref_e[3] = ref_yaw + w_des[2] * t_horizon
    # intermediate running reference
    base_ref[:2] += (base_ref_e[:2] - base_ref[:2]) * 0.75
    base_ref[3] += (base_ref_e[3] - base_ref[3]) * 0.75
    # flatten roll/pitch and the terminal vertical motion
    base_ref_e[8] = 0.0
    base_ref_e[4:6] = 0.0
    base_ref[4:6] = 0.0
    base_ref_e[10:12] = 0.0
    return base_ref, base_ref_e


class LocomotionMPC:
    """Velocity-tracking whole-body MPC for a quadruped."""

    def __init__(
        self,
        spec: RobotSpec,
        gait_name: str = "trot",
        joint_ref: Optional[np.ndarray] = None,
        sim_dt: float = 1.0e-3,
        height_offset: float = 0.0,
        contact_planner: str = "",
        interactive_goal: bool = False,
        print_info: bool = False,
        compute_timings: bool = True,
        solve_async: bool = True,
        async_sim_latency: Optional[float] = 0.02,
        phase_aligned_boot: bool = True,
        recover_on_divergence: int = 0,
        device=None,
    ) -> None:
        """async_sim_latency: with a co-simulation that does not run in real
        time, the plan is picked up this many simulated seconds after it was
        submitted; None uses the wall-clock latency.

        recover_on_divergence: cold reboots allowed after a failed solve
        (0 marks the controller diverged and holds the last plan).

        device: where the solver runs, by default the CUDA card."""
        self.device = resolve_device(device)
        self.spec = spec.to(self.device)
        self.gait_name = gait_name
        self.print_info = print_info
        self.height_offset = height_offset
        self.config_gait, self.config_opt, self.config_cost = get_quadruped_config(
            gait_name, spec.name)
        self.solver = TrajOptSolver(self.spec, self.config_opt, self.config_cost,
                                    device=self.device)
        self.nu = spec.nu
        self.nv = spec.nv
        self.n_foot = len(spec.foot_body)
        self.joint_ref = (
            spec.q_home[6:].detach().cpu().numpy().astype(np.float64)
            if joint_ref is None
            else np.asarray(joint_ref, dtype=np.float64)[-self.nu:])
        # contact plane of the FOOT CENTRE: the foot sphere rests one radius
        # above the ground
        self._ground = float(height_offset) + float(spec.foot_radius)

        self.dt_nodes: float = self.solver.dt_nodes
        self._contact_planner_str = contact_planner.lower()
        feet, dt_nodes = spec.feet_frame_names, self.dt_nodes
        if self._contact_planner_str == "raibert":
            # hip xy offsets in the base frame
            hip_idx = [6 + 3 * i for i in range(4)]
            offset_hip_b = np.zeros((4, 3))
            offset_hip_b[:, :2] = spec.joint_pos.detach().cpu().numpy()[hip_idx, :2]
            self.contact_planner = RaibertContactPlanner(
                feet, dt_nodes, self.config_gait, offset_hip_b,
                y_offset=0.02, x_offset=0.04, foot_size=0.0085, cache_cnt=False)
            self.restrict_cnt = True
        elif self._contact_planner_str == "custom":
            self.contact_planner = CustomContactPlanner(feet, dt_nodes, self.config_gait)
            self.restrict_cnt = True
        else:
            self.contact_planner = ContactPlanner(feet, dt_nodes, self.config_gait)
            self.restrict_cnt = False
        self.Kp = self.config_opt.Kp
        self.Kd = self.config_opt.Kd
        self.sim_dt = sim_dt
        self.replanning_freq = self.config_opt.replanning_freq
        self.replanning_steps = int(1 / (self.replanning_freq * sim_dt))
        self.solve_async = solve_async
        self.async_sim_latency = async_sim_latency
        self.compute_timings = compute_timings
        self.interactive_goal = interactive_goal
        self.velocity_goal = None
        self.recover_on_divergence = recover_on_divergence
        self.n_interp_plan = round(self.config_opt.time_horizon / sim_dt)

        # restricted planners pin footsteps to the node clock's phase, so the
        # boot may not move it
        self.phase_aligned_boot = phase_aligned_boot and not self.restrict_cnt
        if self.phase_aligned_boot:
            N = self.config_opt.n_nodes
            self._boot_windows = contact_windows(self.contact_planner, N)
            # the planner's own swing peaks when the solver optimizes them,
            # the same rule as every replan (see optimize)
            self._boot_peaks = (peak_windows(self.contact_planner, N)
                                if self.config_opt.opt_peak else 1.0 - self._boot_windows)
        self.executor = None
        self.reset(reset_solver=False)

    # ------------------------------------------------------------------
    def _plan(self, X_prev, U_prev, lam_prev, lami_prev, shift: int, params,
              n_iter: int):
        """The device part of a replan for a batch of problems (the
        controller's own replans are a batch of one; ``learning/plant_batch``
        plans one problem per environment in the same call): shifted warm
        start, solve, multiplier update, interpolated plan and the
        feed-forward torques along it (the plan function that the JAX
        controller's ``_build_plan_fn`` jits and its batched collector
        vmaps). Returns (sol, lam_eq, (q, v, a, f, tau_ff)), each plan
        (B, n_interp, ...); the nodes' dt are the config's, shared by the
        batch, or in the time-optimal mode each problem's optimized ones
        (``Solution.dt_sol``)."""
        solver, N = self.solver, self.config_opt.n_nodes
        X_ws, U_ws = solver.shift_warmstart(X_prev, U_prev, shift)
        X_ws = torch.cat([params.x0[:, None], X_ws[:, 1:]], dim=1)
        params = params.replace(lam_eq=solver.shift_multipliers(lam_prev, shift),
                                lam_ineq=solver.shift_multipliers(lami_prev, shift))
        sol = solver.solve(X_ws, U_ws, params, n_iter)
        lam_new = solver.update_multipliers(sol.X, sol.U, params, r_eq=sol.r_eq)
        B, n = sol.X.shape[0], self.n_interp_plan
        a, f = sol.U[..., :18], sol.U[..., 18:30].reshape(B, N, self.n_foot, 3)
        q_plan, v_plan, id_rep = interpolate_plan(sol.X[..., :18], sol.X[..., 18:], a,
                                                  sol.dt_sol(params.dt[0]), n)
        a_plan, f_plan = a[:, id_rep], f[:, id_rep]
        # RNEA over the (B * n) plan rows, one batch dim as at B = 1
        tau_ff = dyn.id_torques(self.spec, q_plan.reshape(B * n, -1), v_plan.reshape(B * n, -1),
                                a_plan.reshape(B * n, -1),
                                f_plan.reshape(B * n, self.n_foot, 3)).reshape(B, n, -1)
        return sol, lam_new, (q_plan, v_plan, a_plan, f_plan, tau_ff)

    # ------------------------------------------------------------------
    def warmup(self, q: Optional[np.ndarray] = None,
               v: Optional[np.ndarray] = None) -> float:
        """Run the first-solve and the steady-state replan once each (the
        kernels build at their first launch), then reset. Returns wall
        seconds spent."""
        t0 = time.perf_counter()
        if q is None:
            q = self.spec.q_home.detach().cpu().numpy().astype(np.float64).copy()
            q[2] += self.height_offset
        if v is None:
            v = np.zeros(self.nv)
        self.optimize(q, v)
        self.first_solve = False
        self.optimize(q, v)
        self.reset(reset_solver=False)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _worker_init(self) -> None:
        """Worker threads launch on the solver's card."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def reset(self, reset_solver: bool = True) -> None:
        self.first_solve = True
        self.diverged = False
        self.t0 = 0.0
        self.sim_step = 0
        self.plan_step = 0
        self.current_opt_node = 0
        self.last_node = 0
        self.delay = 0
        self._phase_time_offset = 0.0

        self.v_des = np.zeros(3)
        self.w_des = np.zeros(3)
        self.base_ref_vel_tracking = np.zeros(12)
        self._recoveries_left = self.recover_on_divergence
        self.boot_offsets = []  # phase offsets picked at cold boots

        self.q_plan = np.zeros((self.n_interp_plan, self.nv))
        self.v_plan = np.zeros((self.n_interp_plan, self.nv))
        self.a_plan = np.zeros((self.n_interp_plan, self.nv))
        self.f_plan = np.zeros((self.n_interp_plan, self.n_foot, 3))
        self.tau_ff_plan = np.zeros((self.n_interp_plan, self.nu))
        self.torques_dof = np.zeros(self.nv)

        self._X_prev = None
        self._U_prev = None
        self._lam_prev = None
        self._lami_prev = None

        # realized trajectories and the time-aligned plan rows of each step
        self.q_full, self.v_full, self.a_full, self.f_full, self.tau_full = [], [], [], [], []
        self.q_plan_full, self.v_plan_full = [], []
        self.a_plan_full, self.f_plan_full = [], []
        self.tau_plan_full, self.dt_plan_full = [], []
        self._last_dt_sol = np.full(self.config_opt.n_nodes, self.dt_nodes)
        self._last_base_ref = np.zeros(12)
        self._last_base_ref_e = np.zeros(12)
        self._last_cnt_loc = None
        self.timings = defaultdict(list)

        if self.executor is not None:
            self.executor.shutdown(wait=False, cancel_futures=True)
        self.executor = ThreadPoolExecutor(max_workers=1, initializer=self._worker_init)
        self.optimize_future: Future = Future()
        self.plan_submitted = False

        if self.velocity_goal is not None:
            self.velocity_goal.stop()
        self.velocity_goal = None
        if self.interactive_goal:
            from ..utils.interactive import SetVelocityGoal

            self.velocity_goal = SetVelocityGoal()

    # ------------------------------------------------------------------
    def set_command(self, v_des: np.ndarray = np.zeros(3), w_yaw: float = 0.0) -> None:
        self.v_des = np.asarray(v_des, dtype=np.float64)
        self.w_des[2] = w_yaw

    def set_phase(self, start_time: float) -> None:
        """Align the gait phase with an absolute trajectory time."""
        self.current_opt_node = int(round(start_time / self.dt_nodes))
        self._phase_time_offset = self.current_opt_node * self.dt_nodes

    def increment_base_ref_position(self):
        """Integrate the velocity command into the tracked base reference."""
        R_WB = tnp.ypr_to_matrix(np.array([self.base_ref_vel_tracking[3], 0.0, 0.0]))
        # commands rounded to 0.01 m/s, as the JAX package does
        v_des_glob = np.round(R_WB @ self.v_des, 2)
        self.base_ref_vel_tracking[:2] += v_des_glob[:2] * self.sim_dt
        self.base_ref_vel_tracking[3] += self.w_des[2] * self.sim_dt

    def compute_base_ref_vel_tracking(self, q: np.ndarray):
        """Velocity-tracking running and terminal base references: toward the
        integrated command, or with a teleop goal toward the measured base."""
        brvt = self.base_ref_vel_tracking
        if self.velocity_goal is not None:
            ref_xy, ref_yaw = np.round(q[:3], 2)[:2], q[3]
        else:
            ref_xy, ref_yaw = brvt[:2], brvt[3]
        return velocity_tracking_refs(q, ref_xy, ref_yaw, self.v_des, self.w_des,
                                      self.config_gait.nom_height + self.height_offset,
                                      self.config_opt.time_horizon, frame_yaw=brvt[3])

    def compute_base_ref_cnt_restricted(self, q: np.ndarray, cnt_loc: np.ndarray):
        """Running and terminal base references from a footstep plan
        (n_foot, N+1, 3): between the centres of the first and the last
        node where every foot has a location, at the nominal height."""
        nonzero = np.all(cnt_loc != 0.0, axis=-1)  # (4, n_nodes)
        first_ids = np.argwhere(nonzero.all(axis=0))
        base_ref = np.zeros(12)
        base_ref_e = np.zeros(12)
        if len(first_ids) > 0:
            i0, i1 = int(first_ids[0, 0]), int(first_ids[-1, 0])
            center_first = cnt_loc[:, i0, :].mean(axis=0)
            center_last = cnt_loc[:, i1, :].mean(axis=0)
        else:
            center_first = cnt_loc[:, 0, :].mean(axis=0)
            center_last = cnt_loc[:, -1, :].mean(axis=0)
        alpha = 0.35
        base_ref[:2] = alpha * center_first[:2] + (1 - alpha) * center_last[:2]
        base_ref_e[:2] = center_last[:2]
        base_ref[2] = self.config_gait.nom_height + self.height_offset
        base_ref_e[2] = base_ref[2]
        return base_ref, base_ref_e

    # ------------------------------------------------------------------
    @time_fn("optimize")
    def optimize(self, q: np.ndarray, v: np.ndarray):
        """One full replan from the chart state (q, v): parameters (with a
        restricted planner, the footsteps and the base reference they give),
        cold boot if there is no warm start, solve, interpolate. Returns the
        host plan (q, v, a, f, tau_ff), float64."""
        node = self.current_opt_node
        N = self.config_opt.n_nodes
        if self.velocity_goal is not None:
            self.v_des, self.w_des[2] = self.velocity_goal.get_velocity()
        cnt = self.contact_planner.get_contacts(node, N + 1).astype(np.float32)
        peak = (self.contact_planner.get_peaks(node, N + 1).astype(np.float32)
                if self.config_opt.opt_peak else 1.0 - cnt)
        cnt_loc = None
        if self.restrict_cnt:
            if self._contact_planner_str == "raibert":
                com_xyz = dyn.com_position(self.spec, torch.as_tensor(
                    q, dtype=torch.float32, device=self.device)).cpu().numpy()
                # the planner takes the chart's [yaw, pitch, roll]
                self.contact_planner.set_state(q[:3], v[:3], q[3:6], com_xyz, self.v_des,
                                               self.w_des[2])
            cnt_loc = self.contact_planner.get_locations(node, N + 1)
            base_ref, base_ref_e = self.compute_base_ref_cnt_restricted(q, cnt_loc)
        else:
            base_ref, base_ref_e = self.compute_base_ref_vel_tracking(q)
        self._last_base_ref = base_ref.copy()
        self._last_base_ref_e = base_ref_e.copy()
        self._last_cnt_loc = None if cnt_loc is None else np.array(cnt_loc)

        x0 = np.concatenate([q, v]).astype(np.float32)
        plane = np.zeros((4, N + 1, 3), dtype=np.float32)
        plane[:, :, 2] = self._ground
        if cnt_loc is not None:
            # active contacts pinned to the planned xy where one is given
            provided = np.all(cnt_loc != 0.0, axis=-1)
            plane[:, :, :2] = np.where(provided[:, :, None], cnt_loc[:, :, :2], 0.0)
        params = make_params(
            self.solver, x0, cnt, peak=peak, plane_point=plane,
            cnt_loc=(np.zeros((4, N + 1, 3), np.float32) if cnt_loc is None
                     else cnt_loc.astype(np.float32)),
            restrict=1.0 if self.restrict_cnt else 0.0,
            base_ref=base_ref.astype(np.float32),
            base_ref_e=base_ref_e.astype(np.float32),
            joint_ref=self.joint_ref.astype(np.float32),
            step_height=self.config_gait.step_height + self._ground,
            ground_height=self._ground)

        if self._X_prev is None and self.phase_aligned_boot:
            # cold boot: probe every gait-phase offset and move the node
            # clock to the winner
            params, off, _ = merit_phase_boot(self.solver, params, self._boot_windows,
                                              peaks=self._boot_peaks)
            node = self.resync_phase(node, off)
        return self._solve_plan(params, node)

    def resync_phase(self, node: int, offset: int) -> int:
        """Shift the node clock so that the planner phase at ``node``
        becomes ``offset`` (mod the cycle). Returns the shifted node."""
        C = self.contact_planner.nodes_per_cycle
        delta = (offset - node) % C
        if delta:
            node += delta
            self.current_opt_node = node
            self._phase_time_offset += delta * self.dt_nodes
        self.boot_offsets.append(offset)
        return node

    def _solve_plan(self, params, node):
        """Warm start (primal + AL duals), solve, interpolate; one transfer
        of the plan to the host."""
        N = self.config_opt.n_nodes
        if self._X_prev is None:
            X_prev, U_prev = self.solver.cold_start(params)
            lam_prev = torch.zeros(1, N, 18, device=self.device)
            lami_prev = torch.zeros(1, N, 36, device=self.device)
            shift = 0
        else:
            X_prev, U_prev = self._X_prev, self._U_prev
            lam_prev, lami_prev = self._lam_prev, self._lami_prev
            shift = node - self.last_node
        n_iter = (self.config_opt.max_iter_first if self.first_solve
                  else self.config_opt.max_iter)
        sol, lam, plan = self._plan(X_prev, U_prev, lam_prev, lami_prev, shift,
                                    params, n_iter)
        self._X_prev, self._U_prev = sol.X, sol.U
        self._lam_prev, self._lami_prev = lam, sol.lam_ineq
        self.last_node = node
        n = self.n_interp_plan
        dt_sol = sol.dt_sol(None)
        host = torch.cat([t.reshape(-1) for t in plan] + (
            [] if dt_sol is None else [dt_sol.reshape(-1)]) + [sol.stats.cost]).cpu().numpy()
        # the node durations of this plan: the optimized ones in the
        # time-optimal mode (dt_plan_full records the first)
        self._last_dt_sol = (np.full(N, self.dt_nodes) if dt_sol is None
                             else host[-1 - N:-1].astype(np.float64))
        if not np.isfinite(host[-1]):
            raise SolverDiverged(f"solver diverged: {sol.stats}")
        out, i = [], 0
        for shape in ((n, self.nv), (n, self.nv), (n, self.nv), (n, self.n_foot, 3),
                      (n, self.nu)):
            size = int(np.prod(shape))
            out.append(host[i:i + size].reshape(shape).astype(np.float64))
            i += size
        return tuple(out)

    # ------------------------------------------------------------------
    def _replan(self) -> bool:
        replan = self.sim_step % self.replanning_steps == 0
        if self.solve_async:
            replan &= not self.plan_submitted
        return replan

    def _step(self) -> None:
        self.increment_base_ref_position()
        self.sim_step += 1
        self.plan_step += 1
        if self.plan_step >= self.n_interp_plan:
            self.plan_step = self.n_interp_plan - 1

    def compute_torques_dof(self, mj_data) -> None:
        """1 kHz control: feed-forward torques of the interpolated plan plus
        joint PD, into ``torques_dof``. Host numpy only."""
        t, q_mj, v_mj = mj_data.time, mj_data.qpos, mj_data.qvel
        t = round(t - self.t0, 4)
        q, v = tnp.convert_from_mujoco(np.asarray(q_mj), np.asarray(v_mj))

        if not self.first_solve:
            if t + self._phase_time_offset >= (self.current_opt_node + 1) * self.dt_nodes:
                self.current_opt_node += 1

        if self._replan() and not self.diverged:
            self.start_time = t
            self.optimize_future = self.executor.submit(self.optimize, q, v)
            self.plan_submitted = True
            if self.print_info:
                print(f"## Replan | node {self.current_opt_node} t {t} step {self.sim_step}")
            if not self.solve_async:
                try:
                    self.optimize_future.result()
                except Exception:
                    pass  # re-raised (and handled) in the pickup block below

        if (self.plan_submitted and self.solve_async
                and self.async_sim_latency is not None and not self.first_solve):
            # the plan is picked up async_sim_latency simulated seconds after
            # submission; block if the worker is slower than the sim clock
            if (t - self.start_time) >= self.async_sim_latency - 1e-9:
                try:
                    self.optimize_future.result()
                except Exception:
                    pass
                plan_ready = True
            else:
                plan_ready = False
        elif self.plan_submitted and self.first_solve:
            # block for the very first plan; the stiff start-up PD holds the
            # robot meanwhile
            try:
                self.optimize_future.result()
            except Exception:
                pass
            plan_ready = True
        else:
            plan_ready = self.plan_submitted and self.optimize_future.done()

        if plan_ready:
            try:
                q_plan, v_plan, a_plan, f_plan, tau_ff = self.optimize_future.result()
                self.q_plan, self.v_plan, self.a_plan = q_plan, v_plan, a_plan
                self.f_plan, self.tau_ff_plan = f_plan, tau_ff
                if self.solve_async and not self.first_solve:
                    replanning_time = t - self.start_time
                    self.delay = max(math.ceil(replanning_time / self.sim_dt) - 1, 0)
                else:
                    self.delay = 0
                self.plan_step = self.delay
                self.plan_submitted = False
                self.first_solve = False
            except Exception:
                print("Optimization error:\n", traceback.format_exc())
                self.optimize_future = Future()
                self.plan_submitted = False
                if self._recoveries_left > 0:
                    # cold reboot: drop the warm start, hold the current
                    # posture under the start-up PD and re-enter through the
                    # phase-aligned boot. The replan clock restarts with it:
                    # the JAX package leaves sim_step off the replan grid
                    # after an async pickup, so it never replans again.
                    self._recoveries_left -= 1
                    self._X_prev = self._U_prev = None
                    self._lam_prev = self._lami_prev = None
                    self.first_solve = True
                    self.sim_step = 0
                    self.q_plan[:] = q[None]
                    self.v_plan[:] = 0.0
                    self._phase_time_offset = self.current_opt_node * self.dt_nodes
                    print(f"[mpc] cold reboot after divergence "
                          f"({self._recoveries_left} recoveries left)")
                else:
                    self.diverged = True

        if self.first_solve:
            torques_ff = np.zeros(self.nu)
            self.t0 = mj_data.time
            if np.all(self.q_plan[0] == 0.0):
                self.q_plan[:] = q[None]
            Kp, Kd = 44.0, 5.0
        else:
            torques_ff = self.tau_ff_plan[self.plan_step]
            Kp, Kd = self.Kp, self.Kd
            self.q_full.append(q.copy())
            self.v_full.append(v.copy())
            k = self.plan_step
            self.q_plan_full.append(self.q_plan[k].copy())
            self.v_plan_full.append(self.v_plan[k].copy())
            self.a_plan_full.append(self.a_plan[k].copy())
            self.f_plan_full.append(self.f_plan[k].copy())
            self.tau_plan_full.append(self.tau_ff_plan[k].copy())
            self.dt_plan_full.append(float(self._last_dt_sol[0]))
            self._step()

        torques_pd = (
            torques_ff
            + Kp * (self.q_plan[self.plan_step, -self.nu:] - q[-self.nu:])
            + Kd * (self.v_plan[self.plan_step, -self.nu:] - v[-self.nu:])
        )
        self.tau_full.append(torques_pd.copy())
        self.torques_dof[-self.nu:] = torques_pd

    # ------------------------------------------------------------------
    def open_loop(self, q_mj: np.ndarray, v_mj: np.ndarray, trajectory_time: float):
        """MPC without a plant: follow each plan's interpolated states and
        replan on the replanning grid. Returns the MuJoCo-layout q rows."""
        q_traj = []
        sim_time = 0.0
        q, v = tnp.convert_from_mujoco(np.asarray(q_mj), np.asarray(v_mj))
        while sim_time <= trajectory_time:
            if sim_time >= (self.current_opt_node + 1) * self.dt_nodes:
                self.current_opt_node += 1
            if self.sim_step % self.replanning_steps == 0:
                q_plan, v_plan, *_ = self.optimize(q, v)
                self.q_plan, self.v_plan = q_plan, v_plan
                self.plan_step = 0
                self.first_solve = False
            q = self.q_plan[self.plan_step]
            v = self.v_plan[self.plan_step]
            q_mj_k, _ = tnp.convert_to_mujoco(q, v)
            q_traj.append(q_mj_k)
            self._step()
            sim_time += self.sim_dt
        return np.array(q_traj)

    def plot_traj(self, var_name: str, save_path: Optional[str] = None):
        """Plot a recorded trajectory over time, 3 panels a row, the
        time-aligned plan dashed over the realized one where both exist:
        'q', 'v', 'tau' realized and plan; 'a', 'f', 'dt' the plan only
        (nothing measures them). Returns the matplotlib figure, saved to
        ``save_path`` if given. matplotlib is imported here only."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        spec_map = {
            "q": ("q_full", "q_plan_full"),
            "v": ("v_full", "v_plan_full"),
            "tau": ("tau_full", "tau_plan_full"),
            "a": (None, "a_plan_full"),
            "f": (None, "f_plan_full"),
            "dt": (None, "dt_plan_full"),
        }
        if var_name not in spec_map:
            raise ValueError(f"No recorded trajectory for '{var_name}'."
                             f" Choose from: {sorted(spec_map)}.")
        real_attr, plan_attr = spec_map[var_name]

        def stack(attr):
            rows = getattr(self, attr, None)
            if not rows:
                return None
            arr = np.asarray(rows)
            if arr.ndim == 1:
                arr = arr[:, None]
            return arr.reshape(arr.shape[0], -1)

        traj = stack(real_attr) if real_attr else None
        plan = stack(plan_attr)
        base = traj if traj is not None else plan
        if base is None:
            raise ValueError(f"No recorded data for '{var_name}' yet.")
        n, dims = base.shape
        t = np.arange(n) * self.sim_dt
        rows = (dims + 2) // 3
        fig, axs = plt.subplots(rows, 3, figsize=(15, 3 * rows))
        axs = np.atleast_1d(axs).ravel()
        for i in range(dims):
            if traj is not None:
                axs[i].plot(t, traj[:, i], label="realized")
            if plan is not None:
                tp = np.arange(plan.shape[0]) * self.sim_dt
                axs[i].plot(tp, plan[:, i], "--", label="plan")
            axs[i].set_title(f"{var_name}[{i}]")
            axs[i].grid(True)
            if i == 0 and traj is not None and plan is not None:
                axs[i].legend(loc="best", fontsize=8)
        for i in range(dims, len(axs)):
            fig.delaxes(axs[i])
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=110, bbox_inches="tight")
        return fig

    def print_timings(self):
        print()
        print_timings(self.timings)

    def close(self) -> None:
        """Stop the worker thread and the teleop."""
        if self.executor is not None:
            self.executor.shutdown(wait=True, cancel_futures=True)
            self.executor = None
        if self.velocity_goal is not None:
            self.velocity_goal.stop()

    def __del__(self):
        try:
            self.executor.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        if getattr(self, "velocity_goal", None) is not None:
            self.velocity_goal.stop()
