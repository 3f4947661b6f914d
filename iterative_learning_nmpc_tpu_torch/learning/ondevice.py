"""Batched closed-loop MPC rollouts on the device: expert datagen and its
SafeDAgger mode.

Counterpart of ``iterative_learning_nmpc_tpu/learning/ondevice.py``. The
environments are one batch of the solver (a batch of B > 1 problems takes
the lingram, riccati and dyncore kernels, a single one the dynjac route);
the solver's per-problem freezing is what ``jax.vmap`` of the JAX
package's while loops does. Per replanning interval (one OCP node):

  - OCP parameters from the gait table and the integrated goal reference
    (the running base reference leads 75 % of the way to the terminal one),
  - warm start and both AL multipliers shifted by one node, the first
    state set to the plant's, one RTI solve, the equality multipliers
    updated from the solve's rows,
  - the first interval of the plan Hermite-interpolated to the control
    rate, feed-forward torques by RNEA along it;

per control step: MPC torque (feed-forward + joint PD, clipped), the 44-dim
dataset row recorded before the plant step, in SafeDAgger mode the policy's
torque (``network.ServedPolicy``, by its route) and the hysteresis switch, the action encoded as
a PD target, the scheduled base push, the plant step on per-environment
terrain; at the end of each interval the fall test freezes ``valid``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..gait.planner import ContactPlanner
from ..models import dynamics as dyn
from ..mpc.config import get_quadruped_config
from ..mpc.interpolate import hermite_interp
from ..ocp.problem import NC_INEQ, OCPParams
from ..robots.spec import RobotSpec
from ..sim import device_sim
from ..solver.sqp import TrajOptSolver
from .network import ServedPolicy
from .obs import policy_state
from .randomize import TerrainParams
from .safety import UNSAFE_HEIGHT_BOUNDS, VEL_TRACK_TOL, unsafe_v2, upright


class RolloutBatch(NamedTuple):
    """Per-env, per-step dataset rows (B, T, ...)."""

    q: torch.Tensor          # (B, T, 18) chart positions
    v: torch.Tensor          # (B, T, 18)
    state44: torch.Tensor    # (B, T, 44) policy-state rows
    action: torch.Tensor     # (B, T, 12) PD-target actions
    tau: torch.Tensor        # (B, T, 12) applied torques
    valid: torch.Tensor      # (B, T) 1 until the env fell
    is_expert: torch.Tensor  # (B, T) 1 where the MPC expert was in control


def make_batched_mpc_rollout(
    spec: RobotSpec,
    gait_name: str = "trot",
    n_intervals: int = 50,
    sim_dt: float = 1.0e-3,
    kd_action: float = 1.5,
    contact_params: Optional[device_sim.ContactParams] = None,
    policy=None,
    policy_kp: float = 20.0,
    policy_kd: float = 1.5,
    delay_steps: int = 100,
    mpc_min_steps: int = 2500,
    unsafe_height_bounds=None,
    vel_track_tol: Optional[float] = None,
    device=None,
):
    """Build the batched closed-loop rollout on ``device`` (by default the
    CUDA card).

    Returns fn(x0 (B, 36), v_des (B, 3), plant_spec=None, terrain=None,
    policy_update=None, force_windows=None) -> RolloutBatch with T =
    n_intervals * steps_per_interval rows per env.

    ``policy`` ((net, norm) from ``network.load_policy``) turns on
    SafeDAgger mode: the policy and the expert both act every step; the
    policy is in control for the first ``delay_steps``, then ``unsafe_v2``
    hands control to the MPC, latched for at least ``mpc_min_steps``; every
    row carries ``is_expert``.
    ``policy_update=(weights, norm)`` serves other weights (a net or a
    Flax-layout variables dict) and norm stats for one call.
    ``terrain`` (``randomize.TerrainParams``) gives per-env ground height
    and contact parameters; ``force_windows`` (B, 5) per-env base pushes
    [start_step, end_step, fx, fy, fz]. A per-env ``plant_spec`` (payload
    randomization) is not ported and raises."""
    dev = resolve_device(device)
    spec = spec.to(dev)
    gait, opt, cost = get_quadruped_config(gait_name, spec.name)
    solver = TrajOptSolver(spec, opt, cost, device=dev)
    N, dt_nodes = solver.N, solver.dt_nodes
    steps = int(round(dt_nodes / sim_dt))          # control steps per interval
    planner = ContactPlanner(spec.feet_frame_names, dt_nodes, gait)
    cycle = planner.nodes_per_cycle
    f32 = dict(dtype=torch.float32, device=dev)
    cnt_table = torch.as_tensor(np.stack(
        [planner.get_contacts(k, N + 1) for k in range(cycle)]).astype(np.float32),
        device=dev)                                # (cycle, 4, N+1)
    ground = float(spec.foot_radius)
    nom_h, step_h = gait.nom_height + ground, gait.step_height + ground
    cp = contact_params or device_sim.contact_params_for(spec, device=dev)
    Kp, Kd = opt.Kp, opt.Kd
    tl = spec.torque_limit
    height_bounds = unsafe_height_bounds or UNSAFE_HEIGHT_BOUNDS
    v_tol = vel_track_tol if vel_track_tol is not None else VEL_TRACK_TOL
    served0 = None if policy is None else ServedPolicy(*policy, device=dev)
    t_knots = torch.cat([torch.zeros(1, **f32),
                         torch.cumsum(torch.full((N,), dt_nodes, **f32), 0)])
    t_q = (torch.arange(steps, **f32) + 1.0) * sim_dt

    def params_for(node_i: int, x, ref, v_des, const) -> OCPParams:
        """One interval's OCP parameters for every env: x (B, 36), ref (B, 3)
        the integrated goal [x, y, yaw], v_des (B, 3)."""
        B = x.shape[0]
        cnt = cnt_table[node_i % cycle].expand(B, 4, N + 1).contiguous()
        ref_e_xy = ref[:, :2] + v_des[:, :2] * opt.time_horizon
        run_xy = x[:, :2] + (ref_e_xy - x[:, :2]) * 0.75
        base_ref = torch.zeros(B, 12, **f32)
        base_ref[:, :2] = run_xy
        base_ref[:, 2] = nom_h
        base_ref[:, 3] = ref[:, 2]
        base_ref[:, 6:9] = v_des
        base_ref_e = base_ref.clone()
        base_ref_e[:, :2] = ref_e_xy
        return OCPParams(x0=x, cnt=cnt, peak=1.0 - cnt, base_ref=base_ref,
                         base_ref_e=base_ref_e, **const)

    def fn(x0, v_des, plant_spec=None, terrain=None, policy_update=None,
           force_windows=None) -> RolloutBatch:
        if plant_spec is not None:
            raise NotImplementedError(
                "per-env payload randomization (randomize_payload) is not ported "
                "(ROADMAP Queue 1, 'Batched datagen, the rest')")
        x0 = torch.as_tensor(x0, **f32)
        v_des = torch.as_tensor(v_des, **f32)
        B, T = x0.shape[0], n_intervals * steps
        if terrain is None:
            terrain = TerrainParams(
                ground_height=torch.zeros(B, **f32),
                contact=device_sim.ContactParams(
                    *(getattr(cp, f).expand(B) for f in
                      ("stiffness", "damping", "friction_mu", "vel_smoothing"))))
        served = served0
        if served0 is not None and policy_update is not None:
            served = ServedPolicy(*policy_update, device=dev)
        fw = (torch.zeros(B, 5, **f32) if force_windows is None
              else torch.as_tensor(force_windows, **f32))
        fw_start, fw_end = fw[:, 0].to(torch.int32), fw[:, 1].to(torch.int32)
        plane = torch.zeros(B, 4, N + 1, 3, **f32)
        plane[..., 2] = ground
        const = dict(
            plane_point=plane, cnt_loc=torch.zeros(B, 4, N + 1, 3, **f32),
            patch_radius=torch.full((B, 4, N + 1), 1.0e3, **f32),
            restrict=torch.zeros(B, **f32),
            joint_ref=spec.q_home[6:].expand(B, 12).contiguous(),
            step_height=torch.full((B,), step_h, **f32),
            dt=torch.full((B, N), dt_nodes, **f32),
            lam_eq=torch.zeros(B, N, 18, **f32),
            lam_ineq=torch.zeros(B, N, NC_INEQ, **f32))

        # the first plan: cold start, six SQP iterations
        ref = torch.cat([x0[:, :2], x0[:, 3:4]], dim=1)
        p0 = params_for(0, x0, ref, v_des, const)
        sol = solver.solve(*solver.cold_start(p0), p0, 6)
        X_prev, U_prev, lam, lami = sol.X, sol.U, const["lam_eq"], sol.lam_ineq

        out = RolloutBatch(
            q=torch.empty(B, T, 18, **f32), v=torch.empty(B, T, 18, **f32),
            state44=torch.empty(B, T, 44, **f32), action=torch.empty(B, T, 12, **f32),
            tau=torch.empty(B, T, 12, **f32), valid=torch.empty(B, T, **f32),
            is_expert=torch.empty(B, T, **f32))
        x = x0
        alive = torch.ones(B, **f32)
        # expert rollouts start (and stay) in MPC mode; SafeDAgger starts
        # with the policy in control
        mode = torch.full((B,), served is None, dtype=torch.bool, device=dev)
        mpc_cnt = torch.zeros(B, dtype=torch.int64, device=dev)
        stepc = 0
        for i in range(n_intervals):
            p = params_for(i, x, ref, v_des, const).replace(
                lam_eq=solver.shift_multipliers(lam, 1),
                lam_ineq=solver.shift_multipliers(lami, 1))
            X_ws, U_ws = solver.shift_warmstart(X_prev, U_prev, 1)
            X_ws = torch.cat([x[:, None], X_ws[:, 1:]], dim=1)
            sol = solver.solve(X_ws, U_ws, p, 1)
            lam = solver.update_multipliers(sol.X, sol.U, p, r_eq=sol.r_eq)
            X_prev, U_prev, lami = sol.X, sol.U, sol.lam_ineq

            # the plan's first interval at the control rate
            a = sol.U[..., :18]
            q_plan = hermite_interp(t_knots, sol.X[..., :18], sol.X[..., 18:], t_q)
            v_plan = hermite_interp(t_knots, sol.X[..., 18:],
                                    torch.cat([a[:, :1], a], dim=1), t_q)
            tau_ff = dyn.id_torques(spec, q_plan, v_plan, a[:, :1].expand(B, steps, 18),
                                    sol.U[:, :1, 18:].reshape(B, 1, 4, 3)
                                    .expand(B, steps, 4, 3))

            st = device_sim.SimState(x[:, :18], x[:, 18:], torch.zeros(B, **f32))
            for k in range(steps):
                q, v = st.q, st.v
                tau_mpc = torch.clamp(tau_ff[:, k] + Kp * (q_plan[:, k, 6:] - q[:, 6:])
                                      + Kd * (v_plan[:, k, 6:] - v[:, 6:]), -tl, tl)
                s44 = policy_state(spec, q, v)       # the row before the step
                if served is not None:
                    _, tau_pol = served(s44, v_des, q[:, 6:], v[:, 6:], policy_kp,
                                        policy_kd)
                    tau_pol = torch.clamp(tau_pol, -tl, tl)
                    unsafe = unsafe_v2(q, v, v_des, height_bounds, v_tol)
                    leave_mpc = (mpc_cnt + 1 >= mpc_min_steps) & ~unsafe
                    engage = unsafe if stepc >= delay_steps else torch.zeros_like(unsafe)
                    mode_new = torch.where(mode, ~leave_mpc, engage)
                    mpc_cnt = torch.where(mode_new, torch.where(mode, mpc_cnt + 1, 0), 0)
                    tau = torch.where(mode_new[:, None], tau_mpc, tau_pol)
                else:
                    mode_new, tau = mode, tau_mpc
                action = (tau + kd_action * v[:, 6:]) / Kp + q[:, 6:]
                in_win = (stepc >= fw_start) & (stepc < fw_end)
                f_ext = in_win.to(torch.float32)[:, None] * fw[:, 2:5]
                t = i * steps + k
                out.q[:, t], out.v[:, t], out.state44[:, t] = q, v, s44
                out.action[:, t], out.tau[:, t] = action, tau
                out.is_expert[:, t] = mode_new.to(torch.float32)
                st = device_sim.step(spec, st, tau, terrain.contact, sim_dt, f_ext=f_ext,
                                     ground_height=terrain.ground_height)
                mode = mode_new
                stepc += 1
            x = torch.cat([st.q, st.v], dim=1)
            alive = alive * upright(st.q).to(torch.float32)
            ref = ref + torch.cat([v_des[:, :2], torch.zeros(B, 1, **f32)], dim=1) * dt_nodes
            out.valid[:, i * steps:(i + 1) * steps] = alive[:, None]
        return out

    return fn
