"""The whole-body OCP of a configuration: weights and residual rows.

Residual layout of one node (142 rows): base tracking 12, joint tracking
24, joint acceleration 12, force regularisation 12, swing-foot zero force
12, swing peak 4, foot displacement 8, contact patch 4, centroidal dynamics
6, stance foot pinning 12, friction cone 20, swing clearance 4, torque-limit
hinge 12. The terminal node has 40 (base 12, joints 24, swing peak 4). The
state is [q, v] (36), the input [a (18), f (4 x 3)] (30); the shooting
dynamics are the exact double integrator in the chart.

Shifted hinges (the augmented Lagrangian's inequality rows): with shift
s > 0 the row is g + s, else max(g, 0); ``torch.maximum`` gives the
derivative 1/2 at g == 0 under forward mode.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import dynamics as dyn
from .robot import Robot

NX, NU = 36, 30
NC_CONE, NC_TORQUE, NC_PATCH = 20, 12, 4


@dataclasses.dataclass(frozen=True)
class Weights:
    base: torch.Tensor
    base_e: torch.Tensor
    joint: torch.Tensor
    joint_e: torch.Tensor
    acc: torch.Tensor
    swing: torch.Tensor
    f_reg: torch.Tensor
    foot_disp: float
    stab_gain: torch.Tensor
    dyn_cons: float
    contact_vel: float
    cone: float
    swing_clear: float
    torque: float
    patch: float
    mu: float
    total_weight: float


def make_weights(opt: dict, cost: dict, robot: Robot, dtype, device) -> Weights:
    """Square-root weights from a configuration's ``opt`` and ``cost``."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    sq = lambda x: t(np.sqrt(np.asarray(x, np.float64)))
    return Weights(
        base=sq(cost["W_base"]), base_e=sq(cost["W_e_base"]), joint=sq(cost["W_joint"]),
        joint_e=sq(cost["W_e_joint"]), acc=sq(cost["W_acc"]), swing=sq(cost["W_swing"]),
        f_reg=sq(cost["W_cnt_f_reg"]), foot_disp=float(np.sqrt(cost["W_foot_displacement"][0])),
        stab_gain=t(cost["W_foot_pos_constr_stab"]), dyn_cons=float(np.sqrt(opt["w_dyn"])),
        contact_vel=float(np.sqrt(opt["w_contact"])), cone=float(np.sqrt(opt["w_cone"])),
        swing_clear=float(np.sqrt(opt["w_swing_height"])),
        torque=float(np.sqrt(opt["w_torque"])), patch=float(np.sqrt(opt["w_patch"])),
        mu=float(opt["mu"]), total_weight=dyn.GRAVITY * float(robot.total_mass()))


def hinge(g):
    return torch.maximum(g, torch.zeros_like(g))


def hinge_shifted(g, s):
    on = (s > 0.0).to(g.dtype)
    return on * (g + s) + (1.0 - on) * hinge(g)


def cone_values(f, mu):
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([-fz, fx - mu * fz, -fx - mu * fz, fy - mu * fz, -fy - mu * fz], -1)


def dynamics_step(x, u, dt):
    q, v, a = x[..., :18], x[..., 18:], u[..., :18]
    dt = dt[..., None]
    return torch.cat([q + dt * v + 0.5 * dt * dt * a, v + dt * a], dim=-1)


def _core(robot, x, u, cnt):
    q, v = x[..., :18], x[..., 18:]
    f_eff = cnt[..., None] * u[..., 18:30].reshape(u.shape[:-1] + (4, 3))
    return (f_eff, dyn.foot_positions(robot, q), dyn.foot_velocities(robot, q, v),
            dyn.rnea(robot, q, v, u[..., :18], f_eff))


def _tracking(x, base_ref, joint_ref, w_base, w_joint):
    q, v = x[..., :18], x[..., 18:]
    rb = torch.cat([q[..., :6] - base_ref[..., :6], v[..., :6] - base_ref[..., 6:]], -1) * w_base
    rj = torch.cat([q[..., 6:] - joint_ref, v[..., 6:]], -1) * w_joint
    return rb, rj


def stage_residual(robot: Robot, w: Weights, x, u, nd: dict, include_torque=True):
    """Rows of one node; ``nd`` holds the node's parameters: cnt, peak,
    plane (4, 3), loc (4, 3), patch (4,), restrict, base_ref, joint_ref,
    step_height, lam (18,), lam_ineq (36,), each with the leading dims."""
    cnt, lam, li = nd["cnt"], nd["lam"], nd["lam_ineq"]
    f_eff, p_feet, v_feet, tau = _core(robot, x, u, cnt)
    f = u[..., 18:30].reshape(u.shape[:-1] + (4, 3))
    cnt3, rst = cnt[..., None], nd["restrict"][..., None]
    flat = lambda t, n: t.reshape(t.shape[:-2] + (n,))
    rb, rj = _tracking(x, nd["base_ref"], nd["joint_ref"], w.base, w.joint)
    ra = u[..., 6:18] * w.acc
    fz_ref = cnt * w.total_weight / torch.clamp_min(cnt.sum(-1), 1.0)[..., None]
    f_ref = torch.stack([torch.zeros_like(fz_ref), torch.zeros_like(fz_ref), fz_ref], -1)
    rf = flat((f_eff - f_ref) * w.f_reg, 12)
    rf_zero = flat((1.0 - cnt3) * f, 12)
    r_swing = nd["peak"] * (p_feet[..., 2] - nd["step_height"][..., None]) * w.swing
    d_xy = p_feet[..., :2] - nd["loc"][..., :2]
    r_disp = flat(rst[..., None] * cnt3 * d_xy, 8) * w.foot_disp
    dist = torch.sqrt((d_xy * d_xy).sum(-1) + 1.0e-12)
    r_patch = rst * cnt * hinge_shifted(dist - nd["patch"], li[..., 32:36]) * w.patch
    r_dyn = tau[..., :6] * w.dyn_cons + lam[..., :6]
    pin_z = v_feet[..., 2] + w.stab_gain * (p_feet[..., 2] - nd["plane"][..., 2])
    pin = torch.cat([v_feet[..., :2], pin_z[..., None]], -1)
    r_cnt = flat(cnt3 * pin, 12) * w.contact_vel + torch.repeat_interleave(cnt, 3, -1) * lam[..., 6:]
    s_c = cnt3 * li[..., :20].reshape(cnt.shape + (5,))
    cone = flat(hinge_shifted(cone_values(f_eff, w.mu), s_c), 20) * w.cone
    r_clear = (1.0 - cnt) * hinge(nd["plane"][..., 2] - p_feet[..., 2]) * w.swing_clear
    parts = [rb, rj, ra, rf, rf_zero, r_swing, r_disp, r_patch, r_dyn, r_cnt, cone, r_clear]
    if include_torque:
        g_tau = torch.abs(tau[..., 6:]) - robot.torque_limit
        parts.append(hinge_shifted(g_tau, li[..., 20:32]) * w.torque)
    return torch.cat(parts, dim=-1)


def terminal_residual(robot: Robot, w: Weights, x, peak, base_ref_e, joint_ref, step_height):
    rb, rj = _tracking(x, base_ref_e, joint_ref, w.base_e, w.joint_e)
    p_feet = dyn.foot_positions(robot, x[..., :18])
    return torch.cat([rb, rj, peak * (p_feet[..., 2] - step_height[..., None]) * w.swing], -1)


def equality_rows(robot: Robot, w: Weights, x, u, nd: dict):
    """The bare equality rows (..., 18): the multiplier update's input."""
    cnt = nd["cnt"]
    _, p_feet, v_feet, tau = _core(robot, x, u, cnt)
    pin_z = v_feet[..., 2] + w.stab_gain * (p_feet[..., 2] - nd["plane"][..., 2])
    pin = torch.cat([v_feet[..., :2], pin_z[..., None]], -1)
    r_cnt = (cnt[..., None] * pin).reshape(cnt.shape[:-1] + (12,)) * w.contact_vel
    return torch.cat([tau[..., :6] * w.dyn_cons, r_cnt], dim=-1)


def ineq_values(robot: Robot, w: Weights, x, u, nd: dict):
    """Raw inequality values (..., 36): cone 20, torque 12, patch 4."""
    cnt = nd["cnt"]
    f_eff, p_feet, _, tau = _core(robot, x, u, cnt)
    g_cone = cone_values(f_eff, w.mu).reshape(cnt.shape[:-1] + (20,))
    g_tau = torch.abs(tau[..., 6:]) - robot.torque_limit
    d_xy = p_feet[..., :2] - nd["loc"][..., :2]
    dist = torch.sqrt((d_xy * d_xy).sum(-1) + 1.0e-12)
    g_patch = nd["restrict"][..., None] * cnt * (dist - nd["patch"])
    return torch.cat([g_cone, g_tau, g_patch], dim=-1)
