"""Batched quadruped rigid-body dynamics: FK, foot velocities, RNEA, the
mass matrix, CoM and forward dynamics.

Counterpart of ``iterative_learning_nmpc_tpu/models/dynamics.py``. Every
function takes tensors with any leading batch dims: q, v, a (..., 18),
f_ext_feet (..., 4, 3). The four legs, structurally identical 3-revolute
chains, are one more broadcast dim of size 4. World-frame Newton-Euler in
the Euler chart; gravity enters as an upward base acceleration.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..robots.spec import RobotSpec
from .math3d import (
    cross,
    euler_rate_matrix,
    euler_rate_matrix_dot,
    matvec,
    rotation_about_axis,
    ypr_to_matrix,
)

GRAVITY = 9.81


def _leg_arrays(spec: RobotSpec):
    jp = spec.joint_pos[6:].reshape(4, 3, 3)
    ax = spec.joint_axis[6:].reshape(4, 3, 3)
    m = spec.mass[6:].reshape(4, 3)
    com = spec.com[6:].reshape(4, 3, 3)
    Ic = spec.inertia[6:].reshape(4, 3, 3, 3)
    return jp, ax, m, com, Ic


def _leg_frames(spec: RobotSpec, q: torch.Tensor):
    """Per-leg link rotations/origins: lists over the 3 links of
    (..., 4, 3, 3) / (..., 4, 3) tensors, plus the foot points (..., 4, 3)."""
    jp, ax, *_ = _leg_arrays(spec)
    R_p = ypr_to_matrix(q[..., 3:6]).unsqueeze(-3)           # (..., 1, 3, 3)
    p_p = q[..., None, :3]                                    # (..., 1, 3)
    q_legs = q[..., 6:].reshape(q.shape[:-1] + (4, 3))
    Rs, ps, axs = [], [], []
    for k in range(3):
        axs.append(matvec(R_p, ax[:, k]))
        p_k = p_p + matvec(R_p, jp[:, k])
        R_p = R_p @ rotation_about_axis(ax[:, k], q_legs[..., k])
        p_p = p_k
        Rs.append(R_p)
        ps.append(p_k)
    p_foot = ps[2] + matvec(Rs[2], spec.foot_offset)
    return Rs, ps, axs, p_foot


def foot_positions(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """World foot points (..., 4, 3)."""
    return _leg_frames(spec, q)[3]


def settled_state(spec: RobotSpec) -> np.ndarray:
    """The settled nominal state (36,) float32: q_home raised so that the
    feet rest on the ground, at rest."""
    q0 = spec.q_home.detach().cpu().numpy().astype(np.float32).copy()
    p0 = foot_positions(spec.to("cpu"), torch.as_tensor(q0)).numpy()
    q0[2] += -p0[0, 2] + float(spec.foot_radius)
    return np.concatenate([q0, np.zeros(18, np.float32)])


def _base_rates(q, v):
    ypr, ypr_d = q[..., 3:6], v[..., 3:6]
    R_b = ypr_to_matrix(ypr)
    T = euler_rate_matrix(ypr)
    w_b = matvec(R_b, matvec(T, ypr_d))
    return R_b, T, w_b


def foot_velocities(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """World foot-point linear velocities (..., 4, 3)."""
    Rs, ps, axs, p_foot = _leg_frames(spec, q)
    _, _, w_b = _base_rates(q, v)
    qd_legs = v[..., 6:].reshape(v.shape[:-1] + (4, 3))
    w_p = w_b.unsqueeze(-2)
    v_p = v[..., None, :3]
    p_p = q[..., None, :3]
    for k in range(3):
        v_p = v_p + cross(w_p, ps[k] - p_p)
        w_p = w_p + axs[k] * qd_legs[..., k:k + 1]
        p_p = ps[k]
    return v_p + cross(w_p, p_foot - ps[2])


def rnea(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         f_ext_feet: Optional[torch.Tensor] = None,
         gravity: float = GRAVITY) -> torch.Tensor:
    """World-frame Newton-Euler inverse dynamics (..., 18):
    tau = M(q) a + C(q, v) v + g(q) - J^T f_ext."""
    jp, ax, m_legs, com_legs, Ic_legs = _leg_arrays(spec)
    ypr_d, ypr_dd = v[..., 3:6], a[..., 3:6]
    R_b, T, w_b = _base_rates(q, v)
    # d/dt (R_b T ypr_d) = R_b (dT ypr_d + T ypr_dd); the R_b' term is
    # R_b (w_l x w_l) = 0
    Td = euler_rate_matrix_dot(q[..., 3:6], ypr_d)
    dw_b = matvec(R_b, matvec(Td, ypr_d) + matvec(T, ypr_dd))
    p_b = q[..., :3]
    g_vec = torch.zeros(3, dtype=q.dtype, device=q.device)
    g_vec[2] = gravity
    dv_b = a[..., :3] + g_vec

    lead = q.shape[:-1]
    q_legs = q[..., 6:].reshape(lead + (4, 3))
    qd_legs = v[..., 6:].reshape(lead + (4, 3))
    qdd_legs = a[..., 6:].reshape(lead + (4, 3))

    R_p = R_b.unsqueeze(-3)
    p_p = p_b.unsqueeze(-2)
    w_p, v_p = w_b.unsqueeze(-2), v[..., None, :3]
    dw_p, dv_p = dw_b.unsqueeze(-2), dv_b.unsqueeze(-2)
    Fs, Ms, pjs, axs = [], [], [], []
    for k in range(3):
        a_w = matvec(R_p, ax[:, k])
        R_k = R_p @ rotation_about_axis(ax[:, k], q_legs[..., k])
        p_k = p_p + matvec(R_p, jp[:, k])
        r = p_k - p_p
        v_k = v_p + cross(w_p, r)
        dv_k = dv_p + cross(dw_p, r) + cross(w_p, cross(w_p, r))
        w_k = w_p + a_w * qd_legs[..., k:k + 1]
        dw_k = (dw_p + a_w * qdd_legs[..., k:k + 1]
                + cross(w_p, a_w * qd_legs[..., k:k + 1]))
        c_w = matvec(R_k, com_legs[:, k])
        x_c = p_k + c_w
        a_c = dv_k + cross(dw_k, c_w) + cross(w_k, cross(w_k, c_w))
        I_w = R_k @ Ic_legs[:, k] @ R_k.transpose(-1, -2)
        F = m_legs[:, k:k + 1] * a_c
        Nm = matvec(I_w, dw_k) + cross(w_k, matvec(I_w, w_k))
        Fs.append(F)
        Ms.append(Nm + cross(x_c, F))
        pjs.append(p_k)
        axs.append(a_w)
        R_p, p_p, w_p, v_p, dw_p, dv_p = R_k, p_k, w_k, v_k, dw_k, dv_k

    p_f = pjs[2] + matvec(R_p, spec.foot_offset)
    f_ext = (torch.zeros(lead + (4, 3), dtype=q.dtype, device=q.device)
             if f_ext_feet is None else f_ext_feet.to(q.dtype))
    Fs.append(-f_ext)
    Ms.append(cross(p_f, -f_ext))

    tau_legs = []
    for k in range(3):
        S_F = sum(Fs[k:])
        S_M = sum(Ms[k:])
        tau_legs.append((axs[k] * (S_M - cross(pjs[k], S_F))).sum(-1))
    tau_legs = torch.stack(tau_legs, dim=-1)                  # (..., 4, 3)
    F_legs = sum(Fs).sum(-2)
    M_legs = sum(Ms).sum(-2)

    m_t = spec.mass[5]
    c_w = matvec(R_b, spec.com[5])
    x_c = p_b + c_w
    a_c = dv_b + cross(dw_b, c_w) + cross(w_b, cross(w_b, c_w))
    I_w = R_b @ spec.inertia[5] @ R_b.transpose(-1, -2)
    F_t = m_t * a_c
    M_t = matvec(I_w, dw_b) + cross(w_b, matvec(I_w, w_b)) + cross(x_c, F_t)

    F_tot = F_t + F_legs
    M_tot = M_t + M_legs
    n_base_w = M_tot - cross(p_b, F_tot)
    n_local = matvec(R_b.transpose(-1, -2), n_base_w)
    tau_ang = matvec(T.transpose(-1, -2), n_local)
    return torch.cat([F_tot, tau_ang, tau_legs.reshape(lead + (12,))], dim=-1)


def bias_forces(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """C(q, v) v + g(q), (..., 18)."""
    return rnea(spec, q, v, torch.zeros_like(v))


def mass_matrix(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia M(q), (..., 18, 18): one RNEA per unit
    acceleration at zero velocity and zero gravity, symmetrised."""
    nv = q.shape[-1]
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    qe = q.unsqueeze(-2).expand(q.shape[:-1] + (nv, nv))
    cols = rnea(spec, qe, torch.zeros_like(qe), eye.expand_as(qe), gravity=0.0)
    return 0.5 * (cols + cols.transpose(-1, -2))


def id_torques(spec: RobotSpec, q, v, a, f_feet) -> torch.Tensor:
    """Feed-forward joint torques (..., 12)."""
    return rnea(spec, q, v, a, f_ext_feet=f_feet)[..., 6:]


def com_position(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """Whole-body centre of mass (..., 3): the trunk (body 5) and the 12
    leg links at their FK poses."""
    Rs, ps, _, _ = _leg_frames(spec, q)
    com_legs = spec.com[6:].reshape(4, 3, 3)
    m_legs = spec.mass[6:].reshape(4, 3)
    x_trunk = q[..., :3] + matvec(ypr_to_matrix(q[..., 3:6]), spec.com[5])
    acc = spec.mass[5] * x_trunk
    for k in range(3):
        x_k = ps[k] + matvec(Rs[k], com_legs[:, k])           # (..., 4, 3)
        acc = acc + (m_legs[:, k, None] * x_k).sum(-2)
    return acc / spec.mass[5:].sum()


def forward_dynamics(spec: RobotSpec, q, v, tau_joints, f_ext_feet=None) -> torch.Tensor:
    """Accelerations (..., 18) from joint torques (..., 12) and world foot
    forces: M(q) a = [0, tau] - rnea(q, v, 0, f_ext), by Cholesky."""
    tau_full = torch.cat([torch.zeros(q.shape[:-1] + (6,), dtype=q.dtype,
                                      device=q.device), tau_joints], dim=-1)
    rhs = tau_full - rnea(spec, q, v, torch.zeros_like(v), f_ext_feet=f_ext_feet)
    L = torch.linalg.cholesky(mass_matrix(spec, q))
    return torch.cholesky_solve(rhs.unsqueeze(-1), L).squeeze(-1)
