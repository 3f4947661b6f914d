"""Plain rigid-body kinematics and inverse dynamics of a quadruped.

World-frame Newton-Euler over the four three-link legs, each leg one more
broadcast dim; the base is six explicit DOFs (x, y, z, then yaw, pitch,
roll as R = Rz Ry Rx), gravity enters as an upward base acceleration. Every
function takes tensors with any leading dims: q, v, a (..., 18), foot
forces (..., 4, 3).
"""
from __future__ import annotations

import torch

from .robot import Robot

GRAVITY = 9.81


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def matvec(M, x):
    return (M * x.unsqueeze(-2)).sum(-1)


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], dim=-2)


def rodrigues(axis, angle):
    """Rotation about unit ``axis`` (..., 3) by ``angle`` (...)."""
    K = skew(axis)
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def ypr_matrix(ypr):
    e = torch.eye(3, dtype=ypr.dtype, device=ypr.device)
    return (rodrigues(e[2], ypr[..., 0]) @ rodrigues(e[1], ypr[..., 1])
            @ rodrigues(e[0], ypr[..., 2]))


def euler_rate(ypr):
    """T with body angular velocity = T d/dt [yaw, pitch, roll]."""
    p, r = ypr[..., 1], ypr[..., 2]
    cx, sx, cy, sy = torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p)
    o, one = torch.zeros_like(cx), torch.ones_like(cx)
    return torch.stack([torch.stack([-sy, o, one], -1),
                        torch.stack([cy * sx, cx, o], -1),
                        torch.stack([cx * cy, -sx, o], -1)], dim=-2)


def euler_rate_dot(ypr, rate):
    p, r = ypr[..., 1], ypr[..., 2]
    pd, rd = rate[..., 1], rate[..., 2]
    cp, sp, cr, sr = torch.cos(p), torch.sin(p), torch.cos(r), torch.sin(r)
    o = torch.zeros_like(cp)
    return torch.stack([torch.stack([-cp * pd, o, o], -1),
                        torch.stack([-sp * pd * sr + cp * cr * rd, -sr * rd, o], -1),
                        torch.stack([-sp * pd * cr - cp * sr * rd, -cr * rd, o], -1)],
                       dim=-2)


def _legs(robot: Robot, q):
    """Link rotations and joint origins of the three links (lists of
    (..., 4, 3, 3) / (..., 4, 3)), joint axes in the world, foot points."""
    R_p = ypr_matrix(q[..., 3:6]).unsqueeze(-3)
    p_p = q[..., None, :3]
    ql = q[..., 6:].reshape(q.shape[:-1] + (4, 3))
    Rs, ps, axs = [], [], []
    for k in range(3):
        axs.append(matvec(R_p, robot.joint_axis[:, k]))
        p_k = p_p + matvec(R_p, robot.joint_pos[:, k])
        R_p = R_p @ rodrigues(robot.joint_axis[:, k], ql[..., k])
        p_p = p_k
        Rs.append(R_p)
        ps.append(p_k)
    return Rs, ps, axs, ps[2] + matvec(Rs[2], robot.foot_offset)


def foot_positions(robot: Robot, q):
    return _legs(robot, q)[3]


def _base_rates(q, v):
    R_b, T = ypr_matrix(q[..., 3:6]), euler_rate(q[..., 3:6])
    return R_b, T, matvec(R_b, matvec(T, v[..., 3:6]))


def foot_velocities(robot: Robot, q, v):
    Rs, ps, axs, p_foot = _legs(robot, q)
    _, _, w_b = _base_rates(q, v)
    qd = v[..., 6:].reshape(v.shape[:-1] + (4, 3))
    w_p, v_p, p_p = w_b.unsqueeze(-2), v[..., None, :3], q[..., None, :3]
    for k in range(3):
        v_p = v_p + cross(w_p, ps[k] - p_p)
        w_p = w_p + axs[k] * qd[..., k:k + 1]
        p_p = ps[k]
    return v_p + cross(w_p, p_foot - ps[2])


def rnea(robot: Robot, q, v, a, f_feet):
    """Generalized forces (..., 18) = M(q) a + C(q, v) v + g(q) - J^T f."""
    R_b, T, w_b = _base_rates(q, v)
    dw_b = matvec(R_b, matvec(euler_rate_dot(q[..., 3:6], v[..., 3:6]), v[..., 3:6])
                  + matvec(T, a[..., 3:6]))
    p_b = q[..., :3]
    dv_b = a[..., :3] + GRAVITY * torch.eye(3, dtype=q.dtype, device=q.device)[2]
    lead = q.shape[:-1]
    ql = q[..., 6:].reshape(lead + (4, 3))
    qd = v[..., 6:].reshape(lead + (4, 3))
    qdd = a[..., 6:].reshape(lead + (4, 3))
    R_p, p_p = R_b.unsqueeze(-3), p_b.unsqueeze(-2)
    w_p, v_p = w_b.unsqueeze(-2), v[..., None, :3]
    dw_p, dv_p = dw_b.unsqueeze(-2), dv_b.unsqueeze(-2)
    Fs, Ms, pjs, axs = [], [], [], []
    for k in range(3):
        a_w = matvec(R_p, robot.joint_axis[:, k])
        R_k = R_p @ rodrigues(robot.joint_axis[:, k], ql[..., k])
        p_k = p_p + matvec(R_p, robot.joint_pos[:, k])
        r = p_k - p_p
        v_k = v_p + cross(w_p, r)
        dv_k = dv_p + cross(dw_p, r) + cross(w_p, cross(w_p, r))
        w_k = w_p + a_w * qd[..., k:k + 1]
        dw_k = dw_p + a_w * qdd[..., k:k + 1] + cross(w_p, a_w * qd[..., k:k + 1])
        c_w = matvec(R_k, robot.link_com[:, k])
        a_c = dv_k + cross(dw_k, c_w) + cross(w_k, cross(w_k, c_w))
        I_w = R_k @ robot.link_inertia[:, k] @ R_k.transpose(-1, -2)
        F = robot.link_mass[:, k:k + 1] * a_c
        Fs.append(F)
        Ms.append(matvec(I_w, dw_k) + cross(w_k, matvec(I_w, w_k)) + cross(p_k + c_w, F))
        pjs.append(p_k)
        axs.append(a_w)
        R_p, p_p, w_p, v_p, dw_p, dv_p = R_k, p_k, w_k, v_k, dw_k, dv_k
    p_f = pjs[2] + matvec(R_p, robot.foot_offset)
    Fs.append(-f_feet)
    Ms.append(cross(p_f, -f_feet))
    tau = torch.stack([(axs[k] * (sum(Ms[k:]) - cross(pjs[k], sum(Fs[k:])))).sum(-1)
                       for k in range(3)], dim=-1)
    c_w = matvec(R_b, robot.trunk_com)
    a_c = dv_b + cross(dw_b, c_w) + cross(w_b, cross(w_b, c_w))
    I_w = R_b @ robot.trunk_inertia @ R_b.transpose(-1, -2)
    F_t = robot.trunk_mass * a_c
    M_t = matvec(I_w, dw_b) + cross(w_b, matvec(I_w, w_b)) + cross(p_b + c_w, F_t)
    F_tot = F_t + sum(Fs).sum(-2)
    M_tot = M_t + sum(Ms).sum(-2)
    n_local = matvec(R_b.transpose(-1, -2), M_tot - cross(p_b, F_tot))
    return torch.cat([F_tot, matvec(T.transpose(-1, -2), n_local),
                      tau.reshape(lead + (12,))], dim=-1)
