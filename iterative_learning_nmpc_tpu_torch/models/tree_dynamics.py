"""Generic kinematic-tree rigid-body dynamics: the structure-agnostic oracle.

Counterpart of ``iterative_learning_nmpc_tpu/models/tree_dynamics.py``: FK
and RNEA recursions over the spec's bodies one by one (parent before
child), correct for any RobotSpec, and the quantities derived from them.
``models/dynamics.py`` computes the same for the quadruped structure (an
analytic floating base and four identical legs) and is the one the solver,
the kernels' plain twins and the plant run; this module only checks it.

Every function takes tensors with any leading batch dims (q, v, a
(..., nv), foot forces (..., 4, 3)) and computes in q's dtype: the spec's
float32 tensors are cast to it, so a float64 state gives a float64
reference. A nominal spec only (no per-environment payload).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..robots.spec import PRISMATIC, RobotSpec
from .math3d import cross, matvec, rotation_about_axis

GRAVITY = 9.81


class FK(NamedTuple):
    """World-frame kinematics of every body (..., nv, ...)."""

    R: torch.Tensor       # (..., nv, 3, 3) body orientation
    p: torch.Tensor       # (..., nv, 3) body origin
    w: torch.Tensor       # (..., nv, 3) world angular velocity
    vlin: torch.Tensor    # (..., nv, 3) world linear velocity of the origin


def _consts(spec: RobotSpec, like: torch.Tensor):
    """The spec's arrays in ``like``'s dtype and on its device."""
    c = lambda t: t.to(dtype=like.dtype, device=like.device)
    return dict(axis=c(spec.joint_axis), off=c(spec.joint_pos), mass=c(spec.mass),
                com=c(spec.com), inertia=c(spec.inertia), foot=c(spec.foot_offset))


def _dot(a, b):
    return (a * b).sum(-1)


def fk_pos(spec: RobotSpec, q: torch.Tensor):
    """World pose of every body frame: (R (..., nv, 3, 3), p (..., nv, 3))."""
    k = _consts(spec, q)
    lead = q.shape[:-1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(lead + (3, 3))
    zero = q.new_zeros(lead + (3,))
    Rs, ps = [], []
    for i in range(spec.nv):
        par = spec.parent[i]
        Rp = Rs[par] if par >= 0 else eye
        pp = ps[par] if par >= 0 else zero
        axis, off = k["axis"][i], k["off"][i]
        if spec.jtype[i] == PRISMATIC:
            Rs.append(Rp)
            ps.append(pp + matvec(Rp, off + axis * q[..., i, None]))
        else:
            Rs.append(Rp @ rotation_about_axis(axis, q[..., i]))
            ps.append(pp + matvec(Rp, off))
    return torch.stack(Rs, -3), torch.stack(ps, -2)


def fk_vel(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor) -> FK:
    """FK with the world-frame body velocities."""
    k = _consts(spec, q)
    lead = q.shape[:-1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(lead + (3, 3))
    zero = q.new_zeros(lead + (3,))
    Rs, ps, ws, vs = [], [], [], []
    for i in range(spec.nv):
        par = spec.parent[i]
        Rp = Rs[par] if par >= 0 else eye
        pp = ps[par] if par >= 0 else zero
        wp = ws[par] if par >= 0 else zero
        vp = vs[par] if par >= 0 else zero
        axis, off = k["axis"][i], k["off"][i]
        if spec.jtype[i] == PRISMATIC:
            Ri = Rp
            pi = pp + matvec(Rp, off + axis * q[..., i, None])
            wi = wp
            vi = vp + cross(wp, pi - pp) + matvec(Rp, axis) * v[..., i, None]
        else:
            Ri = Rp @ rotation_about_axis(axis, q[..., i])
            pi = pp + matvec(Rp, off)
            wi = wp + matvec(Rp, axis) * v[..., i, None]
            vi = vp + cross(wp, pi - pp)
        Rs.append(Ri)
        ps.append(pi)
        ws.append(wi)
        vs.append(vi)
    return FK(torch.stack(Rs, -3), torch.stack(ps, -2), torch.stack(ws, -2),
              torch.stack(vs, -2))


def foot_positions(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) world positions of the foot points."""
    R, p = fk_pos(spec, q)
    fb = list(spec.foot_body)
    return p[..., fb, :] + matvec(R[..., fb, :, :], _consts(spec, q)["foot"])


def foot_velocities(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) world linear velocities of the foot points."""
    f = fk_vel(spec, q, v)
    fb = list(spec.foot_body)
    r = matvec(f.R[..., fb, :, :], _consts(spec, q)["foot"])
    return f.vlin[..., fb, :] + cross(f.w[..., fb, :], r)


def foot_jacobians(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3, nv) world-aligned linear foot Jacobians dp_foot / dq (the
    Euler chart's v = dq/dt), by forward mode."""
    flat = q.reshape(-1, q.shape[-1])
    J = torch.func.vmap(torch.func.jacfwd(lambda qq: foot_positions(spec, qq)))(flat)
    return J.reshape(q.shape[:-1] + J.shape[1:])


def rnea(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         f_ext_feet: Optional[torch.Tensor] = None, gravity: float = GRAVITY) -> torch.Tensor:
    """Recursive Newton-Euler inverse dynamics in body coordinates,
    tau = M(q) a + C(q, v) v + g(q) - sum_i J_i^T f_i, (..., nv); the world
    foot forces enter the recursion at their bodies."""
    k = _consts(spec, q)
    lead = q.shape[:-1]
    zero3 = q.new_zeros(lead + (3,))
    g_acc = zero3 + torch.tensor([0.0, 0.0, gravity], dtype=q.dtype, device=q.device)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)

    R_pc, r_pc = [], []       # child -> parent rotation, child origin in the parent
    w, vlin, dw, dv = [], [], [], []
    for i in range(spec.nv):
        par = spec.parent[i]
        axis, off = k["axis"][i], k["off"][i]
        wp = w[par] if par >= 0 else zero3
        vp = vlin[par] if par >= 0 else zero3
        dwp = dw[par] if par >= 0 else zero3
        dvp = dv[par] if par >= 0 else g_acc
        if spec.jtype[i] == PRISMATIC:
            Rj = eye.expand(lead + (3, 3))
            rj = off + axis * q[..., i, None]
        else:
            Rj = rotation_about_axis(axis, q[..., i])
            rj = off.expand(lead + (3,))
        RT = Rj.transpose(-1, -2)
        wi = matvec(RT, wp)
        vi = matvec(RT, vp + cross(wp, rj))
        dwi = matvec(RT, dwp)
        dvi = matvec(RT, dvp + cross(dwp, rj))
        if spec.jtype[i] == PRISMATIC:
            s_v = axis * v[..., i, None]
            vi = vi + s_v
            dvi = dvi + axis * a[..., i, None] + cross(wi, s_v)
        else:
            wi_j = axis * v[..., i, None]
            # the velocity-product term v x S qd before adding the joint rate
            dwi = dwi + axis * a[..., i, None] + cross(wi, wi_j)
            dvi = dvi + cross(vi, wi_j)
            wi = wi + wi_j
        R_pc.append(Rj)
        r_pc.append(rj)
        w.append(wi)
        vlin.append(vi)
        dw.append(dwi)
        dv.append(dvi)

    # body wrenches: Newton-Euler about the CoM, shifted to the body origin
    n_b, f_b = [], []
    for i in range(spec.nv):
        m, c, Ic = k["mass"][i], k["com"][i], k["inertia"][i]
        acc_com = dv[i] + cross(w[i], vlin[i]) + cross(dw[i], c) + cross(w[i], cross(w[i], c))
        F = m * acc_com
        n_b.append(matvec(Ic, dw[i]) + cross(w[i], matvec(Ic, w[i])) + cross(c, F))
        f_b.append(F)

    if f_ext_feet is not None:
        Rw = fk_pos(spec, q)[0]
        for j, body in enumerate(spec.foot_body):
            f_loc = matvec(Rw[..., body, :, :].transpose(-1, -2), f_ext_feet[..., j, :])
            n_b[body] = n_b[body] - cross(k["foot"][j], f_loc)
            f_b[body] = f_b[body] - f_loc

    tau = [None] * spec.nv
    for i in range(spec.nv - 1, -1, -1):
        axis = k["axis"][i]
        tau[i] = _dot(axis, f_b[i] if spec.jtype[i] == PRISMATIC else n_b[i])
        par = spec.parent[i]
        if par >= 0:
            f_p = matvec(R_pc[i], f_b[i])
            n_p = matvec(R_pc[i], n_b[i]) + cross(r_pc[i], f_p)
            n_b[par] = n_b[par] + n_p
            f_b[par] = f_b[par] + f_p
    return torch.stack(tau, -1)


def bias_forces(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """C(q, v) v + g(q)."""
    return rnea(spec, q, v, torch.zeros_like(v))


def mass_matrix(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """(..., nv, nv) joint-space inertia by the unit-vector RNEA method:
    column i is rnea(q, 0, e_i) without gravity."""
    nv = q.shape[-1]
    qe = q.unsqueeze(-2).expand(q.shape[:-1] + (nv, nv))
    eye = torch.eye(nv, dtype=q.dtype, device=q.device).expand_as(qe)
    cols = rnea(spec, qe, torch.zeros_like(qe), eye, gravity=0.0)
    return cols.transpose(-1, -2)


def id_torques(spec: RobotSpec, q, v, a, f_feet) -> torch.Tensor:
    """Actuated-joint feed-forward torques (..., nu)."""
    return rnea(spec, q, v, a, f_ext_feet=f_feet)[..., 6:]


def com_position(spec: RobotSpec, q: torch.Tensor) -> torch.Tensor:
    """Whole-body centre of mass (..., 3)."""
    k = _consts(spec, q)
    R, p = fk_pos(spec, q)
    x_com = p + matvec(R, k["com"])
    return (k["mass"][:, None] * x_com).sum(-2) / k["mass"].sum()


def centroidal_momentum(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h = [linear (3), angular (3)] about the CoM, world-aligned (..., 6)."""
    k = _consts(spec, q)
    f = fk_vel(spec, q, v)
    c_body = matvec(f.R, k["com"])
    x_com = f.p + c_body
    v_com = f.vlin + cross(f.w, c_body)
    m = k["mass"][:, None]
    lin = (m * v_com).sum(-2)
    com = (m * x_com).sum(-2) / k["mass"].sum()
    I_w = f.R @ k["inertia"] @ f.R.transpose(-1, -2)
    ang = (matvec(I_w, f.w) + cross(x_com - com.unsqueeze(-2), m * v_com)).sum(-2)
    return torch.cat([lin, ang], dim=-1)


def centroidal_momentum_rate(spec: RobotSpec, q, v, a) -> torch.Tensor:
    """dh/dt along (v, a) by one forward-mode derivative (..., 6)."""
    return torch.func.jvp(lambda qq, vv: centroidal_momentum(spec, qq, vv), (q, v), (v, a))[1]


def contact_wrench_about_com(spec: RobotSpec, q, f_feet, gravity: float = GRAVITY
                             ) -> torch.Tensor:
    """[sum f + m g, sum (p_i - c) x f_i] (..., 6)."""
    c = com_position(spec, q)
    p_feet = foot_positions(spec, q)
    g = torch.tensor([0.0, 0.0, -gravity], dtype=q.dtype, device=q.device)
    lin = f_feet.sum(-2) + _consts(spec, q)["mass"].sum() * g
    ang = cross(p_feet - c.unsqueeze(-2), f_feet).sum(-2)
    return torch.cat([lin, ang], dim=-1)


def forward_dynamics(spec: RobotSpec, q, v, tau_joints, f_ext_feet=None) -> torch.Tensor:
    """a = M^{-1} (S tau + J^T f - nle) (..., nv), by Cholesky."""
    tau_full = torch.cat([q.new_zeros(q.shape[:-1] + (6,)), tau_joints], dim=-1)
    rhs = tau_full - rnea(spec, q, v, torch.zeros_like(v), f_ext_feet=f_ext_feet)
    L = torch.linalg.cholesky(mass_matrix(spec, q))
    y = torch.linalg.solve_triangular(L, rhs.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)
