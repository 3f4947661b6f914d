"""Whole-body contact-implicit OCP: the Gauss-Newton residual stack.

Counterpart of ``iterative_learning_nmpc_tpu/ocp/problem.py``, with the same
row layout: state x = [q(18), v(18)], input u = [a(18), f(4x3)], shooting
dynamics exactly linear in the chart (double integrator), contact switching
as masks. Every residual function takes tensors with any leading batch dims
(one per problem, node or line-search candidate); per-node arguments carry
their trailing shapes, e.g. cnt_k (..., 4), plane_k (..., 4, 3), and
per-problem scalars such as ``restrict`` are (...).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import dynamics as dyn
from ..mpc.config import MPCCostConfig, MPCOptConfig
from ..robots.spec import RobotSpec

NX = 36
NU = 30
N_FOOT = 4
# Inequality-multiplier rows per node: friction-cone 4x5, torque 12, patch 4
# (AL shifts s >= 0 in physical units: N, Nm, m).
NC_CONE = 20
NC_TORQUE = 12
NC_PATCH = 4
NC_INEQ = NC_CONE + NC_TORQUE + NC_PATCH
# stage_residual rows: 130 without the torque-limit hinge, 142 with it
N_RES = 130
N_RES_TORQUE = N_RES + NC_TORQUE


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


@dataclasses.dataclass(frozen=True)
class OCPParams:
    """Per-solve parameters of a batch of B problems (leading dim B)."""

    x0: torch.Tensor            # (B, NX)
    cnt: torch.Tensor           # (B, 4, N+1) contact activity (0/1)
    peak: torch.Tensor          # (B, 4, N+1) swing-peak mask
    plane_point: torch.Tensor   # (B, 4, N+1, 3)
    cnt_loc: torch.Tensor       # (B, 4, N+1, 3)
    patch_radius: torch.Tensor  # (B, 4, N+1)
    restrict: torch.Tensor      # (B,)
    base_ref: torch.Tensor      # (B, 12)
    base_ref_e: torch.Tensor    # (B, 12)
    joint_ref: torch.Tensor     # (B, 12)
    step_height: torch.Tensor   # (B,)
    dt: torch.Tensor            # (B, N)
    lam_eq: torch.Tensor        # (B, N, 18) equality AL multipliers
    lam_ineq: torch.Tensor      # (B, N, NC_INEQ) inequality AL shifts

    def replace(self, **kw) -> "OCPParams":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "OCPParams":
        """Apply ``fn`` to every tensor field."""
        return OCPParams(**{f: fn(getattr(self, f))
                            for f in _tensor_fields(OCPParams)})


@dataclasses.dataclass(frozen=True)
class Weights:
    """sqrt-weight vectors folded into the residuals (unbatched tensors)."""

    base: torch.Tensor          # (12,)
    base_e: torch.Tensor        # (12,)
    joint: torch.Tensor         # (24,)
    joint_e: torch.Tensor       # (24,)
    acc: torch.Tensor           # (12,)
    swing: torch.Tensor         # (4,)
    f_reg: torch.Tensor         # (4, 3)
    foot_disp: torch.Tensor     # ()
    stab_gain: torch.Tensor     # (4,)
    dyn_cons: torch.Tensor      # ()
    contact_vel: torch.Tensor   # ()
    cone: torch.Tensor          # ()
    swing_clear: torch.Tensor   # ()
    torque: torch.Tensor        # ()
    patch: torch.Tensor         # ()
    mu: torch.Tensor            # ()
    total_weight: torch.Tensor  # () m_total * g
    dt_nom: torch.Tensor        # ()
    dt_min: torch.Tensor        # ()
    dt_max: torch.Tensor        # ()
    dt_reg: torch.Tensor        # ()
    dt_bound: torch.Tensor      # ()

    def to(self, device) -> "Weights":
        return Weights(**{f: getattr(self, f).to(device)
                          for f in _tensor_fields(Weights)})


def make_weights(opt: MPCOptConfig, cost: MPCCostConfig,
                 spec: Optional[RobotSpec] = None, device=None) -> Weights:
    """fp32 weights, computed in numpy exactly as the JAX package does, on
    ``device`` (by default the CUDA card)."""
    device = resolve_device(device)
    npd = np.float32
    sq = lambda w: np.sqrt(np.asarray(w, dtype=npd))
    total_w = (0.0 if spec is None
               else 9.81 * float(spec.mass.detach().cpu().numpy().sum()))
    dt_min, dt_max = opt.get_dt_bounds()
    time_opt_w = float(np.atleast_1d(np.asarray(cost.time_opt))[0])
    vals = dict(
        dt_nom=np.asarray(opt.get_dt_nodes(), npd),
        dt_min=np.asarray(dt_min, npd),
        dt_max=np.asarray(dt_max, npd),
        dt_reg=sq(time_opt_w),
        dt_bound=sq(1.0e8),
        total_weight=np.asarray(total_w, dtype=npd),
        base=sq(cost.W_base),
        base_e=sq(cost.W_e_base),
        joint=sq(cost.W_joint),
        joint_e=sq(cost.W_e_joint),
        acc=sq(cost.W_acc),
        swing=sq(cost.W_swing),
        f_reg=sq(cost.W_cnt_f_reg),
        foot_disp=sq(cost.W_foot_displacement[0]),
        stab_gain=np.asarray(cost.W_foot_pos_constr_stab, dtype=npd),
        dyn_cons=sq(opt.w_dyn),
        contact_vel=sq(opt.w_contact),
        cone=sq(opt.w_cone),
        swing_clear=sq(opt.w_swing_height),
        torque=sq(opt.w_torque),
        patch=sq(opt.w_patch),
        mu=np.asarray(opt.mu, dtype=npd),
    )
    return Weights(**{k: torch.as_tensor(v, device=device)
                      for k, v in vals.items()})


def split_state(x):
    return x[..., :18], x[..., 18:36]


def split_input(u):
    """(a (..., 18), f (..., 4, 3)) from the input vector; a trailing dt
    slot (the time-optimal mode's 31st input) is ignored."""
    return u[..., :18], u[..., 18:30].reshape(u.shape[:-1] + (N_FOOT, 3))


def input_dt(u: torch.Tensor, dt_nominal):
    """The node duration: the 31st input where the input carries one (the
    time-optimal mode), else ``dt_nominal``."""
    if u.shape[-1] > NU:
        return u[..., NU]
    return dt_nominal


def dynamics_step(x: torch.Tensor, u: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """Double-integrator step in the chart: exact for a fixed dt, which
    broadcasts against x[..., 0]; bilinear (dt * a, dt^2 * a) when dt is the
    optimized 31st input, which then replaces ``dt``."""
    q, v = split_state(x)
    a, _ = split_input(u)
    dt = input_dt(u, dt)[..., None]
    return torch.cat([q + dt * v + 0.5 * dt * dt * a, v + dt * a], dim=-1)


def dynamics_jacobians(x: torch.Tensor, u: torch.Tensor):
    """Per-node (A, B) = d dynamics_step / d (x, u) of the time-optimal mode
    (u (..., 31), dt = u[..., 30]) in closed form: A = [[I, dt I], [0, I]],
    B = [[dt^2/2 I, 0, v + dt a], [dt I, 0, a]] -> (..., 36, 36),
    (..., 36, 31)."""
    dt = u[..., NU]
    a, v = u[..., :18], x[..., 18:36]
    lead = dt.shape
    eye = torch.eye(18, dtype=x.dtype, device=x.device)
    dtI = dt[..., None, None] * eye
    A = torch.zeros(lead + (NX, NX), dtype=x.dtype, device=x.device)
    A[..., :18, :18] = eye
    A[..., 18:, 18:] = eye
    A[..., :18, 18:] = dtI
    B = torch.zeros(lead + (NX, u.shape[-1]), dtype=x.dtype, device=x.device)
    B[..., :18, :18] = 0.5 * dt[..., None, None] * dtI
    B[..., 18:, :18] = dtI
    B[..., :18, NU] = v + dt[..., None] * a
    B[..., 18:, NU] = a
    return A, B


def dynamics_matrices(dt: float, dtype=torch.float32, device=None):
    """Constant (A, B) of the linear shooting dynamics, on ``device`` (by
    default the CUDA card)."""
    device = resolve_device(device)
    eye18 = np.eye(18, dtype=np.float32)
    z = np.zeros((18, 18), np.float32)
    A = np.block([[eye18, dt * eye18], [z, eye18]])
    Ba = np.concatenate([0.5 * dt * dt * eye18, dt * eye18], axis=0)
    B = np.concatenate([Ba, np.zeros((36, 12), np.float32)], axis=1)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return t(A), t(B)


def cone_values(f_eff: torch.Tensor, mu) -> torch.Tensor:
    """Pyramid friction-cone values g <= 0, (..., 4, 5) per foot:
    [-fz, fx - mu fz, -fx - mu fz, fy - mu fz, -fy - mu fz]."""
    fx, fy, fz = f_eff[..., 0], f_eff[..., 1], f_eff[..., 2]
    return torch.stack([-fz, fx - mu * fz, -fx - mu * fz,
                        fy - mu * fz, -fy - mu * fz], dim=-1)


def hinge(g: torch.Tensor) -> torch.Tensor:
    """max(g, 0), with the derivative 1/2 at g == 0 under torch.func, as
    ``jnp.maximum`` has under the JAX package's jacfwd linearization."""
    return torch.maximum(g, torch.zeros_like(g))


def hinge_slope(g: torch.Tensor) -> torch.Tensor:
    """d max(g, 0) / d g as the jacfwd linearization takes it: 1 above 0,
    1/2 at g == 0, 0 below."""
    return (g > 0.0).to(g.dtype) + 0.5 * (g == 0.0).to(g.dtype)


def hinge_shifted(g: torch.Tensor, s) -> torch.Tensor:
    """AL-shifted hinge for g <= 0 with shift s >= 0: the plain hinge
    max(g, 0) where s == 0, the two-sided affine row g + s where s > 0."""
    on = (s > 0.0).to(g.dtype)
    return on * (g + s) + (1.0 - on) * hinge(g)


def hinge_shifted_act(g: torch.Tensor, s) -> torch.Tensor:
    """Activity mask of hinge_shifted (the JAX package's: 0 at g == 0)."""
    on = (s > 0.0).to(g.dtype)
    return on + (1.0 - on) * (g > 0.0).to(g.dtype)


def hinge_shifted_slope(g: torch.Tensor, s) -> torch.Tensor:
    """d hinge_shifted / d g as the jacfwd linearization takes it: the
    activity mask, but 1/2 at g == 0 where s == 0. A foot that enters stance
    with zero warm-start force sits exactly there after a contact switch, and
    the GN step there differs by far between the two conventions."""
    on = (s > 0.0).to(g.dtype)
    return on + (1.0 - on) * hinge_slope(g)


def _base_joint_residuals(x, base_ref, joint_ref, w_base, w_joint):
    q, v = split_state(x)
    rb = torch.cat([q[..., :6] - base_ref[..., :6],
                    v[..., :6] - base_ref[..., 6:]], dim=-1) * w_base
    rj = torch.cat([q[..., 6:] - joint_ref, v[..., 6:]], dim=-1) * w_joint
    return rb, rj


def _flat(x, n):
    return x.reshape(x.shape[:-2] + (n,))


def stage_residual(
    spec: RobotSpec,
    w: Weights,
    x: torch.Tensor,          # (..., 36)
    u: torch.Tensor,          # (..., 30), or (..., 31) with the dt slot
    cnt_k: torch.Tensor,      # (..., 4)
    peak_k: torch.Tensor,     # (..., 4)
    plane_k: torch.Tensor,    # (..., 4, 3)
    cnt_loc_k: torch.Tensor,  # (..., 4, 3)
    patch_k: torch.Tensor,    # (..., 4)
    restrict: torch.Tensor,   # (...)
    base_ref: torch.Tensor,   # (..., 12)
    joint_ref: torch.Tensor,  # (..., 12)
    step_height: torch.Tensor,  # (...)
    lam_k: Optional[torch.Tensor] = None,       # (..., 18)
    lam_ineq_k: Optional[torch.Tensor] = None,  # (..., NC_INEQ)
    include_torque: bool = True,
    core: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """All running residuals of one node, (..., 142) or (..., 130) without
    the torque-limit hinge rows, and three more (``dt_residual``, before the
    torque rows as in the JAX package) when u carries the time-optimal
    mode's dt slot (..., 31). ``core``, when given, is the precomputed
    (p_feet (..., 4, 3), v_feet (..., 4, 3), tau_full (..., 18))."""
    q, v = split_state(x)
    a, f = split_input(u)
    cnt3 = cnt_k[..., None]
    f_eff = cnt3 * f
    rst = restrict[..., None]

    rb, rj = _base_joint_residuals(x, base_ref, joint_ref, w.base, w.joint)
    ra = a[..., 6:] * w.acc
    n_active = torch.clamp_min(cnt_k.sum(-1), 1.0)
    fz_ref = cnt_k * w.total_weight / n_active[..., None]
    f_ref = torch.stack([torch.zeros_like(fz_ref), torch.zeros_like(fz_ref),
                         fz_ref], dim=-1)
    rf = _flat((f_eff - f_ref) * w.f_reg, 12)
    rf_zero = _flat((1.0 - cnt3) * f, 12)

    if core is None:
        p_feet = dyn.foot_positions(spec, q)
        v_feet = dyn.foot_velocities(spec, q, v)
        tau_full = dyn.rnea(spec, q, v, a, f_ext_feet=f_eff)
    else:
        p_feet, v_feet, tau_full = core

    r_swing = peak_k * (p_feet[..., 2] - step_height[..., None]) * w.swing
    d_xy = p_feet[..., :2] - cnt_loc_k[..., :2]
    r_disp = _flat(rst[..., None] * cnt3 * d_xy, 8) * w.foot_disp

    dist = torch.sqrt((d_xy * d_xy).sum(-1) + 1.0e-12)
    gap_patch = dist - patch_k
    if lam_ineq_k is not None:
        r_patch_core = hinge_shifted(gap_patch, lam_ineq_k[..., NC_CONE + NC_TORQUE:])
    else:
        r_patch_core = hinge(gap_patch)
    r_patch = rst * cnt_k * r_patch_core * w.patch

    r_dyn = tau_full[..., :6] * w.dyn_cons
    if lam_k is not None:
        r_dyn = r_dyn + lam_k[..., :6]

    pin_z = v_feet[..., 2] + w.stab_gain * (p_feet[..., 2] - plane_k[..., 2])
    pin = torch.cat([v_feet[..., :2], pin_z[..., None]], dim=-1)
    r_cnt = _flat(cnt3 * pin, 12) * w.contact_vel
    if lam_k is not None:
        r_cnt = r_cnt + torch.repeat_interleave(cnt_k, 3, dim=-1) * lam_k[..., 6:]

    g_cone = cone_values(f_eff, w.mu)
    if lam_ineq_k is not None:
        s_c = cnt3 * lam_ineq_k[..., :NC_CONE].reshape(cnt_k.shape + (5,))
        cone = _flat(hinge_shifted(g_cone, s_c), 20) * w.cone
    else:
        cone = _flat(hinge(g_cone), 20) * w.cone

    r_clear = ((1.0 - cnt_k) * hinge(plane_k[..., 2] - p_feet[..., 2])
               * w.swing_clear)

    parts = [rb, rj, ra, rf, rf_zero, r_swing, r_disp, r_patch, r_dyn, r_cnt,
             cone, r_clear]
    if u.shape[-1] > NU:
        parts.append(dt_residual(w, u[..., NU]))
    if include_torque:
        g_tau = torch.abs(tau_full[..., 6:]) - spec.torque_limit
        if lam_ineq_k is not None:
            r_tau = hinge_shifted(g_tau, lam_ineq_k[..., NC_CONE:NC_CONE + NC_TORQUE])
        else:
            r_tau = hinge(g_tau)
        parts.append(r_tau * w.torque)
    return torch.cat(parts, dim=-1)


def dt_residual(w: Weights, dt_k: torch.Tensor) -> torch.Tensor:
    """The time-optimal mode's three rows of a node (..., 3): the pull
    toward the nominal duration, (dt - dt_nom) * dt_reg, and the two bound
    hinges, max(dt_min - dt, 0) and max(dt - dt_max, 0), each * dt_bound.
    They are cost rows only: no equality or inequality row carries dt."""
    return torch.stack([(dt_k - w.dt_nom) * w.dt_reg,
                        hinge(w.dt_min - dt_k) * w.dt_bound,
                        hinge(dt_k - w.dt_max) * w.dt_bound], dim=-1)


def terminal_residual(spec: RobotSpec, w: Weights, x, peak_k, base_ref_e,
                      joint_ref, step_height, p_feet=None) -> torch.Tensor:
    """Terminal residual rows (..., 40): base/joint tracking + swing peak."""
    q, _ = split_state(x)
    rb, rj = _base_joint_residuals(x, base_ref_e, joint_ref, w.base_e, w.joint_e)
    if p_feet is None:
        p_feet = dyn.foot_positions(spec, q)
    r_swing = peak_k * (p_feet[..., 2] - step_height[..., None]) * w.swing
    return torch.cat([rb, rj, r_swing], dim=-1)


def stage_residual_from_params(spec: RobotSpec, w: Weights, x, u, p: OCPParams,
                               k: int) -> torch.Tensor:
    """stage_residual of node k of each problem of p: x (B, 36), u (B, 30)
    -> (B, 142), the node's parameters and multipliers read from p."""
    return stage_residual(
        spec, w, x, u, p.cnt[:, :, k], p.peak[:, :, k], p.plane_point[:, :, k],
        p.cnt_loc[:, :, k], p.patch_radius[:, :, k], p.restrict, p.base_ref,
        p.joint_ref, p.step_height, lam_k=p.lam_eq[:, k], lam_ineq_k=p.lam_ineq[:, k])


def equality_residuals(spec: RobotSpec, w: Weights, x, u, cnt_k, plane_k,
                       core=None) -> torch.Tensor:
    """Bare (multiplier-free) weighted equality rows (..., 18): the AL
    multiplier update input. ``core`` = (p_feet, v_feet, tau_full)."""
    q, v = split_state(x)
    a, f = split_input(u)
    f_eff = cnt_k[..., None] * f
    if core is None:
        p_feet = dyn.foot_positions(spec, q)
        v_feet = dyn.foot_velocities(spec, q, v)
        tau_full = dyn.rnea(spec, q, v, a, f_ext_feet=f_eff)
    else:
        p_feet, v_feet, tau_full = core
    r_dyn = tau_full[..., :6] * w.dyn_cons
    pin_z = v_feet[..., 2] + w.stab_gain * (p_feet[..., 2] - plane_k[..., 2])
    pin = torch.cat([v_feet[..., :2], pin_z[..., None]], dim=-1)
    r_cnt = _flat(cnt_k[..., None] * pin, 12) * w.contact_vel
    return torch.cat([r_dyn, r_cnt], dim=-1)


def ineq_values(spec: RobotSpec, w: Weights, x, u, cnt_k, cnt_loc_k, patch_k,
                restrict, core=None) -> torch.Tensor:
    """Raw inequality values g (..., NC_INEQ) in physical units, ordered
    [cone 20 | torque 12 | patch 4]. ``core`` = (p_feet, tau_full)."""
    q, v = split_state(x)
    a, f = split_input(u)
    f_eff = cnt_k[..., None] * f
    if core is None:
        p_feet = dyn.foot_positions(spec, q)
        tau_full = dyn.rnea(spec, q, v, a, f_ext_feet=f_eff)
    else:
        p_feet, tau_full = core
    g_cone = _flat(cone_values(f_eff, w.mu), 20)
    g_tau = torch.abs(tau_full[..., 6:]) - spec.torque_limit
    d_xy = p_feet[..., :2] - cnt_loc_k[..., :2]
    dist = torch.sqrt((d_xy * d_xy).sum(-1) + 1.0e-12)
    g_patch = restrict[..., None] * cnt_k * (dist - patch_k)
    return torch.cat([g_cone, g_tau, g_patch], dim=-1)
