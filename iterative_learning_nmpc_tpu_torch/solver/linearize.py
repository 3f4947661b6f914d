"""Stage linearization and the merit/dual evaluation of the RTI step.

Counterparts in ``iterative_learning_nmpc_tpu/solver/linearize.py``:

- ``cost_dual`` <- ``cost_dual_dyncore``: merit cost, bare equality rows and
  raw inequality values from ONE batched FK/RNEA core (``ops.dyncore``),
- ``lingram_structured`` <- ``lingram_structured``: the Gauss-Newton blocks
  (Q, R, M, qx, ru) condensed row group by row group from ONE dynamics +
  Jacobian evaluation per node (``ops.dynjac``); the single-problem route
  of the solver,
- ``gn_blocks_jacfwd`` <- the jacfwd-path Gram (``solver/sqp.py``): the same
  blocks as the Gram of [Jx | Ju | r], with the stage Jacobian from
  ``torch.func.jacfwd`` of ``ocp.problem.stage_residual`` (the plain twin of
  the ``ops.lingram`` kernel).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ocp.problem import (
    N_FOOT,
    NU,
    NX,
    OCPParams,
    Weights,
    cone_values,
    equality_residuals,
    hinge,
    hinge_shifted,
    hinge_shifted_slope,
    hinge_slope,
    ineq_values,
    stage_residual,
    terminal_residual,
)
from ..ops.dyncore import dyncore
from ..ops.dynjac import dynjac
from ..robots.spec import RobotSpec


def node_view(p: OCPParams, N: int) -> Dict[str, torch.Tensor]:
    """Per-node parameters with leading (L, N) and per-problem ones
    broadcast over the nodes."""
    L = p.x0.shape[0]
    per_node = lambda t: t[:, :, :N].transpose(1, 2)
    per_node3 = lambda t: t[:, :, :N].permute(0, 2, 1, 3)
    per_prob = lambda t: t.reshape((L, 1) + t.shape[1:]).expand((L, N) + t.shape[1:])
    return dict(
        cnt_k=per_node(p.cnt), peak_k=per_node(p.peak),
        plane_k=per_node3(p.plane_point), cnt_loc_k=per_node3(p.cnt_loc),
        patch_k=per_node(p.patch_radius), restrict=per_prob(p.restrict),
        base_ref=per_prob(p.base_ref), joint_ref=per_prob(p.joint_ref),
        step_height=per_prob(p.step_height), lam_k=p.lam_eq,
        lam_ineq_k=p.lam_ineq,
    )


def dyncore_inputs(Xb: torch.Tensor, Ub: torch.Tensor, pb: OCPParams):
    """The FK/RNEA evaluations of L trajectories as one flat batch:
    (X (L*(N+1), 36), A (L*(N+1), 18), F (L*(N+1), 12)), node-major per
    trajectory, the terminal node with zero inputs, forces contact-masked."""
    L, N = Ub.shape[0], Ub.shape[1]
    cnt = pb.cnt[:, :, :N].transpose(1, 2)
    fe = cnt[..., None] * Ub[..., 18:30].reshape(L, N, 4, 3)
    zero_a = torch.zeros(L, 1, 18, dtype=Xb.dtype, device=Xb.device)
    zero_f = torch.zeros(L, 1, 12, dtype=Xb.dtype, device=Xb.device)
    A_all = torch.cat([Ub[..., :18], zero_a], dim=1).reshape(-1, 18)
    F_all = torch.cat([fe.reshape(L, N, 12), zero_f], dim=1).reshape(-1, 12)
    return Xb.reshape(L * (N + 1), NX), A_all, F_all


def cost_dual(spec: RobotSpec, w: Weights, Xb: torch.Tensor, Ub: torch.Tensor,
              pb: OCPParams, core_fn=dyncore):
    """Xb (L, N+1, 36), Ub (L, N, 30), pb with leading L ->
    (cost (L,), r_eq (L, N, 18), g_ineq (L, N, 36)). The terminal node's FK
    rides along as an extra node with zero inputs: one ``core_fn``
    (ops.dyncore or its plain twin) call for all L*(N+1) evaluations."""
    L, N = Ub.shape[0], Ub.shape[1]
    nv = node_view(pb, N)
    cnt = nv["cnt_k"]
    prim = core_fn(spec, *dyncore_inputs(Xb, Ub, pb)).reshape(L, N + 1, 42)
    p_feet = prim[:, :N, :12].reshape(L, N, 4, 3)
    v_feet = prim[:, :N, 12:24].reshape(L, N, 4, 3)
    tau = prim[:, :N, 24:]
    p_feet_T = prim[:, N, :12].reshape(L, 4, 3)

    x, u = Xb[:, :-1], Ub
    r = stage_residual(spec, w, x, u, include_torque=True,
                       core=(p_feet, v_feet, tau), **nv)
    r_eq = equality_residuals(spec, w, x, u, cnt, nv["plane_k"],
                              core=(p_feet, v_feet, tau))
    g = ineq_values(spec, w, x, u, cnt, nv["cnt_loc_k"], nv["patch_k"],
                    nv["restrict"], core=(p_feet, tau))
    r_term = terminal_residual(spec, w, Xb[:, -1], pb.peak[:, :, -1],
                               pb.base_ref_e, pb.joint_ref, pb.step_height,
                               p_feet=p_feet_T)
    cost = 0.5 * (r * r).sum((1, 2)) + 0.5 * (r_term * r_term).sum(1)
    return cost, r_eq, g


# d g / d f of the five pyramid-cone rows per foot (ocp.problem.cone_values):
# the xy part, and the z part whose rows 1-4 scale with mu
_CONE_XY = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))
_CONE_Z = (-1.0, -1.0, -1.0, -1.0, -1.0)
_CONE_MU_MASK = (0.0, 1.0, 1.0, 1.0, 1.0)


def _gram(A: torch.Tensor) -> torch.Tensor:
    """A^T A per leading index: (L, rows, c) -> (L, c, c)."""
    return torch.bmm(A.transpose(1, 2), A)


def lingram_structured(spec: RobotSpec, w: Weights, Xb: torch.Tensor,
                       Ub: torch.Tensor, pb: OCPParams,
                       include_torque: bool = True, dynjac_fn=dynjac):
    """Gauss-Newton blocks (Q, R, M, qx, ru) of every (problem, node),
    computed directly from the residual's row structure: G = J^T J has no
    cross-row terms, so it is a sum over row groups and the full Jacobian
    never exists.

    - tracking / acceleration / force rows are diagonal: elementwise,
    - foot-kinematic rows touch x only: one bmm on a (BN, 32, 37) stack,
    - dynamics (+ torque-hinge) rows are the only x-and-u rows: one bmm on
      (BN, 6 | 18, 67), and the only source of M,
    - cone rows are per-foot (5 x 3) blocks on f: one bmm on (BN*4, 5, 4).

    One ``dynjac_fn`` call (``ops.dynjac`` or its plain twin) gives the
    values and d/d(x, a) of [p_feet, v_feet, tau] at every node; d tau / d f
    follows by duality, d tau / d f_i = -(d v_foot_i / d v)^T.
    """
    B, N = Ub.shape[0], Ub.shape[1]
    BN = B * N
    dtype, dev = Xb.dtype, Xb.device
    f32 = dict(dtype=dtype, device=dev)

    # ---- dynamics + Jacobian core (one launch) ----
    X_nodes = Xb[:, :-1].reshape(BN, NX)
    U_nodes = Ub.reshape(BN, NU)
    A_nodes = U_nodes[:, :18]
    cnt = pb.cnt[:, :, :N].transpose(1, 2).reshape(BN, N_FOOT)
    f = U_nodes[:, 18:].reshape(BN, N_FOOT, 3)
    f_eff = cnt[..., None] * f
    prim, J = dynjac_fn(spec, X_nodes.contiguous(), A_nodes.contiguous(),
                        f_eff.reshape(BN, 12).contiguous())
    p_feet = prim[:, :12].reshape(BN, N_FOOT, 3)
    v_feet = prim[:, 12:24].reshape(BN, N_FOOT, 3)
    tau = prim[:, 24:]                                    # (BN, 18)
    Jp = J[:, :12, :NX].reshape(BN, N_FOOT, 3, NX)
    Jvf = J[:, 12:24, :NX].reshape(BN, N_FOOT, 3, NX)
    Jt_x = J[:, 24:, :NX]                                 # (BN, 18, 36)
    Jt_a = J[:, 24:, NX:]                                 # (BN, 18, 18)
    Jt_f = -Jvf[..., 18:NX].transpose(2, 3)               # (BN, 4, 18, 3)
    Jt_f = Jt_f.permute(0, 2, 1, 3).reshape(BN, 18, 12)

    # ---- per-problem parameters broadcast to flat nodes ----
    rep = lambda x: x[:, None].expand((B, N) + x.shape[1:]).reshape((BN,) + x.shape[1:])
    peak = pb.peak[:, :, :N].transpose(1, 2).reshape(BN, N_FOOT)
    plane = pb.plane_point[:, :, :N].permute(0, 2, 1, 3).reshape(BN, N_FOOT, 3)
    loc = pb.cnt_loc[:, :, :N].permute(0, 2, 1, 3).reshape(BN, N_FOOT, 3)
    patch = pb.patch_radius[:, :, :N].transpose(1, 2).reshape(BN, N_FOOT)
    restrict = rep(pb.restrict)
    base_ref, joint_ref, step_h = rep(pb.base_ref), rep(pb.joint_ref), rep(pb.step_height)
    lam = pb.lam_eq.reshape(BN, 18)
    lami = pb.lam_ineq.reshape(BN, 36)
    s_cone = cnt[..., None] * lami[:, :20].reshape(BN, N_FOOT, 5)
    s_tau, s_patch = lami[:, 20:32], lami[:, 32:36]
    cnt12 = torch.repeat_interleave(cnt, 3, dim=1)        # (BN, 12)

    # ---- diagonal groups (tracking / acc / force regularisation) ----
    # x columns: base pos 6, joint pos 12, base vel 6, joint vel 12
    wT = torch.cat([w.base[:6], w.joint[:12], w.base[6:], w.joint[12:]])
    wT2 = wT * wT
    x_ref = torch.cat([base_ref[:, :6], joint_ref, base_ref[:, 6:],
                       torch.zeros(BN, 12, **f32)], dim=1)
    qx = wT2 * (X_nodes - x_ref)
    wacc2 = w.acc * w.acc
    Rdiag = torch.cat([torch.zeros(6, **f32), wacc2, torch.zeros(12, **f32)])
    # r = w_f (f_eff - f_ref), d/df = cnt w_f; swing rows r = (1 - cnt) f
    wf2 = (w.f_reg ** 2)[None]                            # (1, 4, 3)
    n_active = torch.clamp_min(cnt.sum(1), 1.0)
    f_ref = torch.cat([torch.zeros(BN, N_FOOT, 2, **f32),
                       (cnt * w.total_weight / n_active[:, None])[..., None]], dim=2)
    omc = (1.0 - cnt)[..., None]
    Rdiag_f = (cnt[..., None] ** 2) * wf2 + omc * omc     # (BN, 4, 3)
    ru_f = cnt[..., None] * wf2 * (f_eff - f_ref) + omc * omc * f
    ru = torch.cat([torch.zeros(BN, 6, **f32), wacc2 * A_nodes[:, 6:],
                    ru_f.reshape(BN, 12)], dim=1)

    # ---- foot-kinematic stack S (x columns only) + residual column ----
    sc_sw = (peak * w.swing)[..., None]                   # (BN, 4, 1)
    S_sw = sc_sw * Jp[:, :, 2, :]
    s_sw = sc_sw[..., 0] * (p_feet[:, :, 2] - step_h[:, None])

    sc_d = (restrict[:, None] * cnt * w.foot_disp)[..., None, None]
    S_d = (sc_d * Jp[:, :, :2, :]).reshape(BN, 8, NX)
    s_d = (sc_d[..., 0] * (p_feet[:, :, :2] - loc[:, :, :2])).reshape(BN, 8)

    d_xy = p_feet[:, :, :2] - loc[:, :, :2]
    dist = torch.sqrt((d_xy * d_xy).sum(2) + 1.0e-12)
    unit = d_xy / dist[..., None]
    gap_p = dist - patch
    sc_p = restrict[:, None] * cnt * w.patch
    S_p = ((sc_p * hinge_shifted_slope(gap_p, s_patch))[..., None]
           * torch.einsum("bij,bijx->bix", unit, Jp[:, :, :2, :]))
    s_p = sc_p * hinge_shifted(gap_p, s_patch)

    stab = w.stab_gain
    Jc_z = Jvf[:, :, 2, :] + stab[None, :, None] * Jp[:, :, 2, :]
    S_c = torch.cat([Jvf[:, :, :2, :], Jc_z[:, :, None, :]], dim=2)
    S_c = ((cnt * w.contact_vel)[..., None, None] * S_c).reshape(BN, 12, NX)
    pin = torch.cat([v_feet[:, :, :2],
                     (v_feet[:, :, 2] + stab[None] * (p_feet[:, :, 2] - plane[:, :, 2])
                      )[..., None]], dim=2)
    s_c = (cnt[..., None] * pin).reshape(BN, 12) * w.contact_vel + cnt12 * lam[:, 6:]

    gap_cl = plane[:, :, 2] - p_feet[:, :, 2]
    S_cl = (-(1.0 - cnt) * w.swing_clear * hinge_slope(gap_cl))[..., None] * Jp[:, :, 2, :]
    s_cl = (1.0 - cnt) * w.swing_clear * hinge(gap_cl)

    S = torch.cat([S_sw, S_d, S_p, S_c, S_cl], dim=1)     # (BN, 32, 36)
    s = torch.cat([s_sw, s_d, s_p, s_c, s_cl], dim=1)     # (BN, 32)
    G_S = _gram(torch.cat([S, s[..., None]], dim=2))      # (BN, 37, 37)

    # ---- dynamics (+ torque hinge) rows: the only x-and-u rows ----
    D_x = w.dyn_cons * Jt_x[:, :6]
    D_u = w.dyn_cons * torch.cat([Jt_a[:, :6], Jt_f[:, :6] * cnt12[:, None, :]], dim=2)
    d_res = w.dyn_cons * tau[:, :6] + lam[:, :6]
    if include_torque:
        tau_j = tau[:, 6:]
        gap_t = tau_j.abs() - spec.torque_limit
        t_sc = (hinge_shifted_slope(gap_t, s_tau) * torch.sign(tau_j) * w.torque)[..., None]
        D_x = torch.cat([D_x, t_sc * Jt_x[:, 6:]], dim=1)
        D_u = torch.cat([D_u, t_sc * torch.cat(
            [Jt_a[:, 6:], Jt_f[:, 6:] * cnt12[:, None, :]], dim=2)], dim=1)
        d_res = torch.cat([d_res, w.torque * hinge_shifted(gap_t, s_tau)], dim=1)
    G_D = _gram(torch.cat([D_x, D_u, d_res[..., None]], dim=2))   # (BN, 67, 67)

    # ---- cone rows: per-foot (5 x 3) blocks on the f columns ----
    g_vals = cone_values(f_eff, w.mu)                     # (BN, 4, 5)
    acts = hinge_shifted_slope(g_vals, s_cone)
    g_xy = torch.tensor(_CONE_XY, **f32)
    mu_mask = torch.tensor(_CONE_MU_MASK, **f32)
    g_z = torch.tensor(_CONE_Z, **f32) * (mu_mask * w.mu + (1.0 - mu_mask))
    grad = torch.cat([g_xy.expand(BN, N_FOOT, 5, 2),
                      g_z[:, None].expand(BN, N_FOOT, 5, 1)], dim=3)
    grad = grad * (acts * (w.cone * cnt)[..., None])[..., None]   # (BN, 4, 5, 3)
    c_res = w.cone * hinge_shifted(g_vals, s_cone)
    Ca = torch.cat([grad, c_res[..., None]], dim=3)       # (BN, 4, 5, 4)
    G_C = _gram(Ca.reshape(BN * N_FOOT, 5, 4)).reshape(BN, N_FOOT, 4, 4)

    # ---- assemble ----
    Q = G_S[:, :NX, :NX] + G_D[:, :NX, :NX] + torch.diag(wT2)
    qx = qx + G_S[:, :NX, NX] + G_D[:, :NX, NX + NU]
    M = G_D[:, :NX, NX:NX + NU]
    R = G_D[:, NX:NX + NU, NX:NX + NU] + torch.diag(Rdiag)
    Rf = torch.diag_embed(Rdiag_f.reshape(BN, 12))
    Cf = torch.zeros(BN, 12, 12, **f32)
    for i in range(N_FOOT):
        Cf[:, 3 * i:3 * i + 3, 3 * i:3 * i + 3] = G_C[:, i, :3, :3]
    R = torch.cat([R[:, :18], torch.cat([R[:, 18:, :18], R[:, 18:, 18:] + Rf + Cf],
                                        dim=2)], dim=1)
    ru = ru + torch.cat([torch.zeros(BN, 18, **f32), G_C[:, :, :3, 3].reshape(BN, 12)], dim=1)
    ru = ru + G_D[:, NX:NX + NU, NX + NU]

    rs = lambda x: x.reshape((B, N) + x.shape[1:])
    return rs(Q), rs(R), rs(M), rs(qx), rs(ru)


def gn_blocks_jacfwd(spec: RobotSpec, w: Weights, Xb: torch.Tensor,
                     Ub: torch.Tensor, pb: OCPParams, include_torque: bool = True):
    """Gauss-Newton blocks of every (problem, node): Xb (B, N+1, 36),
    Ub (B, N, 30) -> Q (B,N,36,36), R (B,N,30,30), M (B,N,36,30),
    qx (B,N,36), ru (B,N,30), all slices of G = [Jx|Ju|r]^T [Jx|Ju|r]."""
    B, N = Ub.shape[0], Ub.shape[1]
    nu = Ub.shape[-1]
    nv = node_view(pb, N)
    flat = {k: t.reshape((B * N,) + t.shape[2:]) for k, t in nv.items()}
    Z = torch.cat([Xb[:, :-1], Ub], dim=2).reshape(B * N, NX + nu)

    def res(z, kw):
        return stage_residual(spec, w, z[..., :NX], z[..., NX:],
                              include_torque=include_torque, **kw)

    J = torch.func.vmap(torch.func.jacfwd(res, argnums=0))(Z, flat)
    r = res(Z, flat)
    Ja = torch.cat([J, r[..., None]], dim=2)                  # (BN, rows, 67)
    G = Ja.transpose(1, 2) @ Ja
    rs = lambda t: t.reshape((B, N) + t.shape[1:])
    return (rs(G[:, :NX, :NX]), rs(G[:, NX:NX + nu, NX:NX + nu]),
            rs(G[:, :NX, NX:NX + nu]), rs(G[:, :NX, NX + nu]),
            rs(G[:, NX:NX + nu, NX + nu]))
