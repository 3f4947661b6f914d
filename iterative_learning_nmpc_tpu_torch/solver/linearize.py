"""Stage linearization and the merit/dual evaluation of the RTI step.

Counterparts in ``iterative_learning_nmpc_tpu/solver/linearize.py``:

- ``cost_dual`` <- ``cost_dual_dyncore``: merit cost, bare equality rows and
  raw inequality values from ONE batched FK/RNEA core (``ops.dyncore``),
- ``gn_blocks_jacfwd`` <- ``lingram_structured``: the Gauss-Newton blocks
  (Q, R, M, qx, ru) as the Gram of [Jx | Ju | r], with the stage Jacobian
  from ``torch.func.jacfwd`` of ``ocp.problem.stage_residual`` (the plain
  twin of the ``ops.lingram`` kernel).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ocp.problem import (
    NX,
    OCPParams,
    Weights,
    equality_residuals,
    ineq_values,
    stage_residual,
    terminal_residual,
)
from ..ops.dyncore import dyncore
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
