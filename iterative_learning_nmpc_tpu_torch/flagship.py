"""The flagship instance and the warm RTI chain.

``flagship`` builds the Go2 trot problem the JAX package benchmarks
(``__graft_entry__._flagship``): N=25 nodes over a 1 s horizon, standing
start with the feet on the ground, 0.3 m/s forward reference. ``rti_chain``
is the steady-state serving loop of ``bench._rti_chain``: one warm-started
RTI solve per step with the equality and inequality duals carried over.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .gait.planner import ContactPlanner
from .models import dynamics as dyn
from .mpc.config import get_quadruped_config
from .ocp.problem import OCPParams
from .robots.go2 import go2_spec
from .solver.sqp import TrajOptSolver, make_params


def flagship(device=None, n_nodes: Optional[int] = None):
    """(solver, X, U, params) for one problem (batch of one), cold-started,
    on ``device`` (by default the CUDA card)."""
    device = resolve_device(device)
    spec = go2_spec(device=device)
    gait, opt, cost = get_quadruped_config("trot", "go2")
    if n_nodes is not None:
        opt.n_nodes = n_nodes
        opt.time_horizon = n_nodes * 0.04
    solver = TrajOptSolver(spec, opt, cost, device=device)
    N = solver.N
    planner = ContactPlanner(spec.feet_frame_names, solver.dt_nodes, gait)

    x0 = dyn.settled_state(spec)
    q0, foot_r = x0[:18], float(spec.foot_radius)
    cnt = planner.get_contacts(0, N + 1).astype(np.float32)
    base_ref = np.zeros(12, np.float32)
    base_ref[:3] = q0[:3]
    base_ref[2] = gait.nom_height
    base_ref[6] = 0.3
    base_ref_e = base_ref.copy()
    base_ref_e[0] += 0.3
    params = make_params(solver, x0, cnt, base_ref=base_ref,
                         base_ref_e=base_ref_e, step_height=gait.step_height,
                         ground_height=foot_r)
    X, U = solver.cold_start(params)
    return solver, X, U, params


def perturbed_batch(X, U, params: OCPParams, batch: int, seed: int = 0):
    """Replicate one problem ``batch`` times with Gaussian noise of std
    0.01 on the initial state (the bench's perturbed-instance batch); the
    noise comes from a seeded CPU torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    noise = 0.01 * torch.randn(batch, X.shape[-1], generator=gen)
    pb = params.map(lambda t: t.expand((batch,) + t.shape[1:]).contiguous())
    pb = pb.replace(x0=pb.x0 + noise.to(X.device))
    Xb = X.expand((batch,) + X.shape[1:]).clone()
    Xb[:, 0] = pb.x0
    Ub = U.expand((batch,) + U.shape[1:]).contiguous()
    return Xb, Ub, pb


def rti_chain(solver: TrajOptSolver, X, U, lam_eq, lam_ineq, params: OCPParams,
              steps: int):
    """``steps`` warm-started RTI solves with dual carry-over. Returns the
    final (X, U, lam_eq, lam_ineq) and the per-step costs and inner AL
    pass counts, (steps, B) each."""
    costs, qp_iters = [], []
    for _ in range(steps):
        pj = params.replace(lam_eq=lam_eq, lam_ineq=lam_ineq)
        s = solver.solve(X, U, pj, 1)
        lam_eq = solver.update_multipliers(s.X, s.U, pj, r_eq=s.r_eq)
        X, U, lam_ineq = s.X, s.U, s.lam_ineq
        costs.append(s.stats.cost)
        qp_iters.append(s.stats.qp_iters)
    return X, U, lam_eq, lam_ineq, torch.stack(costs), torch.stack(qp_iters)
