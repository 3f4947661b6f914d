"""The system under test: ``iterative_learning_nmpc_tpu_torch``'s warm RTI
step, built from a cell's configuration through the port's public API.

The port is imported inside these functions only, so the rest of the
harness (and its CPU tests) loads without it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def build_solver(cell, device):
    """(solver, spec) for the cell: the robot parsed from the configuration's
    URDF by the port's parser, the OCP settings and costs from the file."""
    from iterative_learning_nmpc_tpu_torch.mpc.config import MPCCostConfig, MPCOptConfig
    from iterative_learning_nmpc_tpu_torch.robots.urdf import parse_urdf
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver

    cfg, rob = cell.opt, cell.config["robot"]
    spec = parse_urdf(str(cell.path(rob["urdf"])), name=rob["name"],
                      q_home_joints=rob["q_home_joints"],
                      base_height_home=rob["base_height_home"], device=device)

    def fields(cls):
        out = {}
        for f in dataclasses.fields(cls):
            v = cfg[f.name]
            out[f.name] = tuple(v) if isinstance(v, list) and "Tuple" in str(f.type) else v
        return out

    solver = TrajOptSolver(spec, MPCOptConfig(**fields(MPCOptConfig)),
                           MPCCostConfig(**fields(MPCCostConfig)), device=device)
    return solver, spec


def make_params(solver, nom: dict, x0: torch.Tensor):
    """The port's OCPParams for the batch: the nominal problem's arrays
    through ``make_params``, replicated, with the batch's initial states."""
    from iterative_learning_nmpc_tpu_torch.solver.sqp import make_params as port_make_params

    f32 = lambda a: np.asarray(a, np.float32)
    p1 = port_make_params(solver, f32(nom["x0"]), f32(nom["cnt"]),
                          base_ref=f32(nom["base_ref"]), base_ref_e=f32(nom["base_ref_e"]),
                          joint_ref=f32(nom["joint_ref"]), step_height=nom["step_height"],
                          ground_height=nom["ground_height"])
    B = x0.shape[0]
    pb = p1.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
    return pb.replace(x0=x0.to(torch.float32).contiguous())


def rti_step(solver, X, U, lam_eq, lam_ineq, params):
    """One step of ``flagship.rti_chain``: one solve with the duals carried
    over, then the equality multiplier update."""
    pj = params.replace(lam_eq=lam_eq, lam_ineq=lam_ineq)
    s = solver.solve(X, U, pj, 1)
    lam_eq = solver.update_multipliers(s.X, s.U, pj, r_eq=s.r_eq)
    return s.X, s.U, lam_eq, s.lam_ineq, s.stats


def launch_counts() -> dict:
    """The port's kernel launch counters, by wrapper."""
    from iterative_learning_nmpc_tpu_torch.ops import dyncore, lingram, riccati

    return {"dyncore": dyncore.dyncore.launches, "lingram": lingram.lingram.launches,
            "riccati_rollout": riccati.riccati_rollout.launches,
            "riccati_sweep_terminal": riccati.riccati_sweep_terminal.launches,
            "forward_rollout": riccati.forward_rollout.launches}
