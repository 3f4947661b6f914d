"""The problems a cell solves, made from its configuration and seed.

One nominal problem per configuration: the robot settled on flat ground at
its home posture (feet resting on the ground), the configuration's gait as a
periodic contact schedule from node 0, a base reference at the gait's
nominal height with a forward speed, the terminal reference ahead by that
speed; every problem of the batch is that one with Gaussian noise on its
initial state. The cold start holds the initial state at every node with
the weight shared by the feet in stance.
"""
from __future__ import annotations

from math import ceil

import numpy as np
import torch

from . import dynamics as dyn
from .robot import Robot


def dt_nodes(opt: dict) -> float:
    return round(opt["time_horizon"] / opt["n_nodes"], 4)


def contact_schedule(gait: dict, dt: float, n: int) -> np.ndarray:
    """(4, n) 0/1 stance flags of a periodic gait from its phase 0."""
    per = round(gait["nominal_period"] / dt)
    seq = np.zeros((4, per))
    for i in range(4):
        mk = float(gait["phase_offset"][i])
        bk = round((mk + float(gait["stance_ratio"][i])) % 1.0, 2)
        s, e = ceil(mk * per), ceil(bk * per)
        if mk < bk:
            seq[i, s:e] = 1
        else:
            seq[i, s:] = 1
            seq[i, :e] = 1
    return np.tile(seq, (1, n // per + 2))[:, :n]


def nominal_problem(opt: dict, gait: dict, motion: dict, robot: Robot) -> dict:
    """Numpy arrays of the nominal problem: x0 (36), cnt (4, N+1), base_ref
    and base_ref_e (12), joint_ref (12), step_height, ground_height.
    ``motion`` gives the commanded ``forward_speed`` and the terminal
    reference's ``terminal_offset_x``."""
    N = opt["n_nodes"]
    p0 = dyn.foot_positions(robot, robot.q_home)
    q0 = robot.q_home.detach().cpu().to(torch.float64).numpy().copy()
    q0[2] += -float(p0[0, 2]) + robot.foot_radius
    base_ref = np.zeros(12)
    base_ref[:3] = q0[:3]
    base_ref[2] = gait["nom_height"]
    base_ref[6] = motion["forward_speed"]
    base_ref_e = base_ref.copy()
    base_ref_e[0] += motion["terminal_offset_x"]
    return dict(x0=np.concatenate([q0, np.zeros(18)]),
                cnt=contact_schedule(gait, dt_nodes(opt), N + 1),
                base_ref=base_ref, base_ref_e=base_ref_e, joint_ref=q0[6:].copy(),
                step_height=float(gait["step_height"]), ground_height=robot.foot_radius)


def batch_params(nom: dict, x0: torch.Tensor, dt: float) -> dict:
    """Per-problem parameter tensors (leading B) around initial states x0
    (B, 36), in x0's dtype and device, multipliers at zero."""
    B, N = x0.shape[0], nom["cnt"].shape[1] - 1
    kw = dict(dtype=x0.dtype, device=x0.device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), **kw)
    rep = lambda a: a.expand((B,) + a.shape).contiguous()
    cnt = t(nom["cnt"])
    plane = torch.zeros(4, N + 1, 3, **kw)
    plane[..., 2] = nom["ground_height"]
    return dict(x0=x0, cnt=rep(cnt), peak=rep(1.0 - cnt), plane=rep(plane),
                loc=torch.zeros(B, 4, N + 1, 3, **kw), patch=torch.full((B, 4, N + 1), 1.0e3, **kw),
                restrict=torch.zeros(B, **kw), base_ref=rep(t(nom["base_ref"])),
                base_ref_e=rep(t(nom["base_ref_e"])), joint_ref=rep(t(nom["joint_ref"])),
                step_height=torch.full((B,), nom["step_height"], **kw),
                dt=torch.full((B, N), dt, **kw), lam_eq=torch.zeros(B, N, 18, **kw),
                lam_ineq=torch.zeros(B, N, 36, **kw))


def cold_start(robot: Robot, p: dict):
    """X (B, N+1, 36) holding x0, U (B, N, 30) with zero accelerations and
    the robot's weight shared by the stance feet."""
    x0, cnt = p["x0"], p["cnt"][:, :, :-1]
    B, N = x0.shape[0], cnt.shape[-1]
    X = x0[:, None].expand(B, N + 1, 36).clone()
    fz = dyn.GRAVITY * robot.total_mass().to(x0.dtype) / torch.clamp_min(cnt.sum(1), 1.0)
    f = torch.zeros(B, N, 4, 3, dtype=x0.dtype, device=x0.device)
    f[..., 2] = cnt.transpose(1, 2) * fz[..., None]
    return X, torch.cat([torch.zeros(B, N, 18, dtype=x0.dtype, device=x0.device),
                         f.reshape(B, N, 12)], dim=2)
