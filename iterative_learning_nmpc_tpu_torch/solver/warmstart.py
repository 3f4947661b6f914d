"""Cold-boot warm starts of the NMPC solver: the phase-aligned boot and
the learned-policy warm starts.

Counterpart of ``iterative_learning_nmpc_tpu/solver/warmstart.py``, with an
explicit leading batch dim (each problem as the JAX function treats one):

- ``merit_phase_boot``: at a cold boot the gait-phase offset of the contact
  schedule is free (nothing has been promised to the plant yet), and it
  moves the converged solution a lot: the boot probes every offset with one
  batched solve and keeps the best. The controller's cold boot.
- ``policy_warmstart``: a learned policy drives the device plant over the
  horizon (one policy call a node, torque-clipped joint PD at the control
  rate over the node); the node states, finite-difference accelerations
  and the contact model's forces where the plan says stance form (X, U).
  On the card a node's 40 plant steps are one CUDA graph, captured once a
  call and replayed every node; the policy runs between replays.
- ``phase_aligned_warmstart``: the same rollout, with the gait-phase offset
  whose contact window agrees best (Hamming score) with the feet the policy
  actually put down.

In the JAX package's measurements neither policy warm start beats the
stationary ``TrajOptSolver.cold_start``; they stay as the learned-policy
alternative.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..learning.obs import policy_input
from ..ocp.problem import OCPParams
from ..sim import device_sim


def contact_windows(planner, N: int) -> np.ndarray:
    """(C, 4, N+1) contact windows at every gait-phase offset, one per
    planner start node over a cycle."""
    C = planner.nodes_per_cycle
    return np.stack([planner.get_contacts(o, N + 1) for o in range(C)]
                    ).astype(np.float32)


def peak_windows(planner, N: int) -> np.ndarray:
    """(C, 4, N+1) swing-peak windows matching ``contact_windows``."""
    C = planner.nodes_per_cycle
    return np.stack([planner.get_peaks(o, N + 1) for o in range(C)]
                    ).astype(np.float32)


def merit_phase_boot(solver, params: OCPParams, windows, probe_iters: int = 3,
                     peaks=None):
    """Pick the gait-phase offset that best fits the current state: ONE
    batch of C problems (one per contact window, cold-started) solved for
    ``probe_iters`` iterations, argmin of the merit.

    ``params`` is a batch of one; ``peaks`` are the swing-peak windows
    (default ``1 - windows``; the controller passes the planner's own when
    it optimizes the peaks). Returns (params', offset, probe_costs (C,)),
    params' carrying the selected windows.
    """
    dev, dtype = params.x0.device, params.x0.dtype
    w = torch.as_tensor(np.asarray(windows), dtype=dtype, device=dev)
    pk = 1.0 - w if peaks is None else torch.as_tensor(np.asarray(peaks),
                                                       dtype=dtype, device=dev)
    C = w.shape[0]
    pc = params.map(lambda t: t.expand((C,) + t.shape[1:]).contiguous())
    pc = pc.replace(cnt=w, peak=pk)
    X, U = solver.cold_start(pc)
    costs = solver.solve(X, U, pc, probe_iters).stats.cost
    off = int(torch.argmin(costs))
    return params.replace(cnt=w[off:off + 1], peak=pk[off:off + 1]), off, costs


def policy_targets(served) -> Callable:
    """``apply_fn`` of the policy warm starts from a
    ``learning.network.ServedPolicy``: (B, 47) policy inputs -> (B, 12) PD
    targets, the first output of the served policy's route (kernel 8 on a
    CUDA device for the widths it takes)."""

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        z = torch.zeros(x.shape[0], 12, dtype=x.dtype, device=x.device)
        return served(x[:, :44], x[:, 44:], z, z, 0.0, 0.0)[0]

    return apply_fn


def _policy_rollout(solver, apply_fn: Callable, params: OCPParams, v_des, kp: float,
                    kd: float, sim_dt: float):
    """The policy on the device plant over the horizon, for each problem of
    the batch from its own x0: X (B, N+1, 36), the finite-difference
    accelerations (B, N, 18) and the contact model's forces at the node
    boundaries (B, N, 4, 3)."""
    spec, N, dt = solver.spec, solver.N, solver.dt_nodes
    steps = max(1, int(round(dt / sim_dt)))
    x0 = params.x0
    B = x0.shape[0]
    v_des = torch.as_tensor(np.asarray(v_des), dtype=x0.dtype,
                            device=x0.device).expand(B, 3)
    jl, tl = spec.joint_limits, spec.torque_limit
    cp = device_sim.contact_params_for(spec, x0.dtype, x0.device)

    def node(q, v, t, target):
        st = device_sim.SimState(q, v, t)
        for _ in range(steps):
            tau = torch.clamp(kp * (target - st.q[:, 6:]) - kd * st.v[:, 6:], -tl, tl)
            st = device_sim.step(spec, st, tau, cp, sim_dt)
        return st

    st = device_sim.SimState(x0[:, :18], x0[:, 18:],
                             torch.zeros(B, dtype=x0.dtype, device=x0.device))
    run = None
    Q, V, F = [], [], []
    for _ in range(N):
        target = torch.clamp(apply_fn(policy_input(spec, st.q, st.v, v_des)),
                             jl[:, 0], jl[:, 1])
        # a node's control steps: one CUDA graph on the card, replayed N times
        run = run or device_sim.graphed(node, st.q, st.v, st.t, target)
        st = device_sim.SimState(*(x.clone() for x in run(st.q, st.v, st.t, target)))
        Q.append(st.q)
        V.append(st.v)
        F.append(device_sim.contact_forces(spec, st.q, st.v, cp))
    X = torch.cat([x0[:, None], torch.cat([torch.stack(Q, 1), torch.stack(V, 1)], -1)], 1)
    A = (X[:, 1:, 18:] - X[:, :-1, 18:]) / dt
    return X, A, torch.stack(F, 1)


def _policy_inputs(X, A, F, cnt):
    """U (B, N, 30): the accelerations and the forces masked by the plan's
    contacts ``cnt`` (B, 4, N+1), never branching."""
    B, N = A.shape[:2]
    f = F * cnt[:, :, :N].transpose(1, 2)[..., None]
    return torch.cat([A, f.reshape(B, N, 12)], -1)


def policy_warmstart(solver, apply_fn: Callable, params: OCPParams, v_des,
                     kp: float = 20.0, kd: float = 1.5, sim_dt: float = 1.0e-3):
    """(X (B, N+1, 36), U (B, N, 30)) from a policy rollout on the device
    plant. ``apply_fn`` maps (B, 47) policy inputs to (B, 12) PD targets
    (``policy_targets``); ``v_des`` is (3,) or (B, 3). The targets are
    clipped to the joint limits; the forces are the contact model's where
    the plan (``params.cnt``) says stance, zero elsewhere."""
    X, A, F = _policy_rollout(solver, apply_fn, params, v_des, kp, kd, sim_dt)
    return X, _policy_inputs(X, A, F, params.cnt)


def phase_aligned_warmstart(solver, apply_fn: Callable, params: OCPParams, v_des,
                            windows, kp: float = 20.0, kd: float = 1.5,
                            sim_dt: float = 1.0e-3, f_contact_thresh: float = 5.0):
    """Policy warm start with the gait-phase offset picked to match the
    policy's own gait: the feet whose normal force passes
    ``f_contact_thresh`` at the node boundaries 1..N, scored against every
    contact window (``contact_windows``, (C, 4, N+1)) by the count of
    agreeing (node, foot) pairs, argmax per problem (the first on a tie).
    Returns (X, U, params' carrying the picked cnt and peak = 1 - cnt,
    offset (B,))."""
    X, A, F = _policy_rollout(solver, apply_fn, params, v_des, kp, kd, sim_dt)
    w = torch.as_tensor(np.asarray(windows), dtype=X.dtype, device=X.device)
    offset = phase_pick(F, w, f_contact_thresh)
    cnt = w[offset]
    return X, _policy_inputs(X, A, F, cnt), params.replace(cnt=cnt, peak=1.0 - cnt), offset


def phase_pick(F: torch.Tensor, windows: torch.Tensor, f_contact_thresh: float = 5.0):
    """(B,) offsets of the contact windows (C, 4, N+1) that agree best with
    the feet in contact (normal force above ``f_contact_thresh``) in the
    forces (B, N, 4, 3) at the node boundaries 1..N."""
    N = F.shape[1]
    flags = (F[..., 2] > f_contact_thresh).to(F.dtype).transpose(1, 2)[:, None]  # (B,1,4,N)
    sched = windows[None, :, :, 1:N + 1]                                         # (1,C,4,N)
    score = (sched * flags + (1 - sched) * (1 - flags)).sum((2, 3))              # (B, C)
    return torch.argmax(score, dim=1)
