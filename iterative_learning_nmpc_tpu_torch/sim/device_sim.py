"""Soft-contact quadruped plant on the device.

Counterpart of ``iterative_learning_nmpc_tpu/sim/jax_sim.py`` (the same
contact model, integrator and parameters), for closed loops where no MuJoCo
runs beside the card. Every function takes tensors with any leading batch
dims; the plant runs on the device its state lies on.

Contact model: compliant sphere-plane contact at the four feet, a
spring-damper normal force and regularised Coulomb friction. Integration:
semi-implicit Euler, two sub-steps per 1 kHz control step, torques held
across them. ``make_batched_policy_rollout`` serves a learned policy to a
batch of environments on the plant.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..learning.network import ServedPolicy
from ..learning.obs import policy_state
from ..models import dynamics as dyn
from ..robots.spec import RobotSpec


@dataclasses.dataclass(frozen=True)
class ContactParams:
    stiffness: torch.Tensor      # N/m
    damping: torch.Tensor        # N s/m
    friction_mu: torch.Tensor
    vel_smoothing: torch.Tensor  # m/s tangential regularisation


def default_contact_params(dtype=torch.float32, device=None) -> ContactParams:
    """Parameters tuned for a Go2-class (~15 kg) robot at dt = 1e-3: the
    friction term is a tangential damper mu fz / vel_smoothing, kept below
    ~2 m_eff / dt so that the feet do not chatter."""
    t = lambda x: torch.tensor(x, dtype=dtype, device=resolve_device(device))
    return ContactParams(stiffness=t(2.0e4), damping=t(5.0e2),
                         friction_mu=t(0.8), vel_smoothing=t(0.2))


_GO2_TOTAL_MASS = 15.02   # the mass the default parameters were tuned at


def contact_params_for(spec: RobotSpec, dtype=torch.float32, device=None) -> ContactParams:
    """Mass-scaled contact parameters: stiffness and damping scale with the
    robot's total mass, which keeps the penetration depth and the explicit
    stability margins unchanged. The spec is the nominal one: a payload
    spec's masses would sum over its environments."""
    if spec.batch_shape:
        raise ValueError("contact parameters scale with the nominal spec's mass; "
                         "a payload spec carries one mass per environment")
    scale = float(spec.mass.detach().cpu().numpy().sum()) / _GO2_TOTAL_MASS
    base = default_contact_params(dtype, device)
    return dataclasses.replace(base, stiffness=base.stiffness * scale,
                               damping=base.damping * scale)


class SimState(NamedTuple):
    q: torch.Tensor   # (..., 18) Euler chart
    v: torch.Tensor   # (..., 18)
    t: torch.Tensor   # (...)


def _per_foot(x):
    """A per-environment parameter (a float, a scalar tensor or a tensor of
    the state's leading dims) broadcast over the four feet."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() > 0 else x


def contact_forces(spec: RobotSpec, q, v, cp: ContactParams,
                   ground_height=0.0) -> torch.Tensor:
    """(..., 4, 3) world contact forces at the feet. The contact parameters
    and the ground height are scalars or per-environment tensors of the
    state's leading dims."""
    p = dyn.foot_positions(spec, q)                  # foot centres
    vel = dyn.foot_velocities(spec, q, v)
    k, c, mu, vs = (_per_foot(x) for x in (cp.stiffness, cp.damping, cp.friction_mu,
                                           cp.vel_smoothing))
    depth = (_per_foot(ground_height) + spec.foot_radius) - p[..., 2]
    fz = torch.where(depth > 0.0, k * depth - c * vel[..., 2], torch.zeros_like(depth))
    fz = torch.clamp_min(fz, 0.0)
    vt = vel[..., :2]
    vt_norm = torch.sqrt((vt * vt).sum(-1) + vs ** 2)
    ft = (-mu * fz)[..., None] * vt / vt_norm[..., None]
    return torch.cat([ft, fz[..., None]], dim=-1)


def step(spec: RobotSpec, state: SimState, tau_joints, cp: ContactParams,
         dt: float = 1.0e-3, f_ext: Optional[torch.Tensor] = None,
         substeps: int = 2, ground_height=0.0) -> SimState:
    """One control step: joint torques clipped to the limits and held over
    ``substeps`` semi-implicit Euler sub-steps; ``f_ext`` (..., 3) is an
    optional world force on the base, mapped onto the prismatic coordinates.
    Penalty contact at quadruped stiffness needs the sub-steps to stay free
    of chatter. ``cp`` and ``ground_height`` may be per environment, as in
    contact_forces, and so may ``spec``'s payload (``mass`` (B, 18), ``com``
    (B, 18, 3)): the controller's model stays nominal while each
    environment's plant carries its own."""
    tau = torch.clamp(tau_joints, -spec.torque_limit, spec.torque_limit)
    h = dt / substeps
    q, v, t = state
    for _ in range(substeps):
        f_c = contact_forces(spec, q, v, cp, ground_height)
        a = dyn.forward_dynamics(spec, q, v, tau, f_ext_feet=f_c)
        if f_ext is not None:
            # each environment's own total mass (a payload spec's (B, 1))
            a = torch.cat([a[..., :3] + f_ext[..., :3] / spec.mass.sum(-1, keepdim=True),
                           a[..., 3:]], dim=-1)
        v = v + h * a
        q = q + h * v
        t = t + h
    return SimState(q, v, t)


def graphed(fn, *example):
    """``fn`` (tensors -> a tuple of tensors) as one CUDA graph, captured at
    the example inputs' shapes: ``call(*tensors)`` copies them into the
    graph's input buffers, replays the graph and returns its output
    buffers, which the next call overwrites. A replay launches the kernels
    ``fn`` launches, in the same order, with none of the host's per-launch
    cost (the eager plant step is host-bound: ~3,800 launches). ``fn`` may
    not copy from the host or wait for the device (``device_sim.step``
    does neither). ``call`` holds ``fn``, so the tensors it closes over
    live as long as the graph that reads them. On CPU tensors ``call`` is
    ``fn``."""
    if example[0].device.type != "cuda":
        return fn
    inputs = [t.clone() for t in example]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = fn(*inputs)

    def call(*args):
        for buf, a in zip(inputs, args):
            buf.copy_(a)
        graph.replay()
        return outputs

    # the graph reads the tensors fn closes over (the spec, the contact
    # parameters) where they lay at capture: keep fn, and so them, alive as
    # long as the graph, or their memory goes back to the allocator and the
    # replays read whatever is put there next
    call.fn = fn
    return call


def pd_rollout(spec: RobotSpec, q0, v0, pd_targets, kp: float = 20.0,
               kd: float = 1.5, dt: float = 1.0e-3,
               cp: Optional[ContactParams] = None, force_schedule=None):
    """Roll T steps under joint PD toward ``pd_targets`` (T, ..., 12), with
    an optional (T, ..., 3) base-force schedule. Returns (Q, V), each
    (T, ..., 18), the states after each step."""
    cp = cp or contact_params_for(spec, q0.dtype, q0.device)
    state = SimState(q0, v0, torch.zeros(q0.shape[:-1], dtype=q0.dtype, device=q0.device))
    Q, V = [], []
    for k in range(pd_targets.shape[0]):
        tau = kp * (pd_targets[k] - state.q[..., 6:]) - kd * state.v[..., 6:]
        f_ext = None if force_schedule is None else force_schedule[k]
        state = step(spec, state, tau, cp, dt, f_ext=f_ext)
        Q.append(state.q)
        V.append(state.v)
    return torch.stack(Q), torch.stack(V)


def make_batched_policy_rollout(spec: RobotSpec, policy, T: int, kp: float = 20.0,
                                kd: float = 1.5, dt: float = 1.0e-3, device=None):
    """Batched rollout of a learned policy on the plant (the JAX package's
    ``jax_sim.make_batched_policy_rollout``).

    ``policy``: ``load_policy``'s (net, norm) pair. Each step: observation
    (phase 0) -> normalised input -> ``ServedPolicy`` (PD targets and the
    torque kp (target - q_j) - kd v_j: in one kernel on a CUDA device for
    the widths kernel 8 takes, else by the fp32 addmm chain) -> plant
    step. Returns fn(q0 (B, 18), v0 (B, 18), v_des
    (B, 3)) -> (Q (B, T, 18), V (B, T, 18), fell (B,)): the states after each
    step and whether the base went below 0.15 m or tilted beyond 0.6 rad.
    Runs on ``device``, by default the CUDA card."""
    dev = resolve_device(device)
    spec = spec.to(dev)
    served = ServedPolicy(*policy, device=dev)
    cp = contact_params_for(spec, device=dev)

    def fn(q0, v0, v_des):
        q0, v0, v_des = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                         for x in (q0, v0, v_des))
        B = q0.shape[0]
        state = SimState(q0, v0, torch.zeros(B, device=dev))
        Q = torch.empty(B, T, 18, device=dev)
        V = torch.empty(B, T, 18, device=dev)
        for k in range(T):
            s44 = policy_state(spec, state.q, state.v)
            _, tau = served(s44, v_des, state.q[:, 6:], state.v[:, 6:], kp, kd)
            state = step(spec, state, tau, cp, dt)
            Q[:, k], V[:, k] = state.q, state.v
        fell = (Q[..., 2] < 0.15).any(1) | (Q[..., 4:6].abs() > 0.6).any(2).any(1)
        return Q, V, fell

    return fn
