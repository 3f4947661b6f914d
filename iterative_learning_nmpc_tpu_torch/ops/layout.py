"""Flat float32 buffers the CUDA kernels read: robot constants, cost
weights and per-node OCP parameters. The offsets are mirrored by the
``#define``s at the top of ``csrc/legdyn.cuh``; change both together.

The buffers are built on the tensors' device with tensor ops, so building
them never waits for the device.
"""
from __future__ import annotations

import weakref

import torch

from ..ocp.problem import OCPParams, Weights
from ..robots.spec import _TENSOR_FIELDS, RobotSpec

# robot constants, the layout of the JAX package's ops/dynjac_kernel
# _make_consts: leg joint offsets, axes, masses, CoMs, inertias, foot
# offsets, then the trunk mass, CoM and inertia
N_CONSTS = 36 + 36 + 12 + 36 + 108 + 12 + 1 + 3 + 9          # 253
# cost weights
N_WEIGHTS = 12 + 24 + 12 + 4 + 12 + 1 + 4 + 8 + 12            # 89
# per-node parameters: cnt 4 | peak 4 | plane z 4 | cnt_loc xy 8 |
# patch 4 | restrict | base_ref 12 | joint_ref 12 | step_h | lam_eq 18 |
# lam_ineq 36
N_NODE_PAR = 4 + 4 + 4 + 8 + 4 + 1 + 12 + 12 + 1 + 18 + 36  # 104
# terminal weights: wTe^2 (x-ordered, 36) | swing (4)
N_TERM = 40


def robot_consts(spec: RobotSpec) -> torch.Tensor:
    c = torch.cat([
        spec.joint_pos[6:].reshape(-1), spec.joint_axis[6:].reshape(-1),
        spec.mass[6:].reshape(-1), spec.com[6:].reshape(-1),
        spec.inertia[6:].reshape(-1), spec.foot_offset.reshape(-1),
        spec.mass[5:6], spec.com[5], spec.inertia[5].reshape(-1),
    ]).to(torch.float32).contiguous()
    assert c.numel() == N_CONSTS
    return c


_ROBOT_CONSTS = weakref.WeakKeyDictionary()    # spec -> {device: (versions, consts)}


def cached_robot_consts(spec: RobotSpec, device: torch.device) -> torch.Tensor:
    """robot_consts(spec) on ``device``, as the kernel wrappers pass it:
    built on the spec's first call on that device and kept (rebuilt on
    every call it was most of a wrapper's host time). After a spec tensor
    changed in place the kept buffer is refilled in place, so a CUDA graph
    that captured it reads the new values. Under capture a kept, current
    buffer is returned as it is; a missing or stale one is built in the
    graph's pool and not kept."""
    versions = tuple(getattr(spec, f)._version for f in _TENSOR_FIELDS)
    per_device = _ROBOT_CONSTS.setdefault(spec, {})
    hit = per_device.get(device)
    if hit is not None and hit[0] == versions:
        return hit[1]
    consts = robot_consts(spec.to(device))
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return consts
    if hit is not None:
        consts = hit[1].copy_(consts)
    per_device[device] = (versions, consts)
    return consts


def weight_consts(spec: RobotSpec, w: Weights) -> torch.Tensor:
    s = lambda t: t.reshape(-1)
    c = torch.cat([
        s(w.base), s(w.joint), s(w.acc), s(w.swing), s(w.f_reg),
        s(w.foot_disp), s(w.stab_gain), s(w.dyn_cons), s(w.contact_vel),
        s(w.cone), s(w.swing_clear), s(w.torque), s(w.patch), s(w.mu),
        s(w.total_weight), s(spec.torque_limit),
    ]).to(torch.float32).contiguous()
    assert c.numel() == N_WEIGHTS
    return c


def terminal_consts(w: Weights) -> torch.Tensor:
    """[wTe^2 over the x columns | swing weights]; x columns are base pos 6,
    joint pos 12, base vel 6, joint vel 12 (ocp.problem terminal_residual)."""
    wTe = torch.cat([w.base_e[:6], w.joint_e[:12], w.base_e[6:], w.joint_e[12:]])
    return torch.cat([wTe * wTe, w.swing]).to(torch.float32).contiguous()


def node_params(p: OCPParams, N: int) -> torch.Tensor:
    """Per-(problem, node) parameters, (B*N, N_NODE_PAR), node-major within
    each problem (row b*N + n)."""
    B = p.x0.shape[0]
    per_node = lambda t: t[:, :, :N].transpose(1, 2)               # (B, N, 4)
    per_prob = lambda t: t.reshape(B, 1, -1).expand(B, N, -1)
    par = torch.cat([
        per_node(p.cnt), per_node(p.peak),
        per_node(p.plane_point[..., 2]),
        p.cnt_loc[:, :, :N, :2].permute(0, 2, 1, 3).reshape(B, N, 8),
        per_node(p.patch_radius),
        per_prob(p.restrict), per_prob(p.base_ref), per_prob(p.joint_ref),
        per_prob(p.step_height), p.lam_eq, p.lam_ineq,
    ], dim=2)
    assert par.shape[-1] == N_NODE_PAR
    return par.reshape(B * N, N_NODE_PAR).to(torch.float32).contiguous()
