"""Robot model specification: a dataclass of tensors.

Counterpart of ``iterative_learning_nmpc_tpu/robots/spec.py``. Conventions
are identical: the floating base is 6 explicit DOFs (x, y, z prismatic,
then yaw, pitch, roll revolute), so ``q[:6] = [x, y, z, yaw, pitch, roll]``
and ``v = dq/dt``; joints follow in the order FL, FR, RL, RR (hip, thigh,
calf); DOF 5 carries the trunk inertia, DOFs 6.. the leg links.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

PRISMATIC = 0
REVOLUTE = 1

FEET_ORDER = ("FL", "FR", "RL", "RR")

_TENSOR_FIELDS = ("joint_axis", "joint_pos", "mass", "com", "inertia",
                  "foot_offset", "foot_radius", "torque_limit", "q_home",
                  "joint_limits")


@dataclasses.dataclass(frozen=True)
class RobotSpec:
    """Kinematic-tree robot model. Metadata fields are plain Python; the
    tensor fields live on one device (see ``to``)."""

    name: str
    nv: int                        # total DOFs (18)
    nu: int                        # actuated DOFs (12)
    parent: Tuple[int, ...]
    jtype: Tuple[int, ...]
    foot_body: Tuple[int, ...]
    feet_frame_names: Tuple[str, ...]

    joint_axis: torch.Tensor       # (nv, 3) joint axis in the joint frame
    joint_pos: torch.Tensor        # (nv, 3) joint origin in the parent frame
    mass: torch.Tensor             # (nv,)
    com: torch.Tensor              # (nv, 3) body CoM in the body frame
    inertia: torch.Tensor          # (nv, 3, 3) about the CoM, body frame
    foot_offset: torch.Tensor      # (4, 3) foot point in its body frame
    foot_radius: torch.Tensor      # ()
    torque_limit: torch.Tensor     # (nu,)
    q_home: torch.Tensor           # (nv,)
    joint_limits: torch.Tensor     # (nu, 2)

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def to(self, device) -> "RobotSpec":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})


def _base_dofs():
    parent = [-1, 0, 1, 2, 3, 4]
    jtype = [PRISMATIC, PRISMATIC, PRISMATIC, REVOLUTE, REVOLUTE, REVOLUTE]
    axis = [[1, 0, 0], [0, 1, 0], [0, 0, 1],
            [0, 0, 1], [0, 1, 0], [1, 0, 0]]
    pos = [[0, 0, 0]] * 6
    return parent, jtype, axis, pos


def build_quadruped_spec(
    name: str,
    trunk_mass: float,
    trunk_com,
    trunk_inertia,
    hip_xy,
    thigh_y: float,
    thigh_len: float,
    calf_len: float,
    hip_mass: float, hip_com, hip_inertia,
    thigh_mass: float, thigh_com, thigh_inertia,
    calf_mass: float, calf_com, calf_inertia,
    foot_radius: float,
    torque_limit,
    q_home_joints,
    joint_limits,
    base_height_home: float,
    dtype=torch.float32,
    device=None,
) -> RobotSpec:
    """Assemble a 4-legged RobotSpec from per-leg link parameters; left/right
    legs mirror in y, front/rear hip CoMs in x (same rules as the JAX
    package's ``build_quadruped_spec``). The tensors go to ``device``, by
    default the CUDA card (``device.resolve_device``)."""
    device = resolve_device(device)
    parent, jtype, axis, pos = _base_dofs()
    mass = [0.0] * 5 + [trunk_mass]
    com = [[0, 0, 0]] * 5 + [list(trunk_com)]
    inertia = [np.zeros((3, 3))] * 5 + [np.asarray(trunk_inertia, np.float64)]

    foot_body = []
    signs_y = {"FL": 1.0, "FR": -1.0, "RL": 1.0, "RR": -1.0}
    for i_leg, leg in enumerate(FEET_ORDER):
        sy = signs_y[leg]
        hip_idx = len(parent)
        parent.append(5)
        jtype.append(REVOLUTE)
        axis.append([1, 0, 0])
        pos.append([hip_xy[i_leg][0], hip_xy[i_leg][1], 0.0])
        mass.append(hip_mass)
        c = np.asarray(hip_com, np.float64).copy()
        c[0] *= 1.0 if leg in ("FL", "FR") else -1.0
        c[1] *= sy
        com.append(list(c))
        inertia.append(np.diag(np.diag(np.asarray(hip_inertia, np.float64))))
        parent.append(hip_idx)
        jtype.append(REVOLUTE)
        axis.append([0, 1, 0])
        pos.append([0.0, sy * thigh_y, 0.0])
        mass.append(thigh_mass)
        c = np.asarray(thigh_com, np.float64).copy()
        c[1] *= sy
        com.append(list(c))
        inertia.append(np.diag(np.diag(np.asarray(thigh_inertia, np.float64))))
        parent.append(hip_idx + 1)
        jtype.append(REVOLUTE)
        axis.append([0, 1, 0])
        pos.append([0.0, 0.0, -thigh_len])
        mass.append(calf_mass)
        com.append(list(np.asarray(calf_com, np.float64)))
        inertia.append(np.diag(np.diag(np.asarray(calf_inertia, np.float64))))
        foot_body.append(hip_idx + 2)

    nvt = len(parent)
    q_home = np.zeros(nvt)
    q_home[2] = base_height_home
    for i_leg in range(4):
        q_home[6 + 3 * i_leg: 9 + 3 * i_leg] = q_home_joints
        if FEET_ORDER[i_leg] in ("FR", "RR"):
            q_home[6 + 3 * i_leg] *= -1.0

    # round through float32 numpy first so the tensors hold exactly the
    # values the JAX package's numpy leaves hold
    npd = np.dtype(str(dtype).replace("torch.", ""))
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=npd), device=device)
    return RobotSpec(
        name=name,
        nv=nvt,
        nu=nvt - 6,
        parent=tuple(parent),
        jtype=tuple(jtype),
        foot_body=tuple(foot_body),
        feet_frame_names=tuple(f"{leg}_foot" for leg in FEET_ORDER),
        joint_axis=t(axis),
        joint_pos=t(pos),
        mass=t(mass),
        com=t(com),
        inertia=t(np.stack(inertia)),
        foot_offset=t([[0.0, 0.0, -calf_len]] * 4),
        foot_radius=t(foot_radius),
        torque_limit=t(list(torque_limit) * 4),
        q_home=t(q_home),
        joint_limits=t(list(joint_limits) * 4),
    )
