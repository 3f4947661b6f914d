"""State-chart conversions between MuJoCo and the Euler-chart model, on
tensors with any leading batch dims.

Counterpart of ``iterative_learning_nmpc_tpu/models/transforms.py``. MuJoCo
free-joint state: qpos = [p(3), quat wxyz(4), joints(12)], qvel = [v_lin
world(3), omega body-local(3), joint rates(12)]. Model chart: q = [p(3),
(yaw, pitch, roll)(3), joints(12)], v = dq/dt. ``transforms_np`` keeps the
numpy versions for the host control loop.
"""
from __future__ import annotations

import torch

from .math3d import (
    euler_rate_to_local_angular,
    local_angular_to_euler_rate,
    matrix_to_quat_wxyz,
    matrix_to_ypr,
    quat_wxyz_to_matrix,
    ypr_to_matrix,
)


def quat_state_to_ypr_state(q_mj: torch.Tensor) -> torch.Tensor:
    """MuJoCo qpos (..., 19) -> Euler-chart q (..., 18)."""
    ypr = matrix_to_ypr(quat_wxyz_to_matrix(q_mj[..., 3:7]))
    return torch.cat([q_mj[..., :3], ypr, q_mj[..., 7:]], dim=-1)


def ypr_state_to_quat_state(q: torch.Tensor) -> torch.Tensor:
    """Euler-chart q (..., 18) -> MuJoCo qpos (..., 19)."""
    quat = matrix_to_quat_wxyz(ypr_to_matrix(q[..., 3:6]))
    return torch.cat([q[..., :3], quat, q[..., 6:]], dim=-1)


def vel_from_mujoco(q: torch.Tensor, v_mj: torch.Tensor) -> torch.Tensor:
    """MuJoCo qvel -> chart velocity (Euler rates), given chart q."""
    ypr_rate = local_angular_to_euler_rate(q[..., 3:6], v_mj[..., 3:6])
    return torch.cat([v_mj[..., :3], ypr_rate, v_mj[..., 6:]], dim=-1)


def vel_to_mujoco(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Chart velocity -> MuJoCo qvel, given chart q."""
    w_local = euler_rate_to_local_angular(q[..., 3:6], v[..., 3:6])
    return torch.cat([v[..., :3], w_local, v[..., 6:]], dim=-1)


def convert_from_mujoco(q_mj: torch.Tensor, v_mj: torch.Tensor):
    """(qpos, qvel) -> chart (q, v)."""
    q = quat_state_to_ypr_state(q_mj)
    return q, vel_from_mujoco(q, v_mj)


def convert_to_mujoco(q: torch.Tensor, v: torch.Tensor):
    """Chart (q, v) -> (qpos, qvel)."""
    return ypr_state_to_quat_state(q), vel_to_mujoco(q, v)


def v_global_to_local(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Chart velocity (..., 18) with the base linear velocity rotated into
    the base frame, R(ypr)^T v[:3]; the rest as it is."""
    R_WB = ypr_to_matrix(q[..., 3:6])
    v_loc = (R_WB.transpose(-1, -2) @ v[..., :3, None])[..., 0]
    return torch.cat([v_loc, v[..., 3:]], dim=-1)
