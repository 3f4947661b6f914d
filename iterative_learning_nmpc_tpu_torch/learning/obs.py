"""The policy observation contract on the device, batched.

Counterpart of ``iterative_learning_nmpc_tpu/learning/obs.py``:
state(44) = [phase(1), qvel_mj(18), qpos_mj[2:](17), base_wrt_feet(8)],
input(47) = [state, v_des].
"""
from __future__ import annotations

import torch

from ..models import dynamics as dyn
from ..models.transforms import convert_to_mujoco
from ..robots.spec import RobotSpec


def policy_state(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor,
                 phase: float = 0.0) -> torch.Tensor:
    """(..., 44) observations from chart states q, v (..., 18)."""
    q_mj, v_mj = convert_to_mujoco(q, v)
    p_feet = dyn.foot_positions(spec, q)
    base_wrt_feet = (q_mj[..., None, :3] - p_feet)[..., :2].reshape(q.shape[:-1] + (8,))
    return torch.cat([torch.full(q.shape[:-1] + (1,), phase, dtype=q.dtype, device=q.device),
                      v_mj, q_mj[..., 2:], base_wrt_feet], dim=-1)


def policy_input(spec: RobotSpec, q: torch.Tensor, v: torch.Tensor, v_des,
                 phase: float = 0.0) -> torch.Tensor:
    """(..., 47) network inputs: observation + velocity goal."""
    v_des = torch.as_tensor(v_des, dtype=q.dtype, device=q.device)
    return torch.cat([policy_state(spec, q, v, phase),
                      v_des.expand(q.shape[:-1] + (3,))], dim=-1)
