"""Rotation helpers used by the dynamics (batched over leading dims).

Conventions match ``iterative_learning_nmpc_tpu/models/math3d.py``: Euler
angles are stored as [yaw, pitch, roll] and R = Rz(yaw) Ry(pitch) Rx(roll).
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3-vector cross product over the last dim, with broadcasting."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3), with broadcasting."""
    return (M * x.unsqueeze(-2)).sum(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rotation_about_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about constant unit axes: axis (..., 3) broadcast
    against angle (...) -> (..., 3, 3)."""
    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def _unit(i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros(3, dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e


def ypr_to_matrix(ypr: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] (..., 3) -> R = Rz(y) Ry(p) Rx(r) (..., 3, 3)."""
    rz = rotation_about_axis(_unit(2, ypr), ypr[..., 0])
    ry = rotation_about_axis(_unit(1, ypr), ypr[..., 1])
    rx = rotation_about_axis(_unit(0, ypr), ypr[..., 2])
    return rz @ ry @ rx


def euler_rate_matrix(ypr: torch.Tensor) -> torch.Tensor:
    """T (..., 3, 3) mapping d/dt [yaw, pitch, roll] to the body-frame
    angular velocity (the JAX package's euler_rate_to_local_angular)."""
    p, r = ypr[..., 1], ypr[..., 2]
    cx, sx = torch.cos(r), torch.sin(r)
    cy, sy = torch.cos(p), torch.sin(p)
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    return torch.stack([
        torch.stack([-sy, zero, one], dim=-1),
        torch.stack([cy * sx, cx, zero], dim=-1),
        torch.stack([cx * cy, -sx, zero], dim=-1),
    ], dim=-2)


def euler_rate_matrix_dot(ypr: torch.Tensor, ypr_rate: torch.Tensor) -> torch.Tensor:
    """dT/dt (..., 3, 3) given the pitch and roll rates."""
    p, r = ypr[..., 1], ypr[..., 2]
    pd, rd = ypr_rate[..., 1], ypr_rate[..., 2]
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    zero = torch.zeros_like(cp)
    return torch.stack([
        torch.stack([-cp * pd, zero, zero], dim=-1),
        torch.stack([-sp * pd * sr + cp * cr * rd, -sr * rd, zero], dim=-1),
        torch.stack([-sp * pd * cr - cp * sr * rd, -cr * rd, zero], dim=-1),
    ], dim=-2)
