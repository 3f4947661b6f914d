"""Rotation helpers of the dynamics and the state charts (batched over
leading dims).

Conventions match ``iterative_learning_nmpc_tpu/models/math3d.py``: Euler
angles are stored as [yaw, pitch, roll], R = Rz(yaw) Ry(pitch) Rx(roll),
quaternions as wxyz (MuJoCo order).
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
    # built on the device (no host-to-device copy), so that the plant step
    # can be captured in a CUDA graph
    return torch.eye(3, dtype=like.dtype, device=like.device)[i]


def rot_x(a: torch.Tensor) -> torch.Tensor:
    """Rotation about x by angles a (...) -> (..., 3, 3)."""
    return rotation_about_axis(_unit(0, a), a)


def rot_y(a: torch.Tensor) -> torch.Tensor:
    return rotation_about_axis(_unit(1, a), a)


def rot_z(a: torch.Tensor) -> torch.Tensor:
    return rotation_about_axis(_unit(2, a), a)


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


def matrix_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """Inverse of ypr_to_matrix, (..., 3, 3) -> [yaw, pitch, roll] (..., 3),
    pitch in [-pi/2, pi/2]."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def quat_wxyz_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """MuJoCo wxyz quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def matrix_to_quat_wxyz(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> wxyz quaternion (..., 4) with w >= 0.
    Branch-free, as the JAX package's: four candidates, the one with the
    largest score (the first on a tie) is normalised, then the sign rule."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    half_sqrt = lambda x: torch.sqrt(torch.clamp_min(x, 1e-12)) / 2.0
    qw = half_sqrt(1.0 + tr)
    qx = half_sqrt(1.0 + m00 - m11 - m22)
    qy = half_sqrt(1.0 - m00 + m11 - m22)
    qz = half_sqrt(1.0 - m00 - m11 + m22)
    cands = torch.stack([
        torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                     (m10 - m01) / (4 * qw)], dim=-1),
        torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                     (m02 + m20) / (4 * qx)], dim=-1),
        torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                     (m12 + m21) / (4 * qy)], dim=-1),
        torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                     (m12 + m21) / (4 * qz), qz], dim=-1),
    ], dim=-2)                                                # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11],
                         dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def local_angular_to_euler_rate(ypr: torch.Tensor, w_local: torch.Tensor) -> torch.Tensor:
    """Body-frame angular velocity -> d/dt [yaw, pitch, roll], (..., 3)."""
    p, r = ypr[..., 1], ypr[..., 2]
    cx, sx = torch.cos(r), torch.sin(r)
    cy, sy = torch.cos(p), torch.sin(p)
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    T = torch.stack([
        torch.stack([zero, sx / cy, cx / cy], dim=-1),
        torch.stack([zero, cx, -sx], dim=-1),
        torch.stack([one, sx * sy / cy, cx * sy / cy], dim=-1),
    ], dim=-2)
    return (T @ w_local[..., None])[..., 0]


def euler_rate_to_local_angular(ypr: torch.Tensor, ypr_rate: torch.Tensor) -> torch.Tensor:
    """d/dt [yaw, pitch, roll] -> body-frame angular velocity, (..., 3)."""
    return (euler_rate_matrix(ypr) @ ypr_rate[..., None])[..., 0]


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
