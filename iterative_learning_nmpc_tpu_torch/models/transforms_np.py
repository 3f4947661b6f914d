"""NumPy state conversions for the 1 kHz host control loop.

The port's own copy of ``iterative_learning_nmpc_tpu/models/transforms_np.py``
(the same functions, numpy only): MuJoCo layout (free joint: position,
wxyz quaternion, local angular velocity) <-> the Euler chart the solver uses
(``q[3:6] = [yaw, pitch, roll]``, ``v[3:6]`` their rates).
"""
from __future__ import annotations

import numpy as np


def quat_wxyz_to_matrix(q):
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def matrix_to_ypr(R):
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    yaw = np.arctan2(R[1, 0], R[0, 0])
    roll = np.arctan2(R[2, 1], R[2, 2])
    return np.array([yaw, pitch, roll])


def ypr_to_matrix(ypr):
    y, p, r = ypr
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def matrix_to_quat_wxyz(R):
    tr = np.trace(R)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2.0
        q = np.array(
            [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w)]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2.0
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def local_angular_to_euler_rate(ypr, w_local):
    _, p, r = ypr
    cx, sx = np.cos(r), np.sin(r)
    cy, sy = np.cos(p), np.sin(p)
    T = np.array(
        [[0.0, sx / cy, cx / cy], [0.0, cx, -sx], [1.0, sx * sy / cy, cx * sy / cy]]
    )
    return T @ w_local


def euler_rate_to_local_angular(ypr, ypr_rate):
    _, p, r = ypr
    cx, sx = np.cos(r), np.sin(r)
    cy, sy = np.cos(p), np.sin(p)
    T = np.array([[-sy, 0.0, 1.0], [cy * sx, cx, 0.0], [cx * cy, -sx, 0.0]])
    return T @ ypr_rate


def convert_from_mujoco(q_mj, v_mj):
    R = quat_wxyz_to_matrix(q_mj[3:7])
    ypr = matrix_to_ypr(R)
    q = np.concatenate([q_mj[:3], ypr, q_mj[7:]])
    v = np.concatenate([v_mj[:3], local_angular_to_euler_rate(ypr, v_mj[3:6]), v_mj[6:]])
    return q, v


def convert_to_mujoco(q, v):
    quat = matrix_to_quat_wxyz(ypr_to_matrix(q[3:6]))
    q_mj = np.concatenate([q[:3], quat, q[6:]])
    v_mj = np.concatenate([v[:3], euler_rate_to_local_angular(q[3:6], v[3:6]), v[6:]])
    return q_mj, v_mj
