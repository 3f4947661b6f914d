"""Safety and fall thresholds, the SafeDAgger unsafe-state monitor and the
fall test.

The port's own copy of ``iterative_learning_nmpc_tpu/learning/safety.py``
(the same constants and the numpy ``check_unsafe_state_v2``), plus the
batched tensor monitors of the on-device rollouts
(``learning/ondevice.py:135-147`` and ``:314-322`` of the JAX package):

- UNSAFE_*: the runtime monitor that hands control to the MPC expert,
  deliberately conservative so that the expert engages before a fall;
- FALL_*: the looser test that marks a datagen rollout as fallen.
"""
from __future__ import annotations

import numpy as np
import torch

# --- SafeDAgger unsafe-state monitor (check_unsafe_state_v2) ---
UNSAFE_HEIGHT_BOUNDS = (0.18, 0.45)        # m
UNSAFE_MAX_ROLL_PITCH_DEG = 25.0           # deg
VEL_TRACK_TOL = 0.10                       # m/s

# per-joint bounds in degrees, (lo, hi) by joint kind within each leg
JOINT_BOUNDS_DEG = {
    "hip": (-70.0, 70.0),
    "thigh": (25.0, 115.0),
    "calf": (-155.0, -60.0),
}

# flat (12, 2) bound array in leg-major order [hip, thigh, calf] x 4 legs
JOINT_BOUNDS_FLAT = np.asarray(
    [JOINT_BOUNDS_DEG[k] for k in ("hip", "thigh", "calf")] * 4
)

# --- hard-fall detection (rollout discard) ---
FALL_HEIGHT_BOUNDS = (0.15, 0.5)           # m
FALL_MAX_TILT_RAD = 0.5                    # rad, |roll| and |pitch|


def check_unsafe_state_v2(q_mj: np.ndarray, v_mj: np.ndarray,
                          v_des: np.ndarray,
                          height_bounds=UNSAFE_HEIGHT_BOUNDS) -> bool:
    """Pose + joint-limit + velocity-tracking monitor on one MuJoCo-layout
    state (numpy)."""
    from ..models import transforms_np as tnp

    q = np.asarray(q_mj)
    v = np.asarray(v_mj)
    ypr = tnp.matrix_to_ypr(tnp.quat_wxyz_to_matrix(q[3:7]))
    roll, pitch = ypr[2], ypr[1]
    max_rp = np.deg2rad(UNSAFE_MAX_ROLL_PITCH_DEG)
    lo_h, hi_h = height_bounds
    unsafe_pose = (
        abs(roll) > max_rp
        or abs(pitch) > max_rp
        or q[2] < lo_h
        or q[2] > hi_h
    )
    joint_deg = np.rad2deg(q[7:])
    joint_violation = bool(
        np.any(joint_deg < JOINT_BOUNDS_FLAT[:, 0])
        or np.any(joint_deg > JOINT_BOUNDS_FLAT[:, 1])
    )
    vel_err = np.abs(v[:2] - np.asarray(v_des)[:2])
    unsafe_tracking = bool(np.any(vel_err > VEL_TRACK_TOL))
    return bool(unsafe_pose or joint_violation or unsafe_tracking)


def unsafe_v2(q: torch.Tensor, v: torch.Tensor, v_des: torch.Tensor,
              height_bounds=UNSAFE_HEIGHT_BOUNDS,
              vel_track_tol: float = VEL_TRACK_TOL) -> torch.Tensor:
    """check_unsafe_state_v2 on chart states (..., 18) (q[3:6] = yaw, pitch,
    roll; v[:2] the world x, y velocity) against goals (..., 3): a bool
    tensor (...). The thresholds compare in the state's precision."""
    max_rp = float(np.deg2rad(UNSAFE_MAX_ROLL_PITCH_DEG))
    jb = torch.as_tensor(np.deg2rad(JOINT_BOUNDS_FLAT).astype(np.float32),
                         dtype=q.dtype, device=q.device)
    lo_h, hi_h = height_bounds
    pose = ((q[..., 5].abs() > max_rp) | (q[..., 4].abs() > max_rp)
            | (q[..., 2] < lo_h) | (q[..., 2] > hi_h))
    joints = ((q[..., 6:] < jb[:, 0]) | (q[..., 6:] > jb[:, 1])).any(-1)
    track = ((v[..., :2] - v_des[..., :2]).abs() > vel_track_tol).any(-1)
    return pose | joints | track


def upright(q: torch.Tensor) -> torch.Tensor:
    """The fall test's complement on chart states (..., 18): base height
    inside FALL_HEIGHT_BOUNDS and |pitch|, |roll| below FALL_MAX_TILT_RAD."""
    return ((q[..., 2] > FALL_HEIGHT_BOUNDS[0]) & (q[..., 2] < FALL_HEIGHT_BOUNDS[1])
            & (q[..., 4].abs() < FALL_MAX_TILT_RAD)
            & (q[..., 5].abs() < FALL_MAX_TILT_RAD))
