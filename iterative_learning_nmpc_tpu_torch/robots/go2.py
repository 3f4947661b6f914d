"""Unitree Go2-class quadruped model (same parameter table as the JAX
package's ``robots/go2.py``)."""
import numpy as np
import torch

from .spec import RobotSpec, build_quadruped_spec

_Q_HOME = [0.0, 0.9, -1.8]


def go2_spec(dtype=torch.float32, device=None, urdf_path=None) -> RobotSpec:
    """Go2 model on ``device`` (by default the CUDA card). With
    ``urdf_path``, the robot description file is parsed instead
    (``robots.urdf.parse_urdf``); ``assets/go2.urdf`` is this table
    exported."""
    if urdf_path is not None:
        from .urdf import parse_urdf

        return parse_urdf(urdf_path, name="go2", q_home_joints=_Q_HOME,
                          base_height_home=0.315, dtype=dtype, device=device)
    return build_quadruped_spec(
        name="go2",
        trunk_mass=6.921,
        trunk_com=[0.0223, 0.002, -0.0005],
        trunk_inertia=np.array([
            [0.02448, 0.0, 0.0],
            [0.0, 0.098077, 0.0],
            [0.0, 0.0, 0.107],
        ]),
        hip_xy=[
            [0.1934, 0.0465],    # FL
            [0.1934, -0.0465],   # FR
            [-0.1934, 0.0465],   # RL
            [-0.1934, -0.0465],  # RR
        ],
        thigh_y=0.0955,
        thigh_len=0.213,
        calf_len=0.213,
        hip_mass=0.678,
        hip_com=[-0.0054, 0.00194, -0.000105],
        hip_inertia=np.diag([0.00048, 0.000884, 0.000596]),
        thigh_mass=1.152,
        thigh_com=[-0.00374, -0.0223, -0.0327],
        thigh_inertia=np.diag([0.00584, 0.0058, 0.00103]),
        calf_mass=0.241,
        calf_com=[0.005, 0.0, -0.11],
        calf_inertia=np.diag([0.0014, 0.0014, 0.00008]),
        foot_radius=0.022,
        torque_limit=[23.7, 23.7, 45.43],
        q_home_joints=_Q_HOME,
        joint_limits=[
            [-1.0472, 1.0472],
            [-1.5708, 3.4907],
            [-2.7227, -0.83776],
        ],
        base_height_home=0.315,
        dtype=dtype,
        device=device,
    )
