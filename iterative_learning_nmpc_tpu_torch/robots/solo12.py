"""ODRI Solo12-class quadruped model (same parameter table as the JAX
package's ``robots/solo12.py``): a ~2.5 kg robot with 2.7 Nm actuators."""
import numpy as np
import torch

from .spec import RobotSpec, build_quadruped_spec

_Q_HOME = [0.0, 0.8, -1.6]


def solo12_spec(dtype=torch.float32, device=None, urdf_path=None) -> RobotSpec:
    """Solo12 model on ``device`` (by default the CUDA card). With
    ``urdf_path``, the robot description file is parsed instead
    (``robots.urdf.parse_urdf``)."""
    if urdf_path is not None:
        from .urdf import parse_urdf

        return parse_urdf(urdf_path, name="solo12", q_home_joints=_Q_HOME,
                          base_height_home=0.25, dtype=dtype, device=device)
    return build_quadruped_spec(
        name="solo12",
        trunk_mass=1.16115,
        trunk_com=[0.0, 0.0, 0.0],
        trunk_inertia=np.diag([0.00578574, 0.01938108, 0.02476124]),
        hip_xy=[
            [0.1946, 0.0875],
            [0.1946, -0.0875],
            [-0.1946, 0.0875],
            [-0.1946, -0.0875],
        ],
        thigh_y=0.014,
        thigh_len=0.16,
        calf_len=0.16,
        hip_mass=0.148,
        hip_com=[-0.0008, 0.009, 0.0],
        hip_inertia=np.diag([0.0000561, 0.0000954, 0.0000660]),
        thigh_mass=0.1484,
        thigh_com=[0.0, 0.0189, -0.0785],
        thigh_inertia=np.diag([0.000417, 0.000410, 0.0000269]),
        calf_mass=0.0332,
        calf_com=[0.0, 0.0, -0.0935],
        calf_inertia=np.diag([0.000124, 0.000124, 0.0000032]),
        foot_radius=0.016,
        torque_limit=[2.7, 2.7, 2.7],
        q_home_joints=_Q_HOME,
        joint_limits=[
            [-0.9, 0.9],
            [-1.45, 1.45],
            [-2.8, -0.8],
        ],
        base_height_home=0.25,
        dtype=dtype,
        device=device,
    )
