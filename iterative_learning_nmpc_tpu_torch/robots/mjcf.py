"""Generate a MuJoCo MJCF model from a RobotSpec.

Counterpart of ``iterative_learning_nmpc_tpu/robots/mjcf.py``: the same
text for the same spec. The MJCF is generated from the RobotSpec that
drives the dynamics, so the controller's model and the simulated plant
agree, and MuJoCo doubles as an independent oracle for the FK, RNEA and
mass-matrix tests. The spec's tensors are read on the host as float32
numpy arrays, so each number prints as the JAX package prints it.
MuJoCo itself is imported only by ``make_mj_model``.
"""
from __future__ import annotations

import numpy as np
import torch

from .spec import FEET_ORDER, RobotSpec

_LEG_JOINT_SUFFIX = ("hip", "thigh", "calf")


def joint_names(spec: RobotSpec):
    return [f"{leg}_{suffix}" for leg in FEET_ORDER for suffix in _LEG_JOINT_SUFFIX]


def mjcf_from_spec(
    spec: RobotSpec,
    timestep: float = 1.0e-3,
    friction: float = 0.8,
    with_floor: bool = True,
    armature: float = 0.0,
    joint_damping: float = 0.0,
) -> str:
    """Build an MJCF XML string for the quadruped spec.

    Bodies: trunk (freejoint) -> per leg hip -> thigh -> calf(+foot geom).
    Only feet, calves and the trunk box carry collision geoms; the simulator
    uses non-foot floor contacts as a fall/termination signal (mirrors the
    reference's allowed_collision=["FL","FR","RL","RR","floor"]).
    """
    if spec.batch_shape:
        raise ValueError("mjcf_from_spec takes a nominal spec, not a per-environment payload")
    host = lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    ja = host(spec.joint_axis)
    jp = host(spec.joint_pos)
    mass = host(spec.mass)
    com = host(spec.com)
    inertia = host(spec.inertia)
    foot_off = host(spec.foot_offset)
    foot_r = float(host(spec.foot_radius))
    tl = host(spec.torque_limit)
    jl = host(spec.joint_limits)
    q_home = host(spec.q_home)

    def fmt(v):
        return " ".join(f"{x:.8g}" for x in np.atleast_1d(v))

    def inertial(i):
        full = inertia[i]
        diag = np.diag(full)
        return (
            f'<inertial pos="{fmt(com[i])}" mass="{mass[i]:.8g}" '
            f'diaginertia="{fmt(diag)}"/>'
        )

    lines = []
    lines.append(f'<mujoco model="{spec.name}">')
    lines.append('  <compiler angle="radian" inertiafromgeom="false"/>')
    lines.append(f'  <option timestep="{timestep}" integrator="Euler"/>')
    lines.append("  <default>")
    lines.append(
        f'    <geom contype="1" conaffinity="1" friction="{friction} 0.02 0.01" '
        'solref="0.005 1" solimp="0.9 0.95 0.001"/>'
    )
    if joint_damping or armature:
        lines.append(f'    <joint damping="{joint_damping}" armature="{armature}"/>')
    lines.append("  </default>")
    lines.append("  <worldbody>")
    if with_floor:
        lines.append(
            '    <geom name="floor" type="plane" size="20 20 0.1" pos="0 0 0" '
            'contype="1" conaffinity="1"/>'
        )

    trunk_i = 5
    lines.append(f'    <body name="trunk" pos="0 0 {q_home[2]:.8g}">')
    lines.append('      <freejoint name="root"/>')
    lines.append(f"      {inertial(trunk_i)}")
    lines.append(
        '      <geom name="trunk_geom" type="box" size="0.19 0.07 0.055" '
        'pos="0 0 0" density="0"/>'
    )

    for i_leg, leg in enumerate(FEET_ORDER):
        hip = 6 + 3 * i_leg
        thigh = hip + 1
        calf = hip + 2
        q_hip, q_thigh, q_calf = q_home[hip], q_home[thigh], q_home[calf]
        lo = jl[3 * i_leg: 3 * i_leg + 3]
        lines.append(f'      <body name="{leg}_hip_link" pos="{fmt(jp[hip])}">')
        lines.append(
            f'        <joint name="{leg}_hip" type="hinge" axis="{fmt(ja[hip])}" '
            f'pos="0 0 0" range="{lo[0,0]:.8g} {lo[0,1]:.8g}" ref="0"/>'
        )
        lines.append(f"        {inertial(hip)}")
        lines.append(f'        <body name="{leg}_thigh_link" pos="{fmt(jp[thigh])}">')
        lines.append(
            f'          <joint name="{leg}_thigh" type="hinge" axis="{fmt(ja[thigh])}" '
            f'pos="0 0 0" range="{lo[1,0]:.8g} {lo[1,1]:.8g}" ref="0"/>'
        )
        lines.append(f"          {inertial(thigh)}")
        thigh_len = -jp[calf][2]
        lines.append(
            f'          <geom name="{leg}_thigh_geom" type="capsule" '
            f'fromto="0 0 0 0 0 {-thigh_len:.8g}" size="0.015" density="0" '
            'contype="0" conaffinity="0"/>'
        )
        lines.append(f'          <body name="{leg}_calf_link" pos="{fmt(jp[calf])}">')
        lines.append(
            f'            <joint name="{leg}_calf" type="hinge" axis="{fmt(ja[calf])}" '
            f'pos="0 0 0" range="{lo[2,0]:.8g} {lo[2,1]:.8g}" ref="0"/>'
        )
        lines.append(f"            {inertial(calf)}")
        calf_len = -foot_off[i_leg][2]
        lines.append(
            f'            <geom name="{leg}_calf_geom" type="capsule" '
            f'fromto="0 0 0 0 0 {-calf_len + foot_r:.8g}" size="0.012" density="0"/>'
        )
        lines.append(
            f'            <geom name="{leg}_foot" type="sphere" size="{foot_r:.8g}" '
            f'pos="{fmt(foot_off[i_leg])}" density="0"/>'
        )
        lines.append("          </body>")  # calf
        lines.append("        </body>")  # thigh
        lines.append("      </body>")  # hip
    lines.append("    </body>")  # trunk
    lines.append("  </worldbody>")

    lines.append("  <actuator>")
    for k, jn in enumerate(joint_names(spec)):
        lines.append(
            f'    <motor name="{jn}_motor" joint="{jn}" '
            f'ctrlrange="{-tl[k]:.8g} {tl[k]:.8g}" gear="1"/>'
        )
    lines.append("  </actuator>")

    # keyframe: home configuration
    quat = "1 0 0 0"
    joints = " ".join(f"{q_home[6 + k]:.8g}" for k in range(spec.nu))
    lines.append("  <keyframe>")
    lines.append(
        f'    <key name="home" qpos="0 0 {q_home[2]:.8g} {quat} {joints}"/>'
    )
    lines.append("  </keyframe>")
    lines.append("</mujoco>")
    return "\n".join(lines)


def make_mj_model(spec: RobotSpec, **kwargs):
    """Compile the generated MJCF into an MjModel (CPU oracle)."""
    import mujoco

    return mujoco.MjModel.from_xml_string(mjcf_from_spec(spec, **kwargs))
