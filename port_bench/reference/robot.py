"""The benchmark's own reading of a quadruped URDF.

A small parser for the robot files under ``port_bench/robots/``: a floating
trunk link and four legs of three revolute joints (hip, thigh, calf), each
leg ending in a fixed foot link whose collision sphere gives the foot radius.
Every joint origin must carry a zero ``rpy``; the parser refuses anything
else rather than guess. Legs are found by the name prefixes ``fl_``, ``fr_``,
``rl_`` and ``rr_`` and ordered FL, FR, RL, RR.

State conventions: q = [x, y, z, yaw, pitch, roll, 12 joint angles leg-major
hip to calf], v = dq/dt.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch

LEGS = ("fl", "fr", "rl", "rr")
PARTS = ("hip", "thigh", "calf")


@dataclasses.dataclass(frozen=True)
class Robot:
    """Leg-major tensors of one quadruped, all in one dtype and device."""

    trunk_mass: torch.Tensor      # ()
    trunk_com: torch.Tensor       # (3,)
    trunk_inertia: torch.Tensor   # (3, 3) about the CoM
    joint_pos: torch.Tensor       # (4, 3, 3) joint origin in the parent link
    joint_axis: torch.Tensor      # (4, 3, 3)
    link_mass: torch.Tensor       # (4, 3)
    link_com: torch.Tensor        # (4, 3, 3)
    link_inertia: torch.Tensor    # (4, 3, 3, 3)
    foot_offset: torch.Tensor     # (4, 3) foot point in the calf link
    foot_radius: float
    torque_limit: torch.Tensor    # (12,)
    q_home: torch.Tensor          # (18,)

    def total_mass(self) -> torch.Tensor:
        return self.trunk_mass + self.link_mass.sum()


def _vec(el, attr, default="0 0 0"):
    return [float(t) for t in (el.get(attr, default) if el is not None else default).split()]


def _inertial(link):
    ine = link.find("inertial")
    org = ine.find("origin")
    if any(abs(a) > 0.0 for a in _vec(org, "rpy")):
        raise ValueError(f"{link.get('name')}: a rotated inertial frame is not supported")
    i = ine.find("inertia").attrib
    I = [[float(i["ixx"]), float(i.get("ixy", 0)), float(i.get("ixz", 0))],
         [float(i.get("ixy", 0)), float(i["iyy"]), float(i.get("iyz", 0))],
         [float(i.get("ixz", 0)), float(i.get("iyz", 0)), float(i["izz"])]]
    return float(ine.find("mass").get("value")), _vec(org, "xyz"), I


def load_robot(path: str, q_home_joints, base_height_home: float,
               dtype=torch.float64, device="cpu") -> Robot:
    """Parse ``path``. ``q_home_joints`` (hip, thigh, calf) is the nominal
    stance of the left legs; the right legs' hip angle is mirrored."""
    root = ET.parse(path).getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    joints = {j.get("name"): j for j in root.findall("joint")}
    by_child = {j.find("child").get("link"): j for j in joints.values()}
    jp, ax, lim, lm, lc, li, foot, radius = [], [], [], [], [], [], [], None
    for leg in LEGS:
        row = ([], [], [], [], [], [])
        for part in PARTS:
            j = joints[f"{leg}_{part}_joint"]
            if j.get("type") != "revolute":
                raise ValueError(f"{j.get('name')} is not revolute")
            org = j.find("origin")
            if any(abs(a) > 0.0 for a in _vec(org, "rpy")):
                raise ValueError(f"{j.get('name')}: a rotated joint frame is not supported")
            row[0].append(_vec(org, "xyz"))
            row[1].append(_vec(j.find("axis"), "xyz", "1 0 0"))
            row[2].append(float(j.find("limit").get("effort")))
            m, c, I = _inertial(links[j.find("child").get("link")])
            row[3].append(m)
            row[4].append(c)
            row[5].append(I)
        for lst, r in zip((jp, ax, lim, lm, lc, li), row):
            lst.append(r)
        fj = by_child[f"{leg}_foot"]
        if fj.get("type") != "fixed" or fj.find("parent").get("link") != f"{leg}_calf":
            raise ValueError(f"{leg}_foot must hang from {leg}_calf by a fixed joint")
        foot.append(_vec(fj.find("origin"), "xyz"))
        r = float(links[f"{leg}_foot"].find("collision/geometry/sphere").get("radius"))
        radius = r if radius is None else radius
    tm, tc, tI = _inertial(links["trunk"])
    q_home = np.zeros(18)
    q_home[2] = base_height_home
    for i, leg in enumerate(LEGS):
        q_home[6 + 3 * i:9 + 3 * i] = q_home_joints
        if leg in ("fr", "rr"):
            q_home[6 + 3 * i] *= -1.0
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return Robot(trunk_mass=t(tm), trunk_com=t(tc), trunk_inertia=t(tI),
                 joint_pos=t(jp), joint_axis=t(ax), link_mass=t(lm), link_com=t(lc),
                 link_inertia=t(li), foot_offset=t(foot), foot_radius=float(radius),
                 torque_limit=t(lim).reshape(12), q_home=t(q_home))
