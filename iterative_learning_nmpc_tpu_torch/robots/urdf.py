"""URDF ingestion: robot description files -> RobotSpec, and back.

Counterpart of ``iterative_learning_nmpc_tpu/robots/urdf.py`` (numpy and
``xml.etree`` only, so the same code parses here):

- ``parse_urdf(path)``: URDF XML -> RobotSpec. Fixed-joint subtrees are
  lumped into their movable parent as composite rigid bodies, static
  rotations anywhere in the tree are folded into the joint axes and
  everything downstream of them (``T(p) . C . Rot(a, q) = T(p) .
  Rot(C a, q) . C``), joints are classified by vendor names (``FL_hip_joint``,
  ``lf_haa``, ``LH_KFE``) or else by the tree's structure, and the foot
  points and radii come from the ``*_foot`` fixed links' collision spheres
  (else from a sphere-collision fixed link on a calf).
- ``spec_to_urdf(spec)``: export a RobotSpec as URDF.

The parse runs in float64 and the spec's tensors are made at the end, in
the dtype asked for, through numpy of that dtype (as ``build_quadruped_spec``
does), on ``device`` (by default the CUDA card).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .spec import FEET_ORDER, PRISMATIC, REVOLUTE, RobotSpec

_LEG_PARTS = ("hip", "thigh", "calf")

# vendor naming variants (Unitree go/a1, ODRI solo, ANYmal conventions)
_PART_ALIASES = {
    "hip": ("hip", "haa", "abad", "abduct"),
    "thigh": ("thigh", "hfe", "upper"),
    "calf": ("calf", "kfe", "knee", "lower", "shank"),
}
_LEG_ALIASES = {
    "FL": ("fl", "lf"),
    "FR": ("fr", "rf"),
    "RL": ("rl", "lh", "hl"),
    "RR": ("rr", "rh", "hr"),
}


def _leg_from_name(name: str) -> Optional[str]:
    low = name.lower()
    for leg, aliases in _LEG_ALIASES.items():
        if any(low.startswith(a + "_") or low.startswith(a) and
               low[len(a):len(a) + 1] in ("_", "") for a in aliases):
            return leg
    return None


def _part_from_name(name: str) -> Optional[str]:
    low = name.lower()
    for part, aliases in _PART_ALIASES.items():
        if any(a in low for a in aliases):
            return part
    return None


def _rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis rpy (extrinsic XYZ == intrinsic ZYX): R = Rz Ry Rx."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _vec(attr: Optional[str], n=3) -> np.ndarray:
    if not attr:
        return np.zeros(n)
    return np.asarray([float(x) for x in attr.split()], dtype=np.float64)


class _Inertial:
    """Mass, CoM and CoM-centered inertia expressed in the LINK frame."""

    __slots__ = ("mass", "com", "inertia")

    def __init__(self, mass=0.0, com=None, inertia=None):
        self.mass = float(mass)
        self.com = np.zeros(3) if com is None else np.asarray(com, np.float64)
        self.inertia = (
            np.zeros((3, 3)) if inertia is None
            else np.asarray(inertia, np.float64)
        )

    @classmethod
    def from_xml(cls, link: ET.Element) -> "_Inertial":
        el = link.find("inertial")
        if el is None:
            return cls()
        origin = el.find("origin")
        xyz = _vec(origin.get("xyz") if origin is not None else None)
        rpy = _vec(origin.get("rpy") if origin is not None else None)
        mass_el = el.find("mass")
        m = float(mass_el.get("value")) if mass_el is not None else 0.0
        I = np.zeros((3, 3))
        inel = el.find("inertia")
        if inel is not None:
            ixx = float(inel.get("ixx", 0)); iyy = float(inel.get("iyy", 0))
            izz = float(inel.get("izz", 0)); ixy = float(inel.get("ixy", 0))
            ixz = float(inel.get("ixz", 0)); iyz = float(inel.get("iyz", 0))
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        # rotate the CoM-centered inertia from the inertial frame into the
        # link frame: I_link = R I R^T
        R = _rpy_to_matrix(rpy)
        return cls(m, xyz, R @ I @ R.T)

    def lumped_with(self, other: "_Inertial", p: np.ndarray,
                    R: np.ndarray) -> "_Inertial":
        """Composite rigid body: fold `other` (expressed in a child frame at
        offset p, rotation R from this frame) into this link's frame."""
        m2 = other.mass
        if m2 == 0.0 and not np.any(other.inertia):
            return self
        com2 = p + R @ other.com            # child CoM in this frame
        m = self.mass + m2
        com = (self.mass * self.com + m2 * com2) / max(m, 1e-12)
        I2 = R @ other.inertia @ R.T

        def _shift(I, mass, d):
            # parallel axis: inertia about CoM -> about (CoM + d)
            return I + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        I = _shift(self.inertia, self.mass, self.com - com) + _shift(
            I2, m2, com2 - com)
        return _Inertial(m, com, I)


def _classify_by_structure(movable: List[dict], trunk: str):
    """Classify 12 movable joints into (leg, part) from the TREE alone:
    tree depth gives the part (trunk child = hip, hip child = thigh, thigh
    child = calf) and the hip-origin x/y sign relative to the trunk
    centroid gives the leg (x>centroid = Front, y>centroid = Left).

    ASSUMPTION (checked below): the trunk frame is x-forward / y-left —
    the universal quadruped-URDF convention (Unitree, ANYmal, ODRI). A
    base frame with another axis convention would mislabel legs, so we
    sanity-check the hip layout: quadruped bodies are longer than wide,
    hence the hip x-spread must exceed the y-spread; otherwise we raise
    rather than silently flipping front/left."""
    hips = [j for j in movable if j["anc_parent"] == trunk]
    if len(hips) != 4:
        raise ValueError(
            f"structure classification: expected 4 trunk-attached hip "
            f"joints, found {len(hips)}: {[j['name'] for j in hips]}")
    chains = []
    for h in hips:
        t = next((j for j in movable if j["anc_parent"] == h["child"]), None)
        c = (next((j for j in movable if j["anc_parent"] == t["child"]), None)
             if t is not None else None)
        if t is None or c is None:
            raise ValueError(
                f"structure classification: hip {h['name']} lacks a "
                "thigh->calf chain")
        chains.append((h, t, c))
    centroid = np.mean([ch[0]["xyz"][:2] for ch in chains], axis=0)
    hip_xy = np.array([ch[0]["xyz"][:2] for ch in chains])
    x_spread = hip_xy[:, 0].max() - hip_xy[:, 0].min()
    y_spread = hip_xy[:, 1].max() - hip_xy[:, 1].min()
    if x_spread <= y_spread:
        raise ValueError(
            "structure classification assumes an x-forward/y-left trunk "
            f"frame, but the hip x-spread ({x_spread:.3f} m) does not "
            f"exceed the y-spread ({y_spread:.3f} m) — the base frame "
            "likely uses a different axis convention (quadruped bodies "
            "are longer than wide). Re-export the URDF x-forward or use "
            "named joints (FL_/FR_/RL_/RR_ prefixes).")
    by_leg: Dict[str, Dict[str, dict]] = {}
    for ch in chains:
        x, y = ch[0]["xyz"][:2]
        leg = ("F" if x > centroid[0] else "R") + \
              ("L" if y > centroid[1] else "R")
        if leg in by_leg:
            raise ValueError(
                f"structure classification: two hips map to leg {leg} "
                "(degenerate hip-origin layout)")
        by_leg[leg] = dict(zip(_LEG_PARTS, ch))
    return by_leg


def _foot_sphere(link: ET.Element) -> Optional[float]:
    for col in link.findall("collision"):
        sph = col.find("geometry/sphere")
        if sph is not None:
            return float(sph.get("radius"))
    return None


def parse_urdf(
    path_or_xml: str,
    name: Optional[str] = None,
    q_home_joints=(0.0, 0.9, -1.8),
    base_height_home: Optional[float] = None,
    dtype=torch.float32,
    device=None,
) -> RobotSpec:
    """Parse a quadruped URDF into a RobotSpec.

    q_home_joints / base_height_home: the URDF format carries no nominal
    configuration; callers (robot catalog entries) supply theirs. When
    base_height_home is None it is set so the straight-leg FK puts the foot
    at -(thigh+calf) and is refined by the caller via foot FK. The
    tensors go to ``device``, by default the CUDA card.
    """
    if os.path.exists(path_or_xml):
        tree = ET.parse(path_or_xml)
        root = tree.getroot()
    else:
        root = ET.fromstring(path_or_xml)
    robot_name = name or root.get("name", "robot")

    links: Dict[str, ET.Element] = {
        l.get("name"): l for l in root.findall("link")
    }
    inertials = {n: _Inertial.from_xml(l) for n, l in links.items()}

    joints = []
    child_of: Dict[str, str] = {}
    for j in root.findall("joint"):
        jtype = j.get("type")
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        origin = j.find("origin")
        xyz = _vec(origin.get("xyz") if origin is not None else None)
        rpy = _vec(origin.get("rpy") if origin is not None else None)
        axis_el = j.find("axis")
        axis = (_vec(axis_el.get("xyz")) if axis_el is not None
                else np.array([1.0, 0, 0]))
        limit = j.find("limit")
        effort = float(limit.get("effort", "1e9")) if limit is not None else 1e9
        lo = float(limit.get("lower", "-1e9")) if limit is not None else -1e9
        hi = float(limit.get("upper", "1e9")) if limit is not None else 1e9
        joints.append(dict(name=j.get("name"), type=jtype, parent=parent,
                           child=child, xyz=xyz, rpy=rpy, axis=axis,
                           effort=effort, lo=lo, hi=hi))
        child_of[child] = parent

    # root link = never a child (skip a possible floating world attachment)
    roots = [n for n in links if n not in child_of]
    if len(roots) != 1:
        raise ValueError(f"expected a unique root link, got {roots}")
    trunk = roots[0]

    # ---- lump fixed subtrees into their movable parent -------------------
    # movable-frame map: link -> (movable ancestor link, offset, rotation)
    frame: Dict[str, Tuple[str, np.ndarray, np.ndarray]] = {
        trunk: (trunk, np.zeros(3), np.eye(3))
    }
    movable: List[dict] = []
    foot_info: Dict[str, Tuple[str, np.ndarray, Optional[float]]] = {}
    sphere_links: List[Tuple[str, np.ndarray, float]] = []

    # topological order: repeatedly resolve joints whose parent is mapped
    pending = list(joints)
    while pending:
        progressed = False
        for j in list(pending):
            if j["parent"] not in frame:
                continue
            pending.remove(j)
            progressed = True
            anc, p0, R0 = frame[j["parent"]]
            if j["type"] == "fixed":
                pj = p0 + R0 @ j["xyz"]
                Rj = R0 @ _rpy_to_matrix(j["rpy"])
                frame[j["child"]] = (anc, pj, Rj)
                # lump the fixed child's inertia into the movable ancestor
                inertials[anc] = inertials[anc].lumped_with(
                    inertials[j["child"]], pj, Rj)
                low = j["child"].lower()
                if low.endswith("_foot") or low.endswith("_foot_link"):
                    leg = _leg_from_name(j["child"]) or \
                        j["child"].split("_")[0].upper()
                    foot_info[leg] = (
                        anc, pj, _foot_sphere(links[j["child"]]))
                elif _foot_sphere(links[j["child"]]) is not None:
                    # unnamed sphere-collision fixed link: foot candidate
                    sphere_links.append(
                        (anc, pj, _foot_sphere(links[j["child"]])))
            elif j["type"] in ("revolute", "continuous"):
                # Residual-rotation folding: spec frames carry no static
                # rotation, so the accumulated pre-rotation C (fixed-chain
                # rotation R0 times this joint's origin rpy) is folded into
                # the joint axis — T(p).C.Rot(a,q) = T(p).Rot(Ca,q).C — and
                # C propagates into EVERYTHING expressed downstream: child
                # joint origins/axes (via frame), the child's own inertial,
                # lumped fixed-descendant inertials, and foot offsets.
                C = R0 @ _rpy_to_matrix(j["rpy"])
                a = np.asarray(j["axis"], np.float64)
                a = a / max(np.linalg.norm(a), 1e-12)
                movable.append(dict(j, xyz=p0 + R0 @ j["xyz"], axis=C @ a,
                                    anc_parent=anc))
                frame[j["child"]] = (j["child"], np.zeros(3), C)
                ine = inertials[j["child"]]
                inertials[j["child"]] = _Inertial(
                    ine.mass, C @ ine.com, C @ ine.inertia @ C.T)
            elif j["type"] == "floating":
                frame[j["child"]] = (j["child"], np.zeros(3), np.eye(3))
                if j["child"] in inertials and j["parent"] == trunk:
                    trunk = j["child"]
            else:
                raise ValueError(f"unsupported joint type {j['type']}")
        if not progressed:
            raise ValueError(
                f"unreachable joints (cyclic or disconnected): "
                f"{[j['name'] for j in pending]}")

    if len(movable) != 12:
        raise ValueError(
            f"expected 12 movable leg joints, found {len(movable)}: "
            f"{[j['name'] for j in movable]}")

    # ---- classify the 12 joints into (leg, part) --------------------------
    # name-based first (vendor aliases); if ANY joint fails, fall back to
    # full structure-based classification so the two schemes never mix
    by_leg: Dict[str, Dict[str, dict]] = {leg: {} for leg in FEET_ORDER}
    named_ok = True
    for j in movable:
        leg = _leg_from_name(j["name"])
        part = _part_from_name(j["name"])
        if leg is None or part is None or part in by_leg.get(leg, {}):
            named_ok = False
            break
        by_leg[leg][part] = j
    if not named_ok:
        by_leg = _classify_by_structure(movable, trunk)

    # ---- assemble the RobotSpec arrays ------------------------------------
    parent = [-1, 0, 1, 2, 3, 4]
    jtype = [PRISMATIC] * 3 + [REVOLUTE] * 3
    axis = [[1, 0, 0], [0, 1, 0], [0, 0, 1],
            [0, 0, 1], [0, 1, 0], [1, 0, 0]]
    pos = [[0.0, 0.0, 0.0]] * 6
    trunk_inertial = inertials[trunk]
    mass = [0.0] * 5 + [trunk_inertial.mass]
    com = [np.zeros(3)] * 5 + [trunk_inertial.com]
    inertia = [np.zeros((3, 3))] * 5 + [trunk_inertial.inertia]
    torque_limit, joint_limits, foot_body, foot_offset = [], [], [], []
    foot_radii = []

    for i_leg, leg in enumerate(FEET_ORDER):
        parts = by_leg[leg]
        if set(parts) != set(_LEG_PARTS):
            raise ValueError(f"leg {leg}: missing joints "
                             f"{set(_LEG_PARTS) - set(parts)}")
        for k, part in enumerate(_LEG_PARTS):
            j = parts[part]
            exp_parent = trunk if part == "hip" else parts[_LEG_PARTS[k - 1]]["child"]
            if j["anc_parent"] != exp_parent:
                raise ValueError(
                    f"joint {j['name']}: parent {j['anc_parent']} != "
                    f"expected {exp_parent} (trunk->hip->thigh->calf chain)")
            idx = len(parent)
            parent.append(5 if part == "hip" else idx - 1)
            jtype.append(REVOLUTE)
            axis.append(list(j["axis"]))
            pos.append(list(j["xyz"]))
            ine = inertials[j["child"]]
            mass.append(ine.mass)
            com.append(ine.com)
            inertia.append(ine.inertia)
            torque_limit.append(j["effort"])
            joint_limits.append([j["lo"], j["hi"]])
        calf_link = parts["calf"]["child"]
        if leg not in foot_info:
            # fallback: a sphere-collision fixed link on this calf. Picked
            # DETERMINISTICALLY when several exist (not declaration order):
            # the lowest-z offset (feet hang below the calf), radius as
            # tie-break — so vendor files with e.g. extra knee-guard
            # spheres resolve to the same foot regardless of joint order.
            cand = [s for s in sphere_links if s[0] == calf_link]
            if cand:
                cand.sort(key=lambda s: (float(s[1][2]),
                                         -(s[2] if s[2] is not None else 0.0)))
                foot_info[leg] = cand[0]
        if leg not in foot_info:
            raise ValueError(
                f"no {leg}_foot fixed link (nor a sphere-collision fixed "
                f"link on calf {calf_link}) found")
        anc, off, radius = foot_info[leg]
        if anc != calf_link:
            raise ValueError(
                f"{leg}_foot is attached to {anc}, expected calf {calf_link}")
        foot_body.append(len(parent) - 1)
        foot_offset.append(off)
        foot_radii.append(radius if radius is not None else 0.022)

    nvt = len(parent)
    q_home = np.zeros(nvt)
    for i_leg, leg in enumerate(FEET_ORDER):
        q_home[6 + 3 * i_leg: 9 + 3 * i_leg] = q_home_joints
        if leg in ("FR", "RR"):
            q_home[6 + 3 * i_leg] *= -1.0
    # URDF carries no nominal configuration; 0.30 m is the Go2-class default,
    # catalog entries pass their own (robots/go2.py, robots/solo12.py)
    q_home[2] = 0.30 if base_height_home is None else base_height_home

    radius = float(np.mean(foot_radii))
    npd = np.dtype(str(dtype).replace("torch.", ""))
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=npd), device=dev)
    return RobotSpec(
        name=robot_name,
        nv=nvt,
        nu=nvt - 6,
        parent=tuple(parent),
        jtype=tuple(jtype),
        foot_body=tuple(foot_body),
        feet_frame_names=tuple(f"{leg}_foot" for leg in FEET_ORDER),
        joint_axis=t(axis),
        joint_pos=t(pos),
        mass=t(mass),
        com=t(np.stack(com)),
        inertia=t(np.stack(inertia)),
        foot_offset=t(np.stack(foot_offset)),
        foot_radius=t(radius),
        torque_limit=t(torque_limit),
        q_home=t(q_home),
        joint_limits=t(joint_limits),
    )


# ---------------------------------------------------------------------------
def spec_to_urdf(spec: RobotSpec) -> str:
    """Export a RobotSpec as URDF text."""
    import io

    f64 = lambda x: x.detach().cpu().numpy().astype(np.float64)
    jp, ax, ms, cm = f64(spec.joint_pos), f64(spec.joint_axis), f64(spec.mass), f64(spec.com)
    In, fo = f64(spec.inertia), f64(spec.foot_offset)
    tl, jl = f64(spec.torque_limit), f64(spec.joint_limits)
    r = float(f64(spec.foot_radius))

    def v3(x):
        return f"{x[0]:.9g} {x[1]:.9g} {x[2]:.9g}"

    def inertial(b):
        I = In[b]
        return (
            f'    <inertial>\n'
            f'      <origin xyz="{v3(cm[b])}" rpy="0 0 0"/>\n'
            f'      <mass value="{ms[b]:.9g}"/>\n'
            f'      <inertia ixx="{I[0,0]:.9g}" ixy="{I[0,1]:.9g}" '
            f'ixz="{I[0,2]:.9g}" iyy="{I[1,1]:.9g}" iyz="{I[1,2]:.9g}" '
            f'izz="{I[2,2]:.9g}"/>\n'
            f'    </inertial>\n'
        )

    out = io.StringIO()
    out.write(f'<robot name="{spec.name}">\n')
    out.write('  <link name="trunk">\n' + inertial(5) + '  </link>\n')
    names = []
    for i_leg, leg in enumerate(FEET_ORDER):
        l = leg.lower()
        for k, part in enumerate(_LEG_PARTS):
            b = 6 + 3 * i_leg + k
            link = f"{l}_{part}"
            names.append(link)
            out.write(f'  <link name="{link}">\n' + inertial(b) + '  </link>\n')
            parent = "trunk" if k == 0 else f"{l}_{_LEG_PARTS[k-1]}"
            u = 3 * i_leg + k
            out.write(
                f'  <joint name="{l}_{part}_joint" type="revolute">\n'
                f'    <parent link="{parent}"/>\n'
                f'    <child link="{link}"/>\n'
                f'    <origin xyz="{v3(jp[b])}" rpy="0 0 0"/>\n'
                f'    <axis xyz="{v3(ax[b])}"/>\n'
                f'    <limit effort="{tl[u]:.9g}" velocity="30" '
                f'lower="{jl[u,0]:.9g}" upper="{jl[u,1]:.9g}"/>\n'
                f'  </joint>\n'
            )
        out.write(
            f'  <link name="{l}_foot">\n'
            f'    <collision>\n'
            f'      <geometry><sphere radius="{r:.9g}"/></geometry>\n'
            f'    </collision>\n'
            f'  </link>\n'
            f'  <joint name="{l}_foot_joint" type="fixed">\n'
            f'    <parent link="{l}_calf"/>\n'
            f'    <child link="{l}_foot"/>\n'
            f'    <origin xyz="{v3(fo[i_leg])}" rpy="0 0 0"/>\n'
            f'  </joint>\n'
        )
    out.write('</robot>\n')
    return out.getvalue()
