"""Scene-overlay rendering (the mj_pin VisualCallback role).

Counterpart of ``iterative_learning_nmpc_tpu/sim/visual.py``, with the same
markers. Re-implements the reference's in-scene debug markers
(`Behavior_Cloning/utils/Rollout_MPC.py:74-128` — planned contact points,
running/terminal base-reference boxes, applied-force capsule;
`DAgger/utils/Rollout_combined_controller.py:28-58` — expert/learner mode
color) on top of `mujoco.Renderer`: callbacks append mjvGeom markers to the
mjvScene after `update_scene`, so they appear in recorded video frames.

Works headless: marker injection only needs an MjvScene, not a GL context —
tests exercise the geometry math directly on a scene object. ``mujoco`` is
imported where a marker is added, so the module imports without it.
"""
from __future__ import annotations


import numpy as np


class VisualCallback:
    """Base overlay: subclass and implement `render(scene, mj_data)` using
    the add_* helpers. Attach via `Simulator.run(visual_callback=...)`."""

    def render(self, scene, mj_data) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    # ---------------- marker helpers ----------------
    @staticmethod
    def _add_geom(scene, geom_type, size, pos, mat, rgba):
        import mujoco

        if scene.ngeom >= scene.maxgeom:
            return
        g = scene.geoms[scene.ngeom]
        mujoco.mjv_initGeom(
            g, geom_type,
            np.asarray(size, np.float64),
            np.asarray(pos, np.float64),
            np.asarray(mat, np.float64).reshape(9),
            np.asarray(rgba, np.float32),
        )
        scene.ngeom += 1

    def add_sphere(self, scene, pos, radius, rgba):
        import mujoco

        self._add_geom(scene, mujoco.mjtGeom.mjGEOM_SPHERE,
                       [radius, 0, 0], pos, np.eye(3), rgba)

    def add_box(self, scene, pos, half_extents, rgba):
        import mujoco

        self._add_geom(scene, mujoco.mjtGeom.mjGEOM_BOX,
                       half_extents, pos, np.eye(3), rgba)

    def add_arrow(self, scene, start, vec, radius, rgba):
        """Capsule from `start` along `vec` (the reference's applied-force
        capsule, `Rollout_MPC.py:104-118`)."""
        import mujoco

        length = float(np.linalg.norm(vec))
        if length < 1e-9:
            return
        d = np.asarray(vec) / length
        # rotation taking +z to d
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(z, d)
        c = float(np.dot(z, d))
        if np.linalg.norm(v) < 1e-9:
            R = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
            R = np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))
        mid = np.asarray(start) + 0.5 * length * d
        self._add_geom(scene, mujoco.mjtGeom.mjGEOM_CAPSULE,
                       [radius, 0.5 * length, 0], mid, R, rgba)


class MPCVisualCallback(VisualCallback):
    """Overlay for a LocomotionMPC (optionally wrapped by a
    CombinedController): planned contact points, base-reference boxes, the
    scheduled external force, and the expert/learner mode color."""

    RGBA_CONTACT = (0.1, 0.9, 0.1, 0.6)
    RGBA_REF = (0.9, 0.6, 0.1, 0.35)
    RGBA_REF_E = (0.9, 0.1, 0.1, 0.35)
    RGBA_FORCE = (0.9, 0.1, 0.9, 0.8)
    RGBA_EXPERT = (1.0, 0.2, 0.2, 0.9)    # MPC active (reference :46-58)
    RGBA_LEARNER = (0.2, 0.4, 1.0, 0.9)   # policy active

    def __init__(self, mpc, combined=None, trunk_body: int = 1,
                 force_scale: float = 0.005):
        """trunk_body: MuJoCo body id of the trunk (Simulator.trunk_body)."""
        self.mpc = mpc
        self.combined = combined
        self.trunk_body = trunk_body
        self.force_scale = force_scale

    def render(self, scene, mj_data) -> None:
        # planned contact locations (first horizon node with a location)
        cnt_loc = getattr(self.mpc, "_last_cnt_loc", None)
        if cnt_loc is not None:
            for foot in range(cnt_loc.shape[0]):
                provided = np.any(cnt_loc[foot] != 0.0, axis=-1)
                if provided.any():
                    k = int(np.argmax(provided))
                    self.add_sphere(scene, cnt_loc[foot, k], 0.02,
                                    self.RGBA_CONTACT)

        # running / terminal base reference boxes (reference :84-103)
        ref = getattr(self.mpc, "_last_base_ref", None)
        ref_e = getattr(self.mpc, "_last_base_ref_e", None)
        if ref is not None and np.any(ref[:3] != 0.0):
            self.add_box(scene, ref[:3], [0.06, 0.04, 0.02], self.RGBA_REF)
        if ref_e is not None and np.any(ref_e[:3] != 0.0):
            self.add_box(scene, ref_e[:3], [0.06, 0.04, 0.02], self.RGBA_REF_E)

        # applied external wrench on the trunk (force capsule)
        f = np.asarray(mj_data.xfrc_applied[self.trunk_body][:3])
        if np.linalg.norm(f) > 1e-6:
            base = np.asarray(mj_data.qpos[:3])
            self.add_arrow(scene, base, f * self.force_scale, 0.01,
                           self.RGBA_FORCE)

        # expert/learner mode indicator above the trunk
        if self.combined is not None:
            rgba = (self.RGBA_EXPERT if getattr(self.combined, "mpc_active",
                                                False)
                    else self.RGBA_LEARNER)
            pos = np.asarray(mj_data.qpos[:3]) + np.array([0.0, 0.0, 0.15])
            self.add_sphere(scene, pos, 0.03, rgba)
