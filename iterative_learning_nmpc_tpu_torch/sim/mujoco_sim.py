"""The host MuJoCo plant: headless 1 kHz stepping, the controller
callback, data recording, scheduled trunk wrenches (fault injection),
collision-based fall detection with an allowed-collision list, and
early-termination reporting.

Counterpart of ``iterative_learning_nmpc_tpu/sim/mujoco_sim.py``: the same
model (``robots/mjcf``) and the same MuJoCo calls in the same order, so the
same state steps to the same state. The simulator is host numpy and
MuJoCo; what it calls each step is the controller's
``compute_torques_dof(data)``, which runs wherever the controller runs
(the port's controllers on the CUDA card by default). ``mujoco`` is
imported only where a ``Simulator`` is built: without it that raises
``ImportError``, and the rest of the port imports all the same.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..robots.mjcf import make_mj_model
from ..robots.spec import RobotSpec


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclass
class ForceWindow:
    """A wrench applied to the trunk during [start, end) seconds
    (reference force schedules, `RolloutMPC_force_at_interval.py:384-390`)."""

    start: float
    end: float
    force: np.ndarray  # (3,) or (6,) world-frame force (+ optional torque)


class DataRecorder:
    """Base recorder protocol (mj_pin DataRecorder equivalent)."""

    def __init__(self, record_dir: str = "", record_step: int = 1):
        self.record_dir = record_dir
        self.record_step = record_step

    def reset(self) -> None:  # pragma: no cover - interface
        pass

    def record(self, mj_data) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def save(self) -> str:  # pragma: no cover - interface
        return ""


@dataclass
class SimResult:
    sim_time: float
    fell: bool
    diverged: bool
    n_steps: int
    termination: str = ""


class Simulator:
    """Headless MuJoCo simulator bound to a RobotSpec-generated model."""

    def __init__(
        self,
        spec: RobotSpec,
        sim_dt: float = 1.0e-3,
        friction: float = 0.8,
        joint_damping: float = 0.0,
    ):
        import mujoco

        self._mj = mujoco
        self.spec = spec
        self.sim_dt = sim_dt
        self.model = make_mj_model(
            spec, timestep=sim_dt, friction=friction, joint_damping=joint_damping
        )
        self.data = mujoco.MjData(self.model)
        self.trunk_body = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, "trunk")
        self.floor_geom = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_GEOM, "floor")
        self.foot_geoms = {
            mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_GEOM, f"{leg}_foot"): leg
            for leg in ("FL", "FR", "RL", "RR")
        }
        self.reset()

    # ------------------------------------------------------------------
    def reset(self, q_mj: Optional[np.ndarray] = None, v_mj: Optional[np.ndarray] = None):
        mujoco = self._mj
        mujoco.mj_resetData(self.model, self.data)
        if q_mj is None:
            mujoco.mj_resetDataKeyframe(self.model, self.data, 0)
            # settle: drop the home keyframe so feet touch the floor
            self.data.qpos[2] += self._drop_height_offset()
        else:
            self.data.qpos[:] = q_mj
        if v_mj is not None:
            self.data.qvel[:] = v_mj
        mujoco.mj_forward(self.model, self.data)

    def _drop_height_offset(self) -> float:
        """Vertical offset putting the lowest foot sphere exactly on the floor."""
        self._mj.mj_forward(self.model, self.data)
        foot_r = float(_host(self.spec.foot_radius))
        lowest = min(
            self.data.geom_xpos[gid][2] for gid in self.foot_geoms
        )
        return -(lowest - foot_r)

    def set_state(self, q_mj: np.ndarray, v_mj: np.ndarray):
        self.data.qpos[:] = q_mj
        self.data.qvel[:] = v_mj
        self._mj.mj_forward(self.model, self.data)

    def step(self) -> None:
        """One ``mj_step`` with ``data.ctrl`` and ``data.xfrc_applied`` as
        they are set: the plant step that ``run`` and
        ``learning/plant_batch`` share."""
        self._mj.mj_step(self.model, self.data)

    # ------------------------------------------------------------------
    def feet_in_contact(self) -> List[str]:
        """Feet currently touching the floor (reference contact detection,
        `Rollout_MPC.py:48-71`)."""
        feet = []
        for i in range(self.data.ncon):
            con = self.data.contact[i]
            g1, g2 = con.geom1, con.geom2
            if g1 == self.floor_geom and g2 in self.foot_geoms:
                feet.append(self.foot_geoms[g2])
            elif g2 == self.floor_geom and g1 in self.foot_geoms:
                feet.append(self.foot_geoms[g1])
        return feet

    def _bad_collision(self) -> bool:
        """Any floor contact by a non-foot geom = fall (mirrors
        allowed_collision=["FL","FR","RL","RR","floor"], `Rollout_MPC.py:493`)."""
        for i in range(self.data.ncon):
            con = self.data.contact[i]
            g1, g2 = con.geom1, con.geom2
            if g1 == self.floor_geom and g2 not in self.foot_geoms:
                return True
            if g2 == self.floor_geom and g1 not in self.foot_geoms:
                return True
        return False

    # ------------------------------------------------------------------
    def run(
        self,
        sim_time: float,
        controller,
        data_recorder: Optional[DataRecorder] = None,
        force_schedule: Optional[Sequence[ForceWindow]] = None,
        record_step: int = 1,
        real_time: bool = False,
        max_torque_clip: bool = True,
        stop_on_fall: bool = True,
        video_path: Optional[str] = None,
        video_fps: int = 25,
        visual_callback=None,
    ) -> SimResult:
        """Step the plant at sim_dt, querying the controller every step.

        video_path: optional .npz (frame stack) / .gif output rendered with
        mujoco.Renderer at video_fps (skipped with a warning when no
        offscreen GL context is available — headless images).
        visual_callback: an object whose ``render(scene, data)`` appends
        scene overlay markers to each rendered frame (the JAX package's
        ``sim.visual.VisualCallback``); passed through as given.
        """
        mujoco = self._mj
        renderer, frames, frame_every = None, [], 0
        if video_path is not None:
            try:
                renderer = mujoco.Renderer(self.model, height=240, width=320)
                frame_every = max(int(round(1.0 / (video_fps * self.sim_dt))), 1)
            except Exception as e:  # no EGL/OSMesa in headless images
                print(f"[sim] video disabled (no offscreen GL): {e}")
                renderer = None
        n_steps = int(round(sim_time / self.sim_dt))
        tl = _host(self.spec.torque_limit)
        fell = False
        termination = ""
        step = 0
        for step in range(n_steps):
            t = self.data.time
            # scheduled wrenches on the trunk
            self.data.xfrc_applied[self.trunk_body][:] = 0.0
            if force_schedule:
                for fw in force_schedule:
                    if fw.start <= t < fw.end:
                        f = np.zeros(6)
                        f[: len(fw.force)] = fw.force
                        self.data.xfrc_applied[self.trunk_body][:] += f

            controller.compute_torques_dof(self.data)
            tau = np.asarray(controller.torques_dof)[-self.spec.nu:]
            if max_torque_clip:
                tau = np.clip(tau, -tl, tl)
            self.data.ctrl[:] = tau

            if data_recorder is not None and step % record_step == 0:
                data_recorder.record(self.data)

            self.step()

            if renderer is not None and step % frame_every == 0:
                renderer.update_scene(self.data)
                if visual_callback is not None:
                    scene = getattr(renderer, "scene", None)
                    if scene is not None:
                        visual_callback.render(scene, self.data)
                frames.append(renderer.render().copy())

            if stop_on_fall and self._bad_collision():
                fell = True
                termination = "collision"
                break
            if getattr(controller, "diverged", False):
                termination = "solver_diverged"
                break
            if real_time:
                time.sleep(self.sim_dt)

        if renderer is not None and frames:
            self._write_video(video_path, frames, video_fps)

        return SimResult(
            sim_time=self.data.time,
            fell=fell,
            diverged=getattr(controller, "diverged", False),
            n_steps=step + 1,
            termination=termination,
        )

    @staticmethod
    def _write_video(path: str, frames, fps: int):
        import numpy as _np

        if path.endswith(".gif"):
            from matplotlib import animation
            import matplotlib

            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt

            fig = plt.figure(figsize=(frames[0].shape[1] / 100, frames[0].shape[0] / 100))
            ax = fig.add_axes([0, 0, 1, 1])
            ax.axis("off")
            im = ax.imshow(frames[0])
            anim = animation.FuncAnimation(
                fig, lambda i: im.set_data(frames[i]), frames=len(frames)
            )
            anim.save(path, writer=animation.PillowWriter(fps=fps))
            plt.close(fig)
        else:
            _np.savez_compressed(path, frames=_np.stack(frames), fps=fps)
