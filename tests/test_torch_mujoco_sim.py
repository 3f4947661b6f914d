"""The port's host MuJoCo plant (``robots/mjcf.py``, ``sim/mujoco_sim.py``)
against the JAX package's, on the CPU.

The MJCF text of Go2, Solo12 and both URDF-ingested specs
(``assets/go2.urdf``, ``assets/solo12.urdf``) equals the JAX package's
character for character; ``reset``'s drop offset, a 200-step passive roll,
a roll under a ``ForceWindow`` and a passive collapse (``feet_in_contact``,
``_bad_collision``, ``SimResult``) are bit-equal to the JAX ``Simulator``:
the same model and state give the same MuJoCo steps. The video path is
taken, or skipped with the same message, as the JAX simulator's. And the
port imports without MuJoCo or matplotlib: only building a ``Simulator``
raises. No JAX compile; ~11 s of worker time (two subprocesses).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's modules import it)

from iterative_learning_nmpc_tpu.robots import go2 as jgo2
from iterative_learning_nmpc_tpu.robots import mjcf as jmjcf
from iterative_learning_nmpc_tpu.robots import solo12 as jsolo12
from iterative_learning_nmpc_tpu.sim import mujoco_sim as jsim
from iterative_learning_nmpc_tpu_torch.robots import go2 as tgo2
from iterative_learning_nmpc_tpu_torch.robots import mjcf as tmjcf
from iterative_learning_nmpc_tpu_torch.robots import solo12 as tsolo12
from iterative_learning_nmpc_tpu_torch.sim import mujoco_sim as tsim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
SPECS = {
    "go2": (jgo2.go2_spec, tgo2.go2_spec, None),
    "solo12": (jsolo12.solo12_spec, tsolo12.solo12_spec, None),
    "go2_urdf": (jgo2.go2_spec, tgo2.go2_spec, os.path.join(ASSETS, "go2.urdf")),
    "solo12_urdf": (jsolo12.solo12_spec, tsolo12.solo12_spec, os.path.join(ASSETS, "solo12.urdf")),
}


def specs(name):
    jf, tf, urdf = SPECS[name]
    return jf(urdf_path=urdf), tf(urdf_path=urdf, device="cpu")


class Zero:
    """A controller that applies no torque."""

    diverged = False

    def __init__(self, nv=18):
        self.torques_dof = np.zeros(nv)

    def compute_torques_dof(self, data):
        pass


@pytest.mark.parametrize("name", sorted(SPECS))
def test_mjcf_text_equals_jax(name):
    js, ts = specs(name)
    for kw in ({}, dict(with_floor=False, timestep=2e-3, friction=0.6),
               dict(armature=0.01, joint_damping=0.1)):
        assert tmjcf.mjcf_from_spec(ts, **kw) == jmjcf.mjcf_from_spec(js, **kw), (name, kw)
    assert tmjcf.joint_names(ts) == jmjcf.joint_names(js)


@pytest.mark.parametrize("name", ("go2", "solo12"))
def test_reset_and_rolls_bit_equal(name):
    js, ts = specs(name)
    a, b = jsim.Simulator(js), tsim.Simulator(ts)
    assert a.foot_geoms == b.foot_geoms and a.trunk_body == b.trunk_body
    assert a.floor_geom == b.floor_geom
    assert a._drop_height_offset() == b._drop_height_offset()
    np.testing.assert_array_equal(a.data.qpos, b.data.qpos)
    # a passive roll, then a roll under a push, from a perturbed state
    for pushes in (None, [tsim.ForceWindow(0.05, 0.15, np.array([30.0, -10.0, 5.0, 0.0, 1.0, 0.0]))]):
        q0 = a.data.qpos.copy()
        q0[7:] += np.random.default_rng(3).normal(0, 0.05, 12)
        v0 = np.random.default_rng(4).normal(0, 0.1, 18)
        a.reset(q0, v0)
        b.reset(q0, v0)
        ra = a.run(0.2, Zero(), stop_on_fall=False, force_schedule=pushes and [
            jsim.ForceWindow(p.start, p.end, p.force) for p in pushes])
        rb = b.run(0.2, Zero(), stop_on_fall=False, force_schedule=pushes)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb), (ra, rb)
        assert rb.n_steps == 200
        np.testing.assert_array_equal(a.data.qpos, b.data.qpos)
        np.testing.assert_array_equal(a.data.qvel, b.data.qvel)
        assert a.feet_in_contact() == b.feet_in_contact()


def test_collapse_contacts_and_result_equal_jax():
    """Without torque the robot collapses until the trunk touches the floor:
    the same contacts each step and the same SimResult."""
    js, ts = specs("go2")
    a, b = jsim.Simulator(js), tsim.Simulator(ts)

    class Watch(Zero):
        def __init__(self, sim):
            super().__init__()
            self.sim, self.log = sim, []

        def compute_torques_dof(self, data):
            self.log.append((tuple(self.sim.feet_in_contact()), self.sim._bad_collision()))

    wa, wb = Watch(a), Watch(b)
    ra, rb = a.run(2.0, wa), b.run(2.0, wb)
    assert rb.fell and rb.termination == "collision" and rb.n_steps < 2000
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb) and wa.log == wb.log
    assert any(len(f) == 4 for f, _ in wb.log)
    b.set_state(a.data.qpos, a.data.qvel)
    assert b._bad_collision() == a._bad_collision()


def test_video_path_as_jax(tmp_path):
    """The video path under the offscreen EGL backend: the port's frames are
    the JAX simulator's. A subprocess, since MuJoCo reads MUJOCO_GL once
    and, without a backend, aborts the process."""
    code = f"""
import contextlib, io, os
import numpy as np
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jgo2
from iterative_learning_nmpc_tpu.sim import mujoco_sim as jsim
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as tgo2
from iterative_learning_nmpc_tpu_torch.sim import mujoco_sim as tsim

class Zero:
    diverged = False
    torques_dof = np.zeros(18)
    def compute_torques_dof(self, data):
        pass

for tag, sim in (("jax", jsim.Simulator(jgo2())), ("port", tsim.Simulator(tgo2(device="cpu")))):
    path = os.path.join({str(tmp_path)!r}, tag + ".npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sim.run(0.05, Zero(), video_path=path, video_fps=100)
    frames = np.load(path)["frames"] if os.path.exists(path) else np.zeros(0)
    print(tag, frames.shape, int(frames.astype(np.int64).sum()), buf.getvalue().split(":")[0])
"""
    env = dict(os.environ, PYTHONPATH=ROOT, MUJOCO_GL="egl", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=120)
    lines = [ln.strip().split(" ", 1) for ln in r.stdout.strip().splitlines()[-2:]]
    assert r.returncode == 0 and [t for t, _ in lines] == ["jax", "port"], r.stderr[-2000:]
    assert lines[0][1] == lines[1][1] and lines[0][1].startswith("(5, 240, 320, 3)"), lines


def test_video_skipped_without_gl(tmp_path, monkeypatch, capsys):
    """Without an offscreen GL context (``mujoco.Renderer`` raising) both
    simulators skip the video with the same message and write nothing."""
    import mujoco

    def no_gl(*a, **k):
        raise RuntimeError("no offscreen context")

    monkeypatch.setattr(mujoco, "Renderer", no_gl)
    js, ts = specs("go2")
    out = {}
    for tag, sim in (("jax", jsim.Simulator(js)), ("port", tsim.Simulator(ts))):
        path = str(tmp_path / f"{tag}.npz")
        res = sim.run(0.02, Zero(), video_path=path)
        out[tag] = (os.path.exists(path), capsys.readouterr().out, res.n_steps)
    assert out["jax"] == out["port"] and "video disabled" in out["port"][1], out


def test_port_imports_without_mujoco_and_matplotlib():
    """mujoco and matplotlib blocked: every module of the slice imports, the
    controllers and helpers build; Simulator and plot_traj raise ImportError."""
    code = """
import sys
sys.modules["mujoco"] = None
sys.modules["matplotlib"] = None
import numpy as np
from iterative_learning_nmpc_tpu_torch.robots import mjcf
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.sim import mujoco_sim
from iterative_learning_nmpc_tpu_torch.learning import (
    combined_controller, policy_controller, recorder, rollouts)
from iterative_learning_nmpc_tpu_torch.utils import interactive
from iterative_learning_nmpc_tpu_torch.examples import run_mpc, run_policy
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
spec = go2_spec(device="cpu")
assert mjcf.mjcf_from_spec(spec).startswith("<mujoco")
w = mujoco_sim.ForceWindow(0.0, 1.0, np.zeros(3))
assert rollouts.early_termination(mujoco_sim.SimResult(1.0, False, False, 1000), 1.0) is False
mpc = LocomotionMPC(spec, solve_async=False, device="cpu")
for fn in (lambda: mujoco_sim.Simulator(spec), lambda: mpc.plot_traj("q")):
    try:
        fn()
    except ImportError:
        pass
    else:
        raise SystemExit("no ImportError")
mpc.close()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]
