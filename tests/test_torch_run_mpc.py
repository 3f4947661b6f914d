"""The controller's host-side rest in the port against the JAX package, on
the CPU: the teleop (``utils/interactive.SetVelocityGoal``), the
``LocomotionMPC(interactive_goal=True)`` reads, ``plot_traj`` and the MPC
CLI (``examples/run_mpc.py --mode traj_opt --device cpu``, a subprocess).

``plot_traj`` is the JAX method called on the port's controller and the
port's on the same logs: the same panels, titles and lines for each
variable, and the same error for an unknown name and for empty logs. No
JAX compile; ~14 s of worker time (the CLI's cold boot and first solve on
the CPU take ~9 s of it).
"""
import os
import re
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402,F401

from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC as JaxMPC  # noqa: E402
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2  # noqa: E402
from iterative_learning_nmpc_tpu.utils import interactive as jint  # noqa: E402
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC  # noqa: E402
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec  # noqa: E402
from iterative_learning_nmpc_tpu_torch.utils import interactive as tint  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = "wwwwwwwwwwwwaadqqqqqqqqqqqqqqess sssssssssssssddddddddddeeeeeeeeeeeeeeeeex"


def test_set_velocity_goal_keys_match_jax():
    a, b = jint.SetVelocityGoal(use_stdin=False), tint.SetVelocityGoal(use_stdin=False)
    for key in KEYS:
        a._apply_key(key)
        b._apply_key(key)
        va, wa = a.get_velocity()
        vb, wb = b.get_velocity()
        np.testing.assert_array_equal(va, vb)
        assert wa == wb
    assert np.abs(vb).max() > 0.0 or wb != 0.0
    a.set_velocity([0.1, -0.2, 0.0], 0.3)
    b.set_velocity([0.1, -0.2, 0.0], 0.3)
    np.testing.assert_array_equal(a.get_velocity()[0], b.get_velocity()[0])
    a.stop()
    b.stop()


@pytest.fixture(scope="module")
def controllers():
    port = LocomotionMPC(go2_spec(device="cpu"), solve_async=False, interactive_goal=True,
                         device="cpu")
    ref = JaxMPC(jax_go2(), solve_async=False, interactive_goal=True)
    yield port, ref
    port.close()


def test_interactive_goal_base_reference_matches_jax(controllers):
    """With the teleop on, the terminal reference follows the measured base
    (the JAX controller's mpc/controller.py:263-266)."""
    port, ref = controllers
    assert port.velocity_goal is not None and ref.velocity_goal is not None
    q = np.asarray(jax_go2().q_home, np.float64).copy()
    q[:4] += [0.123, -0.045, 0.01, 0.3]
    for mpc in (port, ref):
        mpc.velocity_goal.set_velocity([0.25, 0.05, 0.0], 0.2)
        mpc.v_des, mpc.w_des[2] = mpc.velocity_goal.get_velocity()
        mpc.base_ref_vel_tracking[:] = 0.0
        mpc.base_ref_vel_tracking[:4] = [1.0, 2.0, 0.3, -0.5]
    a = port.compute_base_ref_vel_tracking(q)
    b = ref.compute_base_ref_vel_tracking(q)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    # the terminal xy and yaw follow the measured base, not the integrated
    # command
    goal, port.velocity_goal = port.velocity_goal, None
    try:
        c = port.compute_base_ref_vel_tracking(q)
    finally:
        port.velocity_goal = goal
    np.testing.assert_allclose(a[1][:2] - c[1][:2], np.round(q[:2], 2) - [1.0, 2.0], atol=1e-12)
    assert abs((a[1][3] - c[1][3]) - (q[3] + 0.5)) < 1e-12


def fill_logs(mpc, n=30):
    rng = np.random.default_rng(0)
    mpc.q_full = list(rng.normal(size=(n, 18)))
    mpc.v_full = list(rng.normal(size=(n, 18)))
    mpc.tau_full = list(rng.normal(size=(n, 12)))
    mpc.q_plan_full = list(rng.normal(size=(n, 18)))
    mpc.v_plan_full = list(rng.normal(size=(n, 18)))
    mpc.a_plan_full = list(rng.normal(size=(n, 18)))
    mpc.f_plan_full = list(rng.normal(size=(n, 4, 3)))
    mpc.tau_plan_full = list(rng.normal(size=(n, 12)))
    mpc.dt_plan_full = list(rng.uniform(0.02, 0.03, n))


def panels(fig):
    return [(ax.get_title(), [tuple(ln.get_ydata()[:3]) for ln in ax.get_lines()])
            for ax in fig.axes]


@pytest.mark.parametrize("var", ["q", "v", "tau", "a", "f", "dt"])
def test_plot_traj_matches_jax(controllers, var, tmp_path, monkeypatch):
    """The figures' panels; the layout pass (0.6 s a figure here) is counted,
    not run, and only the one-panel figure is written to a file."""
    import matplotlib.pyplot as plt
    from matplotlib.figure import Figure

    layouts = []
    monkeypatch.setattr(Figure, "tight_layout", lambda self, *a, **k: layouts.append(self))
    port = controllers[0]
    fill_logs(port)
    path = str(tmp_path / f"{var}.png") if var == "dt" else None
    ours = port.plot_traj(var, save_path=path)
    theirs = JaxMPC.plot_traj(port, var)
    assert panels(ours) == panels(theirs) and layouts == [ours, theirs]
    assert len(ours.axes) == {"q": 18, "v": 18, "tau": 12, "a": 18, "f": 12, "dt": 1}[var]
    if path:
        assert os.path.getsize(path) > 0
    plt.close("all")


def test_plot_traj_errors_match_jax(controllers):
    port = controllers[0]
    fill_logs(port)
    for var in ("nope", "tau_ff"):
        with pytest.raises(ValueError) as ours:
            port.plot_traj(var)
        with pytest.raises(ValueError) as theirs:
            JaxMPC.plot_traj(port, var)
        assert str(ours.value) == str(theirs.value)
    port.q_full, port.q_plan_full = [], []
    with pytest.raises(ValueError) as ours:
        port.plot_traj("q")
    with pytest.raises(ValueError) as theirs:
        JaxMPC.plot_traj(port, "q")
    assert str(ours.value) == str(theirs.value)


def test_run_mpc_traj_opt_cli():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "iterative_learning_nmpc_tpu_torch.examples.run_mpc",
                        "--mode", "traj_opt", "--device", "cpu", "--vx", "0.3"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "plan shapes: (1000, 18) (1000, 18) (1000, 4, 3)" in out
    lo, hi = (float(x) for x in re.search(r"base z range: ([\d.]+) ([\d.]+)", out).groups())
    assert 0.2 < lo <= hi < 0.4
    assert 0.0 < float(re.search(r"\|tau_ff\| max: ([\d.]+)", out).group(1)) < 40.0
    # CPU tensors take the kernels' plain twins: no kernel launched
    assert "launches: dyncore 0, lingram 0, riccati_rollout 0, dynjac 0, policy_pd 0" in out
