"""The port's closed-loop dynamics and device plant against the JAX package:
``mass_matrix``, ``bias_forces``, ``forward_dynamics``, ``id_torques`` and
``com_position`` (models/dynamics.py), the contact parameters and
``pd_rollout`` over 200 steps with a base push (sim/jax_sim.py), and the
entry points' default device.
"""
import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.sim import jax_sim
from iterative_learning_nmpc_tpu_torch import flagship as tflag
from iterative_learning_nmpc_tpu_torch import interop
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn
from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.sim import device_sim
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver

M, T = 16, 200
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def specs():
    return jax_go2(), torch_go2(device="cpu")


@pytest.fixture(scope="module")
def states(specs):
    rng = np.random.default_rng(3)
    q = (np.asarray(specs[0].q_home)[None] + 0.3 * rng.standard_normal((M, 18))).astype(np.float32)
    v = rng.standard_normal((M, 18)).astype(np.float32)
    a = (3.0 * rng.standard_normal((M, 18))).astype(np.float32)
    f = (30.0 * rng.standard_normal((M, 4, 3))).astype(np.float32)
    tau = (5.0 * rng.standard_normal((M, 12))).astype(np.float32)
    return q, v, a, f, tau


@pytest.mark.parametrize("fn", ["mass_matrix", "bias_forces", "forward_dynamics",
                                "id_torques", "com_position"])
def test_dynamics_match_jax(specs, states, fn):
    js, ts = specs
    q, v, a, f, tau = states
    jf = {"mass_matrix": lambda q, v, a, f, t: jdyn.mass_matrix(js, q),
          "bias_forces": lambda q, v, a, f, t: jdyn.bias_forces(js, q, v),
          "forward_dynamics": lambda q, v, a, f, t: jdyn.forward_dynamics(js, q, v, t, f),
          "id_torques": lambda q, v, a, f, t: jdyn.id_torques(js, q, v, a, f),
          "com_position": lambda q, v, a, f, t: jdyn.com_position(js, q)}[fn]
    ref = np.asarray(jax.jit(jax.vmap(jf))(q, v, a, f, tau))
    q_, v_, a_, f_, t_ = map(torch.as_tensor, (q, v, a, f, tau))
    out = {"mass_matrix": lambda: tdyn.mass_matrix(ts, q_),
           "bias_forces": lambda: tdyn.bias_forces(ts, q_, v_),
           "forward_dynamics": lambda: tdyn.forward_dynamics(ts, q_, v_, t_, f_),
           "id_torques": lambda: tdyn.id_torques(ts, q_, v_, a_, f_),
           "com_position": lambda: tdyn.com_position(ts, q_)}[fn]().numpy()
    assert out.shape == ref.shape
    # fp32, sums associated differently: 1e-5 of the output scale, and
    # forward dynamics solves with M(q) at random (poorly conditioned)
    # poses, measured 5e-7 of the scale
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=(2e-6 if fn == "forward_dynamics" else 1e-5) * scale)


def test_contact_params_match_jax(specs):
    js, ts = specs
    jcp, tcp = jax_sim.contact_params_for(js), device_sim.contact_params_for(ts, device="cpu")
    for name in ("stiffness", "damping", "friction_mu", "vel_smoothing"):
        assert float(getattr(tcp, name)) == float(getattr(jcp, name)), name
    # the converter carries them across unchanged
    back = interop.contact_params_from_numpy(jcp, device="cpu")
    assert float(back.stiffness) == float(jcp.stiffness)


def test_pd_rollout_matches_jax(specs):
    """200 steps holding the standing pose under joint PD (kp 60, kd 3) with
    a 20 N sideways push on the base over steps 60-110: the base moves and
    the feet stay in contact, so every contact term is exercised."""
    js, ts = specs
    q0 = np.asarray(js.q_home, np.float32).copy()
    p0 = np.asarray(jdyn.foot_positions(js, q0))
    q0[2] += -p0[0, 2] + float(np.asarray(js.foot_radius))
    v0 = np.zeros(18, np.float32)
    targets = np.repeat(q0[None, 6:], T, 0)
    push = np.zeros((T, 3), np.float32)
    push[60:110, 1] = 20.0
    kp, kd = 60.0, 3.0
    Qj, Vj = jax.jit(lambda q, v, tg, fs: jax_sim.pd_rollout(
        js, q, v, tg, kp=kp, kd=kd, force_schedule=fs))(q0, v0, targets, push)
    st = interop.sim_state_from_numpy(q0, v0, device="cpu")
    Qt, Vt = device_sim.pd_rollout(ts, st.q, st.v, torch.as_tensor(targets), kp=kp, kd=kd,
                                   force_schedule=torch.as_tensor(push))
    assert Qt.shape == (T, 18) and Vt.shape == (T, 18)
    # the push moved the base sideways (measured 3.8 mm) and it stayed up
    assert float(Qt[-1, 1] - q0[1]) > 1e-3 and float(Qt[:, 2].min()) > 0.2
    # states over all 200 steps; measured 1.8e-5
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), rtol=0, atol=1e-4)
    # velocities over the first 100 steps (measured 1.4e-4 of a 1.3 scale):
    # later the feet chatter at the contact switch (depth > 0, max(fz, 0)),
    # where one ulp flips a step and the velocities jump by up to 0.1
    np.testing.assert_allclose(Vt[:100].numpy(), np.asarray(Vj)[:100], rtol=0, atol=1e-3)


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """Without a device argument every entry point asks for CUDA: where
    there is none they raise, and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, opt, cost = get_quadruped_config("trot", "go2")
    spec_cpu = torch_go2(device="cpu")
    calls = {
        "flagship": lambda: tflag.flagship(),
        "go2_spec": lambda: torch_go2(),
        "TrajOptSolver": lambda: TrajOptSolver(spec_cpu, opt, cost),
        "LocomotionMPC": lambda: LocomotionMPC(spec_cpu),
        "default_contact_params": lambda: device_sim.default_contact_params(),
        "warm_start_from_numpy": lambda: interop.warm_start_from_numpy(
            np.zeros((26, 36)), np.zeros((25, 30)), np.zeros((25, 18)), np.zeros((25, 36))),
        "sim_state_from_numpy": lambda: interop.sim_state_from_numpy(np.zeros(18), np.zeros(18)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # with a card present, the default is that card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    from iterative_learning_nmpc_tpu_torch.device import resolve_device
    assert resolve_device() == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
