"""The port's policy-serving path against the JAX package, on the CPU.

Kernel 8's module (``ops/policy_pd.py``: BatchNorm folding and the plain
MLP + PD twin), the network and its loader (``learning/network.py``,
``interop.policy_from_numpy``), the observation, chart and safety
contracts (``learning/obs.py``, ``models/transforms.py``,
``models/math3d.py``, ``learning/safety.py``), and the batched policy
rollout on the plant (``sim/device_sim.make_batched_policy_rollout``) with
the shipped policy ``assets/policy_go2_trot_ondevice_dagger.pkl``. Inputs
come from numpy seeds, or from the golden the card is held to
(``scripts/make_torch_learning_golden.py``).
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.learning import network as jnetwork
from iterative_learning_nmpc_tpu.learning import obs as jobs
from iterative_learning_nmpc_tpu.learning import safety as jsafety
from iterative_learning_nmpc_tpu.models import math3d as jm3
from iterative_learning_nmpc_tpu.models import transforms as jtf
from iterative_learning_nmpc_tpu.ops import policy_kernel as jpk
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu_torch import interop
from iterative_learning_nmpc_tpu_torch.learning import network as tnetwork
from iterative_learning_nmpc_tpu_torch.learning import obs as tobs
from iterative_learning_nmpc_tpu_torch.learning import safety as tsafety
from iterative_learning_nmpc_tpu_torch.models import math3d as tm3
from iterative_learning_nmpc_tpu_torch.models import transforms as ttf
from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
from iterative_learning_nmpc_tpu_torch.ops import policy_pd as tpp
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.sim import device_sim

# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them
torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
ENVELOPE = os.path.join(ROOT, "assets", "policy_go2_trot_envelope.pkl")
ROLLOUT_GOLDEN = os.path.join(ROOT, "tests", "data", "go2_trot_policy_rollout_golden.npz")
KP, KD = 20.0, 1.5


def golden_script():
    """scripts/make_torch_learning_golden.py: the JAX reference calls and
    the goldens' inputs."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_learning_golden",
        os.path.join(ROOT, "scripts", "make_torch_learning_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_variables(rng, hidden=64, n_in=47, n_out=12, n_hidden=3):
    """A Flax-layout payload of a narrow batch-normed net with non-trivial
    statistics, so that the folding is exercised."""
    f32 = np.float32
    dims = [n_in] + [hidden] * n_hidden + [n_out]
    params, stats = {}, {}
    for i in range(n_hidden + 1):
        params[f"Dense_{i}"] = {
            "kernel": (rng.standard_normal((dims[i], dims[i + 1]))
                       * np.sqrt(2.0 / dims[i])).astype(f32),
            "bias": (0.1 * rng.standard_normal(dims[i + 1])).astype(f32)}
    for i in range(n_hidden):
        params[f"BatchNorm_{i}"] = {
            "scale": (1.0 + 0.2 * rng.standard_normal(hidden)).astype(f32),
            "bias": (0.1 * rng.standard_normal(hidden)).astype(f32)}
        stats[f"BatchNorm_{i}"] = {
            "mean": (0.1 * rng.standard_normal(hidden)).astype(f32),
            "var": (1.0 + 0.3 * rng.uniform(size=hidden)).astype(f32)}
    cfg = dict(input_size=n_in, output_size=n_out, num_hidden_layer=n_hidden,
               hidden_dim=hidden, batch_norm=True, dropout_rate=0.0)
    return {"params": params, "batch_stats": stats}, cfg


@pytest.fixture(scope="module")
def payloads():
    """{name: (Flax variables, net_config)}: the shipped artifact and a
    random narrow net."""
    with open(ARTIFACT, "rb") as f:
        art = pickle.load(f)
    return {"artifact": (art["variables"], art["net_config"]),
            "random": random_variables(np.random.default_rng(7))}


@pytest.fixture(scope="module")
def specs():
    return jax_go2(), torch_go2(device="cpu")


def _inputs(rng, B, n_in=47):
    return (rng.standard_normal((B, n_in)).astype(np.float32),
            (0.5 * rng.standard_normal((B, 12))).astype(np.float32),
            rng.standard_normal((B, 12)).astype(np.float32))


@pytest.mark.parametrize("which", ["artifact", "random"])
def test_fold_batchnorm_matches_jax(payloads, which):
    variables, _ = payloads[which]
    ours, ref = tpp.fold_batchnorm(variables), jpk.fold_batchnorm(variables)
    assert len(ours) == len(ref) == 4
    for (W, b), (W0, b0) in zip(ours, ref):
        # the same float32 numpy arithmetic: bit-equal
        np.testing.assert_array_equal(W, W0)
        np.testing.assert_array_equal(b, b0)


@pytest.mark.parametrize("which", ["artifact", "random"])
def test_policy_pd_plain_matches_jax(payloads, which):
    """The plain twin against the JAX plain reference on the same folded
    layers, and against the Flax net with its BatchNorm unfolded."""
    variables, cfg = payloads[which]
    x, qj, vj = _inputs(np.random.default_rng(1), 33)
    layers = tpp.fold_batchnorm(variables)
    t_layers = [(torch.as_tensor(W), torch.as_tensor(b)) for W, b in layers]
    n0 = tpp.policy_pd.launches
    act, tau = tpp.policy_pd(t_layers, KP, KD, *map(torch.as_tensor, (x, qj, vj)))
    assert tpp.policy_pd.launches == n0            # CPU tensors take the twin
    act_p, tau_p = tpp.policy_pd_plain(t_layers, KP, KD, *map(torch.as_tensor, (x, qj, vj)))
    assert torch.equal(act, act_p) and torch.equal(tau, tau_p)
    a_ref, t_ref = jpk.policy_pd_reference(layers, KP, KD, x, qj, vj)
    # fp32 sums over K = 512 in another order: the JAX package's own kernel
    # test bounds (tests/test_policy_kernel.py), tau scaled by kp
    np.testing.assert_allclose(act.numpy(), np.asarray(a_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tau.numpy(), np.asarray(t_ref), rtol=2e-4, atol=1e-3)
    jnet = jnetwork.GoalConditionedPolicyNet(**cfg)
    a_flax = np.asarray(jnet.apply(variables, x, train=False))
    np.testing.assert_allclose(act.numpy(), a_flax, rtol=2e-4, atol=2e-5)
    # the port's module, BatchNorm unfolded (eval mode), as the Flax apply
    net, _ = interop.policy_from_numpy({"variables": variables, "net_config": cfg,
                                        "norm_policy_input": None}, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.as_tensor(x)).numpy(), a_flax,
                                   rtol=2e-4, atol=2e-5)


def test_policy_from_numpy_round_trips(payloads):
    variables, cfg = payloads["artifact"]
    with open(ARTIFACT, "rb") as f:
        norm = pickle.load(f)["norm_policy_input"]
    net, tnorm = interop.policy_from_numpy(
        {"variables": variables, "net_config": cfg, "norm_policy_input": norm},
        device="cpu")
    assert net.net_config == cfg and not net.training
    back = net.flax_variables()
    for group in ("params", "batch_stats"):
        assert back[group].keys() == variables[group].keys()
        for layer, arrays in variables[group].items():
            for name, arr in arrays.items():
                np.testing.assert_array_equal(back[group][layer][name], arr,
                                              err_msg=f"{layer}.{name}")
    for t, ref in zip(tnorm, norm):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref, np.float32))


def test_load_policy_plain_and_bundle():
    """A plain payload; a goal-scheduled bundle picks the member nearest
    v_des, and without v_des warns and takes the first member (the JAX
    load_policy's rule)."""
    net, norm = tnetwork.load_policy(ARTIFACT, device="cpu")
    jnet, jvars, jnorm = jnetwork.load_policy(ARTIFACT)
    assert net.net_config["hidden_dim"] == jnet.hidden_dim == 512
    assert [tuple(t.shape) for t in norm] == [(44,), (44,), (), ()]
    np.testing.assert_array_equal(net.flax_variables()["params"]["Dense_3"]["kernel"],
                                  jvars["params"]["Dense_3"]["kernel"])
    with open(ENVELOPE, "rb") as f:
        bundle = pickle.load(f)["bundle"]
    for i, member in enumerate(bundle):
        net, _ = tnetwork.load_policy(ENVELOPE, v_des=np.array(member["goal"]) + 0.01,
                                      device="cpu")
        _, jvars, _ = jnetwork.load_policy(ENVELOPE, v_des=np.array(member["goal"]) + 0.01)
        kernel = member["payload"]["variables"]["params"]["Dense_0"]["kernel"]
        np.testing.assert_array_equal(net.flax_variables()["params"]["Dense_0"]["kernel"],
                                      kernel, err_msg=f"member {i}")
        np.testing.assert_array_equal(jvars["params"]["Dense_0"]["kernel"], kernel)
    with pytest.warns(UserWarning, match="without v_des"):
        net, _ = tnetwork.load_policy(ENVELOPE, device="cpu")
    np.testing.assert_array_equal(
        net.flax_variables()["params"]["Dense_0"]["kernel"],
        bundle[0]["payload"]["variables"]["params"]["Dense_0"]["kernel"])


def test_served_policy_matches_jax_apply(specs):
    """Normalisation (state columns 1:, the scalar goal statistics, std
    guarded at 1e-8) + the folded net + PD against the JAX package's
    make_policy_apply at the golden rollout's states."""
    js, ts = specs
    g = np.load(ROLLOUT_GOLDEN)
    q, v = g["Q"].reshape(-1, 18)[::7], g["V"].reshape(-1, 18)[::7]
    v_des = np.tile(g["v_des"][:1], (len(q), 1))
    apply_fn = jnetwork.make_policy_apply(ARTIFACT)
    x = np.array(jax.jit(jax.vmap(lambda q, v, vd: jobs.policy_input(js, q, v, vd)))(
        q, v, v_des))
    a_ref = np.asarray(jax.jit(jax.vmap(apply_fn))(x))
    net, norm = tnetwork.load_policy(ARTIFACT, device="cpu")
    served = tnetwork.ServedPolicy(net, norm, device="cpu")
    tq, tv = torch.as_tensor(q), torch.as_tensor(v)
    act, tau = served(torch.as_tensor(x[:, :44]), torch.as_tensor(v_des),
                      tq[:, 6:], tv[:, 6:], KP, KD)
    # normalised inputs up to |x| ~ 30: measured 2.9e-6 on the targets
    np.testing.assert_allclose(act.numpy(), a_ref, rtol=0, atol=5e-5)
    np.testing.assert_allclose(tau.numpy(), KP * (a_ref - q[:, 6:]) - KD * v[:, 6:],
                               rtol=0, atol=KP * 5e-5)
    # no statistics: the raw inputs
    plain = tnetwork.ServedPolicy(net, None, device="cpu")
    xt = torch.as_tensor(x)
    assert torch.equal(plain.normalize(xt[:, :44], xt[:, 44:]), xt)


def _random_states(rng, M):
    """Chart states around the standing pose with every attitude, pitch
    close to +-pi/2 and the half-turns whose quaternion has w ~ 0 (where
    the sign rule and the candidate choice decide the result)."""
    q = np.tile(np.asarray(jax_go2().q_home, np.float32), (M, 1))
    q[:, :3] += 0.1 * rng.standard_normal((M, 3))
    q[:, 3] = rng.uniform(-np.pi, np.pi, M)
    q[:, 4] = rng.uniform(-1.5, 1.5, M)
    q[:, 5] = rng.uniform(-np.pi, np.pi, M)
    q[:8, 4] = [np.pi / 2 - 1e-3, -np.pi / 2 + 1e-3, np.pi / 2 - 1e-2, -1.56, 0, 0, 0, 0]
    q[4:8, 3] = [np.pi, 0.0, np.pi / 2, -np.pi]
    q[4:8, 5] = [0.0, np.pi, np.pi, np.pi / 2]
    q[:, 6:] += 0.5 * rng.standard_normal((M, 12))
    v = rng.standard_normal((M, 18)).astype(np.float32)
    return q.astype(np.float32), v


@pytest.mark.parametrize("fn", ["ypr_to_quat", "quat_to_ypr", "euler_rates",
                                "to_mujoco", "from_mujoco", "policy_input"])
def test_charts_and_observation_match_jax(specs, fn):
    js, ts = specs
    q, v = _random_states(np.random.default_rng(5), 64)
    v_des = np.random.default_rng(6).uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    quat = np.asarray(jm3.matrix_to_quat_wxyz(jm3.ypr_to_matrix(q[:, 3:6])))
    q_mj, v_mj = (np.asarray(a) for a in jtf.convert_to_mujoco(q, v))
    T = torch.as_tensor
    cases = {
        # R -> quaternion: the same candidate and sign, ties included
        "ypr_to_quat": (lambda: quat,
                        lambda: tm3.matrix_to_quat_wxyz(tm3.ypr_to_matrix(T(q[:, 3:6])))),
        "quat_to_ypr": (lambda: np.asarray(jm3.matrix_to_ypr(jm3.quat_wxyz_to_matrix(quat))),
                        lambda: tm3.matrix_to_ypr(tm3.quat_wxyz_to_matrix(T(quat)))),
        "euler_rates": (
            lambda: np.concatenate([
                np.asarray(jm3.local_angular_to_euler_rate(q[:, 3:6], v[:, 3:6])),
                np.asarray(jm3.euler_rate_to_local_angular(q[:, 3:6], v[:, 3:6]))], 1),
            lambda: torch.cat([tm3.local_angular_to_euler_rate(T(q[:, 3:6]), T(v[:, 3:6])),
                               tm3.euler_rate_to_local_angular(T(q[:, 3:6]), T(v[:, 3:6]))], 1)),
        "to_mujoco": (lambda: np.concatenate([q_mj, v_mj], 1),
                      lambda: torch.cat(ttf.convert_to_mujoco(T(q), T(v)), 1)),
        "from_mujoco": (
            lambda: np.concatenate([np.asarray(a) for a in jtf.convert_from_mujoco(q_mj, v_mj)], 1),
            lambda: torch.cat(ttf.convert_from_mujoco(T(q_mj), T(v_mj)), 1)),
        "policy_input": (
            lambda: np.asarray(jax.jit(jax.vmap(
                lambda q, v, vd: jobs.policy_input(js, q, v, vd)))(q, v, v_des)),
            lambda: tobs.policy_input(ts, T(q), T(v), T(v_des))),
    }
    ref_fn, port_fn = cases[fn]
    ref, out = ref_fn(), port_fn().numpy()
    assert out.shape == ref.shape
    # fp32 trigonometry of two libraries (1 ulp), through 1 / cos(pitch) up
    # to 1e3 near the gimbal: relative to the magnitude. From a rotation
    # matrix, pitch = asin(-R20) has the slope 1 / cos(pitch) too, so one
    # ulp of R moves it by 6e-5 at 1e-3 rad from the gimbal
    atol = 1e-4 if fn in ("quat_to_ypr", "from_mujoco") else 2e-6
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=atol)
    if fn == "ypr_to_quat":
        assert (out[:, 0] >= 0).all()


def test_unsafe_monitor_and_fall_test_match_reference(specs):
    """The batched monitor against check_unsafe_state_v2 (the port's and the
    JAX package's numpy versions) env by env, with states that trip each
    rule alone; the fall test against the JAX rollout's rule."""
    rng = np.random.default_rng(9)
    M = 48
    q = np.tile(np.asarray(jax_go2().q_home, np.float32), (M, 1))
    q[:, 2] = 0.3
    v = np.zeros((M, 18), np.float32)
    v_des = np.zeros((M, 3), np.float32)
    q[1, 2], q[2, 2] = 0.17, 0.46                       # height
    q[3, 4], q[4, 5] = 0.45, -0.45                      # pitch, roll > 25 deg
    q[5, 7] = np.deg2rad(116.0)                          # a thigh past its bound
    q[6, 14] = np.deg2rad(-156.0)                        # a calf past its bound
    v[7, 0], v_des[8, 1] = 0.11, -0.12                  # tracking
    q[9:, 2] = rng.uniform(0.1, 0.55, M - 9)
    q[9:, 4:6] = rng.uniform(-0.6, 0.6, (M - 9, 2))
    q[9:, 6:] += rng.normal(0, 0.4, (M - 9, 12))
    v[9:, :2] = rng.normal(0, 0.1, (M - 9, 2))
    v_des[9:, :2] = rng.normal(0, 0.1, (M - 9, 2))
    T = torch.as_tensor
    got = tsafety.unsafe_v2(T(q), T(v), T(v_des)).numpy()
    ref = []
    for i in range(M):
        q_mj, v_mj = tnp.convert_to_mujoco(q[i].astype(np.float64), v[i].astype(np.float64))
        ours = tsafety.check_unsafe_state_v2(q_mj, v_mj, v_des[i])
        assert ours == jsafety.check_unsafe_state_v2(q_mj, v_mj, v_des[i]), i
        ref.append(ours)
    np.testing.assert_array_equal(got, ref)
    assert not got[0] and got[1:9].all() and 0 < got[9:].sum() < M - 9
    up = tsafety.upright(T(q)).numpy()
    up_ref = ((q[:, 2] > jsafety.FALL_HEIGHT_BOUNDS[0]) & (q[:, 2] < jsafety.FALL_HEIGHT_BOUNDS[1])
              & (np.abs(q[:, 4]) < jsafety.FALL_MAX_TILT_RAD)
              & (np.abs(q[:, 5]) < jsafety.FALL_MAX_TILT_RAD))
    np.testing.assert_array_equal(up, up_ref)
    assert 0 < up.sum() < M
    for name in ("UNSAFE_HEIGHT_BOUNDS", "UNSAFE_MAX_ROLL_PITCH_DEG", "VEL_TRACK_TOL",
                 "FALL_HEIGHT_BOUNDS", "FALL_MAX_TILT_RAD", "JOINT_BOUNDS_DEG"):
        assert getattr(tsafety, name) == getattr(jsafety, name), name
    np.testing.assert_array_equal(tsafety.JOINT_BOUNDS_FLAT, jsafety.JOINT_BOUNDS_FLAT)


def test_policy_rollout_matches_jax(specs):
    """The whole slice: the batched policy rollout of the artifact (B=2: a
    clean and a joint-noise standing start, 0.3 m/s, T=100) against the
    JAX package's jax_sim rollout, and the golden against the live JAX."""
    js, ts = specs
    g = np.load(ROLLOUT_GOLDEN)
    T_steps = g["Q"].shape[1]
    Qj, Vj, fell_j = golden_script().policy_rollout(js, g["q0"], g["v0"], g["v_des"], T_steps)
    rollout = device_sim.make_batched_policy_rollout(
        ts, tnetwork.load_policy(ARTIFACT, device="cpu"), T_steps, device="cpu")
    n0 = tpp.policy_pd.launches
    Q, V, fell = (a.numpy() for a in rollout(g["q0"], g["v0"], g["v_des"]))
    assert tpp.policy_pd.launches == n0            # the CPU path runs the twin
    assert Q.shape == V.shape == (2, T_steps, 18)
    np.testing.assert_array_equal(fell, fell_j)
    assert not fell.any() and (Q[:, -1, 0] > g["q0"][:, 0]).all()
    # one step agrees to ~1e-5 in v (the plant's fp32, test_torch_plant.py); foot impacts
    # under the stiff contact amplify that through the policy's feedback:
    # measured 1.4e-3 on q over the 100 steps, 2.5e-2 on the base velocity,
    # 2.2e-4 on v over the first 10 steps, joint velocities up to 1.2 at
    # the impacts of steps 20-50
    for ours, ref in ((Q, Qj), (Q, g["Q"])):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-3)
    for ours, ref in ((V, Vj), (V, g["V"])):
        np.testing.assert_allclose(ours[:, :, :6], ref[:, :, :6], rtol=0, atol=0.1)
        np.testing.assert_allclose(ours[:, :10], ref[:, :10], rtol=0, atol=2e-3)
    # the golden is the live JAX function's output
    np.testing.assert_allclose(g["Q"], Qj, rtol=0, atol=1e-5)


def test_slice_entry_points_need_a_device(monkeypatch):
    """Without a device argument the slice's entry points ask for CUDA:
    where there is none they raise, and never fall back to the CPU."""
    from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu_torch.learning.randomize import randomize_terrain
    from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu_torch.ocp import problem

    spec = torch_go2(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, opt, cost = get_quadruped_config("trot", "go2")
    variables, _ = random_variables(np.random.default_rng(0), hidden=8)
    calls = {
        "make_weights": lambda: problem.make_weights(opt, cost, spec),
        "dynamics_matrices": lambda: problem.dynamics_matrices(0.04),
        "load_policy": lambda: tnetwork.load_policy(ARTIFACT),
        "ServedPolicy": lambda: tnetwork.ServedPolicy(variables),
        "make_batched_policy_rollout": lambda: device_sim.make_batched_policy_rollout(
            spec, (variables, None), 10),
        "make_batched_mpc_rollout": lambda: make_batched_mpc_rollout(spec, n_intervals=1),
        "randomize_terrain": lambda: randomize_terrain(torch.Generator(), 4),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
