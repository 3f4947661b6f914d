"""The port's batched on-device rollouts against the JAX package, on the
CPU: ``learning/ondevice.make_batched_mpc_rollout`` in SafeDAgger mode with
the shipped policy against a live JAX build (the one on-device build this
file compiles), plus port-only checks of expert mode, scheduled pushes,
served-weight updates, per-env terrain, the samplers and the batched
Hermite interpolation.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.mpc.interpolate import hermite_interp as jax_hermite
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, load_policy
from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
from iterative_learning_nmpc_tpu_torch.learning.randomize import (
    TerrainParams, randomize_payload, randomize_terrain, sample_force_windows)
from iterative_learning_nmpc_tpu_torch.mpc.interpolate import hermite_interp
from iterative_learning_nmpc_tpu_torch.ops import policy_pd as tpp
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.sim import device_sim

# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them
torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
HOST_BC = os.path.join(ROOT, "assets", "policy_go2_trot_host_bc.pkl")
DAGGER_GOLDEN = os.path.join(ROOT, "tests", "data", "go2_trot_safedagger_golden.npz")


@pytest.fixture(scope="module")
def spec():
    return torch_go2(device="cpu")


@pytest.fixture(scope="module")
def standing(spec):
    """Two identical standing starts (the goldens' env 0), (2, 36)."""
    return np.tile(np.load(DAGGER_GOLDEN)["x0"][:1], (2, 1))


def check_safedagger_rows(out, ref):
    """chip_smoke.py phase 13's bounds on the rows of a B=2 SafeDAgger
    rollout: tight on the first interval (the boot plan's), loose after."""
    first = np.s_[:, :40]
    np.testing.assert_allclose(out["q"][first], ref["q"][first], rtol=0, atol=5e-3)
    np.testing.assert_allclose(out["v"][first][..., :6], ref["v"][first][..., :6],
                               rtol=0, atol=0.1)
    np.testing.assert_allclose(out["action"][first], ref["action"][first], rtol=0, atol=5e-2)
    np.testing.assert_allclose(out["q"], ref["q"], rtol=0, atol=5e-2)
    np.testing.assert_allclose(out["action"], ref["action"], rtol=0, atol=0.15)


def test_safedagger_rollout_matches_jax(spec):
    """The whole slice: SafeDAgger mode with the artifact (B=2, a clean and
    a joint-noise start, 0.3 m/s, 2 intervals, delay 20, MPC latched >= 60
    steps) against the live JAX make_batched_mpc_rollout, and the golden
    against the live JAX."""
    g = np.load(DAGGER_GOLDEN)
    mod_spec = importlib.util.spec_from_file_location(
        "make_torch_learning_golden",
        os.path.join(ROOT, "scripts", "make_torch_learning_golden.py"))
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    ref = mod.safedagger_rollout(jax_go2(), g["x0"], g["v_des"], int(g["n_intervals"]))
    rollout = make_batched_mpc_rollout(
        spec, n_intervals=int(g["n_intervals"]), policy=load_policy(ARTIFACT, device="cpu"),
        delay_steps=int(g["delay_steps"]), mpc_min_steps=int(g["mpc_min_steps"]),
        device="cpu")
    out = {k: v.numpy() for k, v in rollout(g["x0"], g["v_des"])._asdict().items()}
    B, T = g["x0"].shape[0], 80
    assert out["q"].shape == (B, T, 18) and out["state44"].shape == (B, T, 44)
    # the same switches: the policy for the 20 delay steps, then the MPC
    # latched; nobody fell
    for name in ("is_expert", "valid"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    assert (out["is_expert"][:, :20] == 0).all() and (out["is_expert"][:, 21:] == 1).all()
    assert (out["valid"] == 1).all()
    # every row is consumed by the plant. One plant step agrees to ~1e-5
    # (tests/test_torch_plant.py) and the boot solve (6 iterations from a cold start) to fp32's
    # 1e-3..1e-1 on the plan's tail; once the expert takes over, the closed
    # loop doubles the rows' deviation every ~10 steps. Measured here: q
    # 1.1e-3 on the first interval, 2.4e-3 over both; on the H100 (kernel
    # path and plain path alike) 1.1e-3 and 1.5e-2, base velocity 3.0e-2
    # and 0.17, actions 9.3e-3 and 5.0e-2 (joint velocities jump by up to
    # 1.7 at foot impacts, so they are held through q and the actions)
    check_safedagger_rows(out, ref)
    check_safedagger_rows(out, {k: g[k] for k in ref})
    # the golden is the live JAX function's output
    np.testing.assert_allclose(g["q"], ref["q"], rtol=0, atol=1e-5)


def test_expert_mode_and_a_push_on_one_env(spec, standing):
    """Without a policy every row is the expert's. Two identical envs, the
    second pushed sideways (150 N over steps 10-30): identical rows before
    the push, the pushed env alone moved. A plant spec takes one payload
    per env."""
    rollout = make_batched_mpc_rollout(spec, n_intervals=1, device="cpu")
    fw = np.zeros((2, 5), np.float32)
    fw[1] = [10.9, 30.2, 0.0, 150.0, 0.0]         # int32 truncation: 10..29
    v_des = np.array([[0.2, 0.0, 0.0]] * 2, np.float32)
    out = rollout(standing, v_des, force_windows=fw)
    assert (out.is_expert == 1).all() and (out.valid == 1).all()
    q = out.q.numpy()
    assert np.array_equal(q[0, :11], q[1, :11])   # the push acts from step 10
    assert q[0, 11, 1] != q[1, 11, 1]
    # measured: the pushed env 3.7 mm further sideways, the other within 0.3 mm
    dy = q[1, -1, 1] - q[0, -1, 1]
    assert dy > 2e-3 and abs(q[0, -1, 1] - standing[0, 1]) < 1e-3, (dy, q[0, -1, 1])
    with pytest.raises(ValueError, match=r"\(3,\) payloads for 2 envs"):
        rollout(standing, v_des,
                plant_spec=randomize_payload(spec, torch.Generator().manual_seed(0), 3))


def test_policy_update_serves_new_weights(spec, standing):
    """policy_update swaps the served weights and norm stats for one call:
    with the policy in control (delay longer than the rollout) every
    applied torque is the updated policy's at the recorded row."""
    rollout = make_batched_mpc_rollout(
        spec, n_intervals=1, policy=load_policy(ARTIFACT, device="cpu"),
        delay_steps=100, device="cpu")
    net, norm = load_policy(HOST_BC, device="cpu")
    v_des = torch.tensor([[0.15, 0.0, 0.0]] * 2)
    n0 = tpp.policy_pd.launches
    out = rollout(standing, v_des, policy_update=(net.flax_variables(), norm))
    assert tpp.policy_pd.launches == n0
    assert (out.is_expert == 0).all()
    served = ServedPolicy(net, norm, device="cpu")
    B, T = out.q.shape[:2]
    flat = lambda t: t.reshape(B * T, -1)
    _, tau = served(flat(out.state44), v_des.repeat_interleave(T, 0),
                    flat(out.q)[:, 6:], flat(out.v)[:, 6:], 20.0, 1.5)
    tl = spec.torque_limit
    torch.testing.assert_close(flat(out.tau), torch.clamp(tau, -tl, tl), rtol=0, atol=1e-4)


def test_per_env_terrain_matches_single_env_runs(spec, standing):
    """A batch with per-env ground height and contact parameters steps as
    each env does alone with its own scalars."""
    B, steps = 3, 30
    terrain = randomize_terrain(torch.Generator().manual_seed(3), B, device="cpu")
    q0 = torch.as_tensor(np.tile(standing[:1, :18], (B, 1)))
    q0[:, 2] += terrain.ground_height
    tau = 2.0 * torch.randn(steps, B, 12, generator=torch.Generator().manual_seed(4))
    st = device_sim.SimState(q0, torch.zeros(B, 18), torch.zeros(B))
    for k in range(steps):
        st = device_sim.step(spec, st, tau[k], terrain.contact, ground_height=terrain.ground_height)
    for i in range(B):
        cp_i = device_sim.ContactParams(**{f.name: getattr(terrain.contact, f.name)[i]
                                           for f in dataclasses.fields(device_sim.ContactParams)})
        s = device_sim.SimState(q0[i], torch.zeros(18), torch.zeros(()))
        for k in range(steps):
            s = device_sim.step(spec, s, tau[k, i], cp_i, ground_height=terrain.ground_height[i])
        # the same fp32 arithmetic per env; the batched Cholesky may order
        # its sums differently: measured 0 here
        torch.testing.assert_close(st.q[i], s.q, rtol=0, atol=1e-6)
        torch.testing.assert_close(st.v[i], s.v, rtol=0, atol=1e-5)
    # the terrains differ, and so do the envs' heights above their ground
    assert float(terrain.contact.stiffness.std()) > 1e3
    z = st.q[:, 2] - terrain.ground_height
    assert float(z.max() - z.min()) > 1e-4


def test_samplers_are_seeded_and_in_range():
    g = lambda s: torch.Generator().manual_seed(s)
    tr = randomize_terrain(g(0), 256, device="cpu")
    assert isinstance(tr, TerrainParams)
    assert tr.ground_height.abs().max() <= 0.02
    assert 1.0e4 <= float(tr.contact.stiffness.min()) and float(tr.contact.stiffness.max()) <= 4.0e4
    assert 0.5 <= float(tr.contact.friction_mu.min()) and float(tr.contact.friction_mu.max()) <= 1.0
    assert torch.equal(tr.ground_height, randomize_terrain(g(0), 256, device="cpu").ground_height)
    T = 600
    wins = sample_force_windows(g(1), 256, T, device="cpu")
    assert (wins[:, 0] >= 0).all() and (wins[:, 1] <= T + 1).all()
    dur = wins[:, 1] - wins[:, 0]
    assert (dur >= 199.9).all() and (dur <= 400.1).all()
    mags = torch.linalg.vector_norm(wins[:, 2:], dim=1)
    assert (mags >= 49.9).all() and (mags <= 70.1).all()


def test_batched_hermite_matches_jax():
    """Values and derivatives with a leading env batch, the knots shared."""
    rng = np.random.default_rng(11)
    B, K, D = 3, 26, 18
    t = np.concatenate([[0.0], np.cumsum(np.full(K - 1, 0.04))]).astype(np.float32)
    y, dy = (rng.standard_normal((B, K, D)).astype(np.float32) for _ in range(2))
    tq = ((np.arange(40) + 1.0) * 1e-3).astype(np.float32)
    ref = np.asarray(jax.vmap(jax_hermite, in_axes=(None, 0, 0, None))(
        jnp.asarray(t), y, dy, jnp.asarray(tq)))
    out = hermite_interp(*map(torch.as_tensor, (t, y, dy, tq))).numpy()
    assert out.shape == (B, 40, D)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # each env as the unbatched call
    np.testing.assert_array_equal(
        out[1], hermite_interp(*map(torch.as_tensor, (t, y[1], dy[1], tq))).numpy())
