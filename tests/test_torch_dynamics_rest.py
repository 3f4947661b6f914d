"""The rest of the port's dynamics (``models/dynamics.py``: ``foot_jacobians``,
``fk_pos``, ``fk_vel``, ``centroidal_momentum``, ``centroidal_momentum_rate``,
``contact_wrench_about_com``) against the JAX package and against MuJoCo on
the port's own MJCF (``robots/mjcf.py``), on the CPU.

Against JAX: Go2 and Solo12, states from numpy seeds 0-2, one problem a
seed, the spec a payload spec (``mass`` (3, 18), ``com`` (3, 18, 3): seed
0 nominal, seeds 1-2 with 1.5 and 3 kg on the trunk and its CoM moved),
which the JAX functions take under ``jax.vmap`` with ``payload_spec_axes``
and the port's broadcast; each output within 1e-5 of its scale (fp32 both,
the same algorithm). Against MuJoCo: the checks of the JAX package's
``tests/test_dynamics_vs_mujoco.py`` (feet FK, foot velocities, RNEA and
the foot Jacobians, the mass matrix, the linear centroidal momentum, the
Newton-Euler balance) at that file's tolerances, in float32. One jitted
JAX function a robot; ~14 s of worker time.
"""
import dataclasses

import mujoco
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.learning import randomize as jrand
from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec as jax_solo12
from iterative_learning_nmpc_tpu_torch import interop
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn
from iterative_learning_nmpc_tpu_torch.models import transforms as ttf
from iterative_learning_nmpc_tpu_torch.models.math3d import (
    euler_rate_to_local_angular, ypr_to_matrix)
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.robots.mjcf import make_mj_model
from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec

torch.set_num_threads(1)
SEEDS = (0, 1, 2)
REL = 1e-5
ROBOTS = {"go2": (jax_go2, go2_spec), "solo12": (jax_solo12, solo12_spec)}


def random_state(q_home, rng, scale_v=1.0):
    """The JAX MuJoCo test's state draw: (q, v) float64."""
    q = np.array(q_home, dtype=np.float64)
    q[:3] += rng.uniform(-0.5, 0.5, 3)
    q[3:6] = rng.uniform(-0.4, 0.4, 3)
    q[6:] += rng.uniform(-0.3, 0.3, 12)
    v = rng.uniform(-1.0, 1.0, 18) * scale_v
    return q, v


def payload(jspec):
    """A JAX payload spec of len(SEEDS) environments: the first nominal."""
    extra = np.array([0.0, 1.5, 3.0], np.float32)
    mass = np.tile(np.asarray(jspec.mass), (3, 1))
    com = np.tile(np.asarray(jspec.com), (3, 1, 1))
    mass[:, 5] += extra
    com[:, 5, :2] += np.array([[0.0, 0.0], [0.02, -0.01], [-0.03, 0.02]], np.float32)
    return dataclasses.replace(jspec, mass=jnp.asarray(mass), com=jnp.asarray(com))


def outputs(d, spec, q, v, a, f):
    fk = d.fk_vel(spec, q, v)
    return dict(J=d.foot_jacobians(spec, q), fk_pos=d.fk_pos(spec, q), fk_R=fk.R, fk_p=fk.p,
                fk_w=fk.w, fk_vlin=fk.vlin, h=d.centroidal_momentum(spec, q, v),
                hdot=d.centroidal_momentum_rate(spec, q, v, a),
                wrench=d.contact_wrench_about_com(spec, q, f))


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_dynamics_rest_matches_jax(robot):
    jax_fn, torch_fn = ROBOTS[robot]
    jspec = payload(jax_fn())
    tspec = interop.spec_from_numpy(jspec, device="cpu")
    assert tspec.batch_shape == (3,)
    q, v, a, f = [], [], [], []
    for s in SEEDS:
        rng = np.random.default_rng(s)
        qs, vs = random_state(np.asarray(jspec.q_home), rng)
        q.append(qs)
        v.append(vs)
        a.append(rng.uniform(-5.0, 5.0, 18))
        f.append(rng.uniform(0.0, 40.0, (4, 3)))
    q, v, a, f = (np.asarray(x, np.float32) for x in (q, v, a, f))

    def one(spec, q, v, a, f):
        out = outputs(jdyn, spec, q, v, a, f)
        out["fk_pos"] = tuple(out["fk_pos"])
        return out

    run = jax.jit(jax.vmap(one, in_axes=(jrand.payload_spec_axes(jspec), 0, 0, 0, 0)))
    ref = jax.tree.map(np.asarray, run(jspec, q, v, a, f))
    got = outputs(tdyn, tspec, *(torch.as_tensor(x) for x in (q, v, a, f)))
    for name, r in ref.items():
        g = got[name]
        for r_i, g_i in (zip(r, g) if isinstance(r, tuple) else [(r, g)]):
            g_i = g_i.numpy()
            assert g_i.shape == r_i.shape, (name, g_i.shape, r_i.shape)
            err = np.abs(g_i - r_i).max() / max(1.0, np.abs(r_i).max())
            assert err <= REL, (robot, name, err)
    # the payload's nominal row is the nominal spec's
    nominal = outputs(tdyn, torch_fn(device="cpu"), *(torch.as_tensor(x[0]) for x in (q, v, a, f)))
    for name in ("h", "hdot", "wrench"):
        np.testing.assert_allclose(nominal[name].numpy(), got[name][0].numpy(), rtol=0, atol=1e-5)


# --- MuJoCo as the oracle (the JAX package's test_dynamics_vs_mujoco.py) ---
@pytest.fixture(scope="module", params=sorted(ROBOTS))
def robot(request):
    spec = ROBOTS[request.param][1](device="cpu")
    model = make_mj_model(spec, with_floor=False)
    return spec, model, mujoco.MjData(model)


def f32(*xs):
    return [torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in xs]


def to_mujoco(model, data, q, v):
    q_mj, v_mj = ttf.convert_to_mujoco(*f32(q, v))
    data.qpos[:] = q_mj.double().numpy()
    data.qvel[:] = v_mj.double().numpy()
    mujoco.mj_forward(model, data)


def test_fk_feet_and_velocities_vs_mujoco(robot):
    spec, model, data = robot
    rng = np.random.default_rng(10)
    for _ in range(2):
        q, v = random_state(spec.q_home.numpy(), rng)
        to_mujoco(model, data, q, v)
        p_feet = tdyn.foot_positions(spec, *f32(q)).numpy()
        for i, leg in enumerate(["FL", "FR", "RL", "RR"]):
            gid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_GEOM, f"{leg}_foot")
            np.testing.assert_allclose(p_feet[i], data.geom_xpos[gid], atol=2e-5)
    qt, vt = f32(q, v)
    _, pdot = torch.func.jvp(lambda qq: tdyn.foot_positions(spec, qq), (qt,), (vt,))
    np.testing.assert_allclose(pdot.numpy(), tdyn.foot_velocities(spec, qt, vt).numpy(),
                               atol=1e-5)
    # the Jacobian's product with v is the foot velocity
    J = tdyn.foot_jacobians(spec, qt)
    np.testing.assert_allclose((J @ vt).numpy(), pdot.numpy(), atol=1e-5)


def test_rnea_and_jacobians_vs_mujoco(robot):
    spec, model, data = robot
    rng = np.random.default_rng(11)
    q, v = random_state(spec.q_home.numpy(), rng)
    a = rng.uniform(-5.0, 5.0, 18)
    to_mujoco(model, data, q, v)
    qt, vt, at = f32(q, v, a)
    v_mj, a_mj = torch.func.jvp(lambda qq, vv: ttf.vel_to_mujoco(qq, vv), (qt, vt), (vt, at))
    data.qacc[:] = a_mj.double().numpy()
    mujoco.mj_inverse(model, data)
    tau_mj = data.qfrc_inverse.copy()
    tau = tdyn.rnea(spec, qt, vt, at).numpy()
    np.testing.assert_allclose(tau[6:], tau_mj[6:], rtol=2e-4, atol=2e-3)
    Tv = torch.func.jacfwd(lambda vv: ttf.vel_to_mujoco(qt, vv))(vt).numpy()
    np.testing.assert_allclose(tau[:6], Tv[:6, :6].T @ tau_mj[:6], rtol=2e-4, atol=5e-3)
    # tau(f) == tau(0) - sum J^T f
    f = rng.uniform(-30, 30, (4, 3))
    tau_f = tdyn.rnea(spec, qt, vt, at, f_ext_feet=f32(f)[0]).numpy()
    J = tdyn.foot_jacobians(spec, qt).numpy()
    np.testing.assert_allclose(tau_f, tau - np.einsum("fi,fij->j", f, J), rtol=1e-4, atol=1e-3)


def test_mass_matrix_vs_mujoco(robot):
    spec, model, data = robot
    q, v = random_state(spec.q_home.numpy(), np.random.default_rng(12), scale_v=0.0)
    to_mujoco(model, data, q, v)
    M_mj = np.zeros((model.nv, model.nv))
    mujoco.mj_fullM(model, data, M_mj)
    qt, = f32(q)
    M = tdyn.mass_matrix(spec, qt).numpy()
    T = torch.func.jacfwd(lambda vv: ttf.vel_to_mujoco(qt, vv))(torch.zeros(18)).numpy()
    np.testing.assert_allclose(M, T.T @ M_mj @ T, rtol=2e-4, atol=2e-3)
    np.testing.assert_array_less(0.0, np.linalg.eigvalsh(M).min())


def test_centroidal_momentum_and_newton_euler(robot):
    spec, _, _ = robot
    rng = np.random.default_rng(13)
    q, v = random_state(spec.q_home.numpy(), rng)
    qt, vt = f32(q, v)
    # the linear part is the total mass times the CoM velocity
    h = tdyn.centroidal_momentum(spec, qt, vt).numpy()
    _, cdot = torch.func.jvp(lambda qq: tdyn.com_position(spec, qq), (qt,), (vt,))
    m = float(spec.mass.sum())
    np.testing.assert_allclose(h[:3], m * cdot.numpy(), rtol=1e-4, atol=1e-4)
    # hdot along the equations of motion equals the contact wrench
    f, tau_j = f32(rng.uniform(0, 40, (4, 3)), rng.uniform(-10, 10, 12))
    a = tdyn.forward_dynamics(spec, qt, vt, tau_j, f_ext_feet=f)
    hdot = tdyn.centroidal_momentum_rate(spec, qt, vt, a).numpy()
    wrench = tdyn.contact_wrench_about_com(spec, qt, f).numpy()
    np.testing.assert_allclose(hdot, wrench, rtol=2e-3, atol=5e-3)
    # the trunk's FK angular velocity is the Euler-rate map's
    fk = tdyn.fk_vel(spec, qt, vt)
    R = ypr_to_matrix(qt[3:6])
    np.testing.assert_allclose(fk.w[5].numpy(),
                               (R @ euler_rate_to_local_angular(qt[3:6], vt[3:6])).numpy(),
                               atol=1e-5)
