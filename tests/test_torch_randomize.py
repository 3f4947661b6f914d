"""Per-environment payloads in the port (``learning/randomize.py``,
``models/dynamics.py``, ``sim/device_sim.py``, ``learning/ondevice.py``)
against the JAX package, on the CPU: ``randomize_payload``'s arithmetic on
the JAX draws, a payload plant against ``jax_sim.step`` under
``jax.vmap(in_axes=payload_spec_axes(spec))``, a batch of payload plants
against each env alone, a zero payload bit-equal to the nominal spec, and
a randomized batched rollout. No JAX rollout is built (one jitted plant
step of 30 steps is the only JAX compile). 26 s of worker time: the JAX
plant 11 s, the B=2 rollout 7 s, none of the five tests over 15 s.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.learning import randomize as jrand
from iterative_learning_nmpc_tpu.sim import jax_sim
from iterative_learning_nmpc_tpu_torch import interop
from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
from iterative_learning_nmpc_tpu_torch.learning.randomize import (
    payload_spec, payload_spec_axes, randomize_payload, randomize_terrain,
    sample_force_windows)
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.robots.spec import _TENSOR_FIELDS
from iterative_learning_nmpc_tpu_torch.sim import device_sim

torch.set_num_threads(1)
B, STEPS = 3, 30


@pytest.fixture(scope="module")
def spec():
    return torch_go2(device="cpu")


def start_and_inputs(spec, n, seed=5):
    """n standing starts with joint noise, (STEPS, n, 12) random torques and
    (n, 3) base pushes of 40 N in random directions."""
    rng = np.random.default_rng(seed)
    q0 = np.tile(tdyn.settled_state(spec)[None, :18], (n, 1))
    q0[:, 6:] += rng.normal(0, 0.03, (n, 12)).astype(np.float32)
    tau = (2.0 * rng.standard_normal((STEPS, n, 12))).astype(np.float32)
    d = rng.standard_normal((n, 3))
    f_ext = (40.0 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return q0.astype(np.float32), tau, f_ext


def port_steps(spec, q0, tau, f_ext, cp):
    st = device_sim.SimState(torch.as_tensor(q0), torch.zeros(q0.shape[:-1] + (18,)),
                             torch.zeros(q0.shape[:-1]))
    Q, V = [], []
    for k in range(STEPS):
        st = device_sim.step(spec, st, torch.as_tensor(tau[k]), cp,
                             f_ext=torch.as_tensor(f_ext))
        Q.append(st.q)
        V.append(st.v)
    return torch.stack(Q), torch.stack(V)


def test_payload_arithmetic_matches_jax(go2, spec):
    """The port's payload on the JAX draws (the keys split as JAX
    ``randomize_payload`` splits them) equals the JAX spec; the converter
    carries a JAX payload spec across with its batch; the axes agree."""
    n, key = 8, jax.random.PRNGKey(0)
    jps = jrand.randomize_payload(go2, key, n)
    k1, k2 = jax.random.split(key)
    extra = np.array(jax.random.uniform(k1, (n,), minval=0.0, maxval=3.0))
    shift = np.array(jax.random.uniform(k2, (n, 2), minval=-0.03, maxval=0.03))
    tps = payload_spec(spec, extra, shift)
    assert tps.batch_shape == (n,) and tps.batched_fields() == ("mass", "com")
    # the same float32 operations in the same order: measured 0 for both,
    # held to a few ulps of their scale (XLA may contract w * shift + com)
    np.testing.assert_allclose(tps.mass.numpy(), np.asarray(jps.mass), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tps.com.numpy(), np.asarray(jps.com), rtol=0, atol=1e-8)
    for f in _TENSOR_FIELDS:
        if f not in ("mass", "com"):
            assert getattr(tps, f) is getattr(spec, f), f
    conv = interop.spec_from_numpy(jps, device="cpu")
    assert torch.equal(conv.mass, torch.as_tensor(np.asarray(jps.mass)))
    assert torch.equal(conv.com, torch.as_tensor(np.asarray(jps.com)))
    assert conv.joint_pos.shape == (18, 3)
    with pytest.raises(ValueError, match="per-environment batch"):
        interop.spec_from_numpy(dataclasses.replace(jps, q_home=np.zeros((n, 18))),
                                device="cpu")
    jaxes, taxes = jrand.payload_spec_axes(go2), payload_spec_axes(spec)
    for f in _TENSOR_FIELDS:
        assert getattr(taxes, f) == getattr(jaxes, f), f
    # the port's sampler: the trunk alone gains 0-3 kg, its CoM moves by
    # the payload's share of +-3 cm in x and y
    r = randomize_payload(spec, torch.Generator().manual_seed(0), 256)
    dm = r.mass - spec.mass
    assert (dm[:, 5] >= 0).all() and (dm[:, 5] <= 3.0).all() and float(dm[:, 5].std()) > 0.5
    assert (dm[:, :5] == 0).all() and (dm[:, 6:] == 0).all()
    dc = r.com - spec.com
    assert (dc[:, 5, :2].abs() <= 0.03 * 3.0 / (float(spec.mass[5]) + 3.0) + 1e-7).all()
    assert (dc[:, 5, 2] == 0).all() and (dc[:, :5] == 0).all() and (dc[:, 6:] == 0).all()


def test_payload_plant_matches_jax_vmap(go2, spec):
    """30 plant steps of 3 envs, each with its own payload, random torques
    and a 40 N base push (divided by each env's own total mass), against
    ``jax_sim.step`` under ``jax.vmap(in_axes=payload_spec_axes(spec))``."""
    jps = jrand.randomize_payload(go2, jax.random.PRNGKey(1), B)
    tps = interop.spec_from_numpy(jps, device="cpu")
    q0, tau, f_ext = start_and_inputs(spec, B)
    jcp = jax_sim.contact_params_for(go2)

    def one_env(s, q, taus, f):
        def body(st, t):
            st = jax_sim.step(s, st, t, jcp, 1e-3, f_ext=f)
            return st, (st.q, st.v)
        _, (Q, V) = jax.lax.scan(body, jax_sim.SimState(q, jnp.zeros(18), jnp.zeros(())),
                                 taus)
        return Q, V

    run = jax.jit(jax.vmap(one_env, in_axes=(jrand.payload_spec_axes(go2), 0, 1, 0)))
    Qj, Vj = (np.asarray(a).transpose(1, 0, 2) for a in run(jps, q0, tau, f_ext))
    Qt, Vt = port_steps(tps, q0, tau, f_ext, device_sim.contact_params_for(spec, device="cpu"))
    # tests/test_torch_plant.py's bounds for one plant against the other:
    # measured 2.4e-7 (q) and 2.5e-5 (v, of a scale of 8.4) here
    np.testing.assert_allclose(Qt.numpy(), Qj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(Vt.numpy(), Vj, rtol=0, atol=1e-3)
    # the payloads matter: the nominal plant ends elsewhere (measured 5.4e-4)
    Qn, _ = port_steps(spec, q0, tau, f_ext, device_sim.contact_params_for(spec, device="cpu"))
    assert float((Qn[-1] - Qt[-1]).abs().max()) > 1e-4


def test_payload_batch_matches_single_envs(spec):
    """A batch of payload plants steps as each env does alone with its own
    spec (``RobotSpec.take``), to the bounds of
    test_torch_ondevice.py::test_per_env_terrain_matches_single_env_runs."""
    ps = randomize_payload(spec, torch.Generator().manual_seed(2), B)
    q0, tau, f_ext = start_and_inputs(spec, B, seed=6)
    cp = device_sim.contact_params_for(spec, device="cpu")
    Qb, Vb = port_steps(ps, q0, tau, f_ext, cp)
    for i in range(B):
        Qi, Vi = port_steps(ps.take(i), q0[i], tau[:, i], f_ext[i], cp)
        # the same fp32 arithmetic per env; the batched Cholesky may order
        # its sums differently: measured 0
        torch.testing.assert_close(Qb[:, i], Qi, rtol=0, atol=1e-6)
        torch.testing.assert_close(Vb[:, i], Vi, rtol=0, atol=1e-5)


def test_zero_payload_is_the_nominal_spec_bit_for_bit(spec):
    """A payload spec of zero payloads (mass (B, 18), com (B, 18, 3)) gives
    the nominal spec's dynamics and plant steps bit for bit."""
    zero = payload_spec(spec, np.zeros(B, np.float32), np.zeros((B, 2), np.float32))
    assert torch.equal(zero.mass, spec.mass.expand(B, 18))
    q0, tau, f_ext = start_and_inputs(spec, B, seed=7)
    rng = np.random.default_rng(8)
    q = torch.as_tensor(q0)
    v, a = (torch.as_tensor(rng.standard_normal((B, 18)).astype(np.float32)) for _ in range(2))
    f = torch.as_tensor((30.0 * rng.standard_normal((B, 4, 3))).astype(np.float32))
    tj = torch.as_tensor(tau[0])
    for name, fn in (("mass_matrix", lambda s: tdyn.mass_matrix(s, q)),
                     ("rnea", lambda s: tdyn.rnea(s, q, v, a, f)),
                     ("com_position", lambda s: tdyn.com_position(s, q)),
                     ("forward_dynamics", lambda s: tdyn.forward_dynamics(s, q, v, tj, f))):
        assert torch.equal(fn(zero), fn(spec)), name
    cp = device_sim.contact_params_for(spec, device="cpu")
    for x, y in zip(port_steps(zero, q0, tau, f_ext, cp), port_steps(spec, q0, tau, f_ext, cp)):
        assert torch.equal(x, y)


def test_randomized_rollout_stays_upright(spec):
    """make_batched_mpc_rollout at B=2, 2 intervals, each plant with its
    payload and terrain, env 1 pushed (env 0 push-free, as the DAgger loop
    keeps half): every row finite and valid, the base up, the controller's
    model nominal while the plants carry the payloads."""
    n = 2
    gen = lambda s: torch.Generator().manual_seed(s)
    ps = randomize_payload(spec, gen(10), n)
    tr = randomize_terrain(gen(11), n, device="cpu")
    fw = sample_force_windows(gen(12), n, 80, device="cpu")
    fw[:1] = 0.0
    x0 = np.tile(tdyn.settled_state(spec)[None], (n, 1))
    x0[:, 2] += tr.ground_height.numpy()
    v_des = np.array([[0.2, 0.0, 0.0]] * n, np.float32)
    rollout = make_batched_mpc_rollout(spec, n_intervals=2, device="cpu")
    out = rollout(x0, v_des, ps, tr, force_windows=fw)
    assert out.q.shape == (n, 80, 18)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert (out.valid == 1).all() and (out.is_expert == 1).all()
    z = out.q[..., 2] - tr.ground_height[:, None]
    assert float(z.min()) > 0.2 and float(z.max()) < 0.45, (float(z.min()), float(z.max()))
    with pytest.raises(ValueError, match="payloads for 2 envs"):
        rollout(x0, v_des, randomize_payload(spec, gen(13), 3))
