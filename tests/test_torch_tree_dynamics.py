"""The generic tree dynamics (``models/tree_dynamics.py``), the oracle of the
structured dynamics, on the CPU.

- The port's tree against the JAX package's tree, Go2 and Solo12, at three
  random states each: ``tests/data/tree_dynamics_golden.npz``
  (``scripts/make_torch_tree_golden.py``; the JAX recursions compile for
  about a minute, so they are stored).
- The port's structured dynamics (``models/dynamics.py``) against the
  port's tree at the tolerances of ``tests/test_structured_dynamics.py``.
- Kernel 1's plain twin (``ops.dyncore.dyncore_plain``: p_feet, v_feet,
  tau in fp32) against the tree in float64 at 256 random states, at the
  bounds ``chip_smoke.py`` phase 29 holds the kernel to on the card.
- Leading batch dims, and float64 from a float32 spec.

~2 s of worker time; no JAX compile.
"""
import os

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.models import dynamics as fast
from iterative_learning_nmpc_tpu_torch.models import tree_dynamics as tree
from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore_plain
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "tree_dynamics_golden.npz")
SPECS = {"go2": go2_spec, "solo12": solo12_spec}
# (atol, rtol) of tests/test_structured_dynamics.py for each quantity
KINEMATIC = (1e-5, 0.0)
FORCE = (2e-3, 2e-4)


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def inputs(g, robot):
    return [torch.as_tensor(g[f"{robot}_{k}"]) for k in ("q", "v", "a", "f", "tau")]


def tree_outputs(spec, q, v, a, f, tau):
    R, p = tree.fk_pos(spec, q)
    fk = tree.fk_vel(spec, q, v)
    return dict(
        fk_R=R, fk_p=p, fk_w=fk.w, fk_vlin=fk.vlin,
        foot_positions=tree.foot_positions(spec, q),
        foot_velocities=tree.foot_velocities(spec, q, v),
        foot_jacobians=tree.foot_jacobians(spec, q),
        rnea=tree.rnea(spec, q, v, a, f_ext_feet=f),
        bias_forces=tree.bias_forces(spec, q, v),
        mass_matrix=tree.mass_matrix(spec, q),
        id_torques=tree.id_torques(spec, q, v, a, f),
        com_position=tree.com_position(spec, q),
        centroidal_momentum=tree.centroidal_momentum(spec, q, v),
        centroidal_momentum_rate=tree.centroidal_momentum_rate(spec, q, v, a),
        contact_wrench_about_com=tree.contact_wrench_about_com(spec, q, f),
        forward_dynamics=tree.forward_dynamics(spec, q, v, tau, f_ext_feet=f))


# the quantities in metres, rad or rad/s (and Jacobians) against the forces,
# torques, momenta and accelerations
TOL = dict(fk_R=KINEMATIC, fk_p=KINEMATIC, fk_w=KINEMATIC, fk_vlin=KINEMATIC,
           foot_positions=KINEMATIC, foot_velocities=KINEMATIC, foot_jacobians=KINEMATIC,
           com_position=KINEMATIC, rnea=FORCE, bias_forces=FORCE, mass_matrix=FORCE,
           id_torques=FORCE, centroidal_momentum=FORCE, centroidal_momentum_rate=(5e-2, 5e-3),
           contact_wrench_about_com=FORCE, forward_dynamics=(2e-2, 1e-3))


@pytest.mark.parametrize("robot", ["go2", "solo12"])
def test_tree_matches_jax_tree(g, robot):
    spec = SPECS[robot](device="cpu")
    out = tree_outputs(spec, *inputs(g, robot))
    for name, (atol, rtol) in TOL.items():
        np.testing.assert_allclose(out[name].numpy(), g[f"{robot}_{name}"], atol=atol,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("robot", ["go2", "solo12"])
def test_structured_matches_tree(g, robot):
    """tests/test_structured_dynamics.py on the port's two dynamics."""
    spec = SPECS[robot](device="cpu")
    q, v, a, f, tau = inputs(g, robot)
    pairs = dict(
        foot_positions=(fast.foot_positions(spec, q), tree.foot_positions(spec, q)),
        foot_velocities=(fast.foot_velocities(spec, q, v), tree.foot_velocities(spec, q, v)),
        rnea=(fast.rnea(spec, q, v, a, f_ext_feet=f), tree.rnea(spec, q, v, a, f_ext_feet=f)),
        mass_matrix=(fast.mass_matrix(spec, q), tree.mass_matrix(spec, q)),
        centroidal_momentum=(fast.centroidal_momentum(spec, q, v),
                             tree.centroidal_momentum(spec, q, v)),
        com_position=(fast.com_position(spec, q), tree.com_position(spec, q)),
        centroidal_momentum_rate=(fast.centroidal_momentum_rate(spec, q, v, a),
                                  tree.centroidal_momentum_rate(spec, q, v, a)),
        foot_jacobians=(fast.foot_jacobians(spec, q), tree.foot_jacobians(spec, q)),
        contact_wrench_about_com=(fast.contact_wrench_about_com(spec, q, f),
                                  tree.contact_wrench_about_com(spec, q, f)),
        forward_dynamics=(fast.forward_dynamics(spec, q, v, tau, f_ext_feet=f),
                          tree.forward_dynamics(spec, q, v, tau, f_ext_feet=f)))
    for name, (x, y) in pairs.items():
        atol, rtol = TOL[name]
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol, rtol=rtol, err_msg=name)


def random_states(spec, n, seed):
    """n states drawn as tests/test_structured_dynamics.py draws them."""
    rng = np.random.default_rng(seed)
    q = np.repeat(spec.q_home.numpy()[None].astype(np.float64), n, 0)
    q[:, :3] += rng.uniform(-0.5, 0.5, (n, 3))
    q[:, 3:6] = rng.uniform(-0.4, 0.4, (n, 3))
    q[:, 6:] += rng.uniform(-0.4, 0.4, (n, spec.nu))
    return (q, rng.uniform(-1.5, 1.5, (n, spec.nv)), rng.uniform(-6.0, 6.0, (n, spec.nv)),
            rng.uniform(-40.0, 40.0, (n, 4, 3)))


@pytest.mark.parametrize("robot", ["go2", "solo12"])
def test_kernel_one_twin_against_float64_tree(robot):
    """dyncore_plain's [p_feet, v_feet, tau] (fp32) against the tree in
    float64: p, v within 1e-5, tau within rtol 2e-4, atol 2e-3."""
    spec = SPECS[robot](device="cpu")
    q, v, a, f = random_states(spec, 256, seed=1)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    out = dyncore_plain(spec, torch.cat([f32(q), f32(v)], 1), f32(a), f32(f).reshape(-1, 12))
    q64, v64, a64, f64 = (torch.as_tensor(np.asarray(x, np.float32), dtype=torch.float64)
                          for x in (q, v, a, f))
    ref = torch.cat([tree.foot_positions(spec, q64).reshape(-1, 12),
                     tree.foot_velocities(spec, q64, v64).reshape(-1, 12),
                     tree.rnea(spec, q64, v64, a64, f_ext_feet=f64)], 1)
    assert ref.dtype == torch.float64
    np.testing.assert_allclose(out[:, :24].numpy(), ref[:, :24].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[:, 24:].numpy(), ref[:, 24:].numpy(), atol=2e-3, rtol=2e-4)


def test_leading_batch_dims():
    spec = go2_spec(device="cpu")
    q, v, a, f = (torch.as_tensor(x, dtype=torch.float64) for x in random_states(spec, 6, 2))
    q2, v2, a2, f2 = (x.reshape((2, 3) + x.shape[1:]) for x in (q, v, a, f))
    tau = tree.rnea(spec, q2, v2, a2, f_ext_feet=f2)
    M = tree.mass_matrix(spec, q2)
    assert tau.shape == (2, 3, 18) and M.shape == (2, 3, 18, 18) and tau.dtype == torch.float64
    for i in range(6):
        b = divmod(i, 3)
        assert torch.allclose(tau[b], tree.rnea(spec, q[i], v[i], a[i], f_ext_feet=f[i]),
                              rtol=1e-12, atol=1e-10)
        assert torch.allclose(M[b], tree.mass_matrix(spec, q[i]), rtol=1e-12, atol=1e-12)
    # symmetric positive definite
    assert torch.allclose(M, M.transpose(-1, -2), atol=1e-10)
    assert bool((torch.linalg.eigvalsh(M) > 0).all())
