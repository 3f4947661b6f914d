"""The port's dynjac twin and its structured Gram against the JAX package.

- ``dynjac_plain`` (torch.func.jacfwd of the FK/RNEA core) against the JAX
  ``jax.jacfwd`` oracle of tests/test_dynjac_kernel.py, at its M=9 inputs
  and bounds.
- ``solver.linearize.lingram_structured`` (the single-problem route of the
  solver, built on ``ops.dynjac``) against the JAX jacfwd-path Gram
  (``solver/sqp.py`` ``_linearize_stages`` + einsum) and against the port's
  ``lingram_plain``, at B=2, N=25, with every row group active and stance
  feet carrying exactly zero force (the hinge's tie at g == 0).

No interpret-mode Pallas: the JAX side is its jacfwd path on XLA-CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.solver import sqp as jsqp
from iterative_learning_nmpc_tpu_torch.interop import (
    params_from_numpy, spec_from_numpy, weights_from_numpy)
from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac, dynjac_plain
from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram_plain
from iterative_learning_nmpc_tpu_torch.solver.linearize import lingram_structured

from test_torch_kernels_plain import _jax_gram

N, B = 25, 2
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)


def _jax_oracle(spec, X, A, Fe):
    """jacfwd of [p_feet, v_feet, tau] with respect to (x, a), f fixed."""
    def core(x, a, fe):
        def f(xa):
            q, v = xa[:18], xa[18:36]
            return jnp.concatenate([
                jdyn.foot_positions(spec, q).reshape(-1),
                jdyn.foot_velocities(spec, q, v).reshape(-1),
                jdyn.rnea(spec, q, v, xa[36:], f_ext_feet=fe.reshape(4, 3))])
        za = jnp.concatenate([x, a])
        return f(za), jax.jacfwd(f)(za)
    return jax.jit(jax.vmap(core))(X, A, Fe)


def test_dynjac_plain_matches_jax_jacfwd():
    js = jax_go2()
    rng = np.random.RandomState(5)
    M = 9
    q0 = np.asarray(js.q_home, np.float32)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None], (M, 1))
    X += 0.2 * rng.randn(M, 36).astype(np.float32)
    A = (2.0 * rng.randn(M, 18)).astype(np.float32)
    Fe = (20.0 * rng.randn(M, 12)).astype(np.float32)
    prim0, J0 = (np.asarray(t) for t in _jax_oracle(js, X, A, Fe))

    spec = spec_from_numpy(js, device="cpu")
    args = (spec, torch.as_tensor(X), torch.as_tensor(A), torch.as_tensor(Fe))
    prim, J = dynjac_plain(*args)
    assert prim.shape == (M, 42) and J.shape == (M, 42, 54)
    # tests/test_dynjac_kernel.py's bounds
    np.testing.assert_allclose(prim.numpy(), prim0, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(J.numpy(), J0, rtol=0, atol=3e-5 * float(np.abs(J0).max()))
    # CPU tensors take the twin: identical, and no kernel launch is counted
    n0 = dynjac.launches
    pk, Jk = dynjac(*args)
    assert torch.equal(pk, prim) and torch.equal(Jk, J) and dynjac.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        dynjac(spec, *(t.to("meta") for t in args[1:]))


def _gram_case(seed: int = 4):
    """(JAX solver, X (B,N+1,36), U (B,N,30), batched numpy OCPParams): the
    every-row-group case of tests/test_torch_ocp.py at N=25, where some
    stance feet carry exactly zero force (the friction-cone rows then sit at
    g == 0, as after a contact switch in the controller's warm start)."""
    _, opt, cost = get_quadruped_config("trot", "go2")
    solver = jsqp.TrajOptSolver(jax_go2(), opt, cost)
    rng = np.random.RandomState(seed)
    q0 = np.asarray(solver.spec.q_home, np.float32)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None, None],
                (B, N + 1, 1))
    X += 0.05 * rng.randn(B, N + 1, 36).astype(np.float32)
    U = 0.3 * rng.randn(B, N, 30).astype(np.float32)
    U[:, :, 20::3] += 30.0          # normal forces: cone hinges mix on/off
    ps = []
    for b in range(B):
        cnt = (rng.rand(4, N + 1) > 0.4).astype(np.float32)
        ps.append(jsqp.make_params(
            solver, X[b, 0], cnt,
            cnt_loc=0.3 * rng.randn(4, N + 1, 3).astype(np.float32),
            patch_radius=np.full((4, N + 1), 0.05, np.float32), restrict=1.0,
            lam_eq=0.1 * rng.randn(N, 18).astype(np.float32),
            lam_ineq=0.5 * np.abs(rng.randn(N, 36)).astype(np.float32)
            * (rng.rand(N, 36) > 0.5)))
    pb = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *ps)
    # every third node: stance feet with zero force and no cone shifts
    ties = 0
    for b in range(B):
        for n in range(0, N, 3):
            for i in range(4):
                if pb.cnt[b, i, n] > 0:
                    U[b, n, 18 + 3 * i:21 + 3 * i] = 0.0
                    pb.lam_ineq[b, n, 5 * i:5 * i + 5] = 0.0
                    ties += 1
    assert ties > 10
    return solver, X, U, pb


@pytest.fixture(scope="module")
def gram_case():
    solver, X, U, pb = _gram_case()
    ref = jax.jit(lambda X_, U_, p_: _jax_gram(solver.spec, solver.weights, X_, U_,
                                               p_, True))(X, U, pb)
    spec = spec_from_numpy(solver.spec, device="cpu")
    w = weights_from_numpy(solver.weights, device="cpu")
    return (spec, w, torch.as_tensor(X), torch.as_tensor(U),
            params_from_numpy(pb, device="cpu"), [np.asarray(r) for r in ref])


def test_lingram_structured_matches_jax_jacfwd_gram(gram_case):
    spec, w, X, U, p, ref = gram_case
    n0 = dynjac.launches
    out = lingram_structured(spec, w, X, U, p, include_torque=True)
    assert dynjac.launches == n0                 # CPU: the plain twin
    for name, a, b in zip(("Q", "R", "M", "qx", "ru"), out, ref):
        assert a.shape == b.shape, name
        # tests/test_fast_linearize.py's Gram bound: fp32 sums of products
        # over 142 rows whose weights span 1e-3..1e3
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=3e-4 * max(float(np.abs(b).max()), 1.0),
                                   err_msg=name)
    # the force block of R on its own scale: the cone rows at the zero-force
    # ties (derivative 1/2 of max(g, 0) at g == 0, as jnp.maximum's) live here
    R_ff, R_ff0 = out[1][..., 18:, 18:].numpy(), ref[1][..., 18:, 18:]
    np.testing.assert_allclose(R_ff, R_ff0, rtol=0,
                               atol=3e-4 * max(float(np.abs(R_ff0).max()), 1.0))


@pytest.mark.parametrize("include_torque", [True, False])
def test_lingram_structured_matches_lingram_plain(gram_case, include_torque):
    """The two linearizations of the port: row-group condensation on dynjac
    against the Gram of the jacfwd stage Jacobian (the lingram kernel's
    plain twin), with the same hinge derivative at ties."""
    spec, w, X, U, p, _ = gram_case
    a_blocks = lingram_structured(spec, w, X, U, p, include_torque=include_torque)
    b_blocks = lingram_plain(spec, w, X, U, p, include_torque)
    for name, a, b in zip(("Q", "R", "M", "qx", "ru"), a_blocks, b_blocks):
        # one package, two fp32 orders of the same sums
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=3e-5 * max(float(b.abs().max()), 1.0),
                                   err_msg=name)
