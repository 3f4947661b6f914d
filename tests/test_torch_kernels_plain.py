"""Each kernel module's plain PyTorch twin against the JAX package's plain
XLA path (never a Pallas kernel). The CUDA kernels against the twins on a
GPU: tests/test_torch_cuda_kernels.py.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _flagship
from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.solver import sqp as jsqp
from iterative_learning_nmpc_tpu_torch.interop import (
    params_from_numpy, spec_from_numpy, weights_from_numpy)
from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore, dyncore_plain
from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram, lingram_plain
from iterative_learning_nmpc_tpu_torch.ops.riccati import (
    riccati_rollout, riccati_rollout_plain, terminal_gram)

from test_torch_ocp import make_case

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "go2_trot_n25_golden.npz")
N, B = 6, 3
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)


def _jax_gram(spec, w, X, U, p, include_torque):
    """GN blocks of the JAX plain path: jacfwd stage Jacobians + einsum Gram
    (the oracle of tests/test_fast_linearize.py)."""
    r0, Jx0, Ju0 = jax.vmap(lambda X_, U_, p_: jsqp._linearize_stages(
        spec, w, X_, U_, p_, include_torque=include_torque))(X, U, p)
    return (jnp.einsum("bnri,bnrj->bnij", Jx0, Jx0),
            jnp.einsum("bnri,bnrj->bnij", Ju0, Ju0),
            jnp.einsum("bnri,bnrj->bnij", Jx0, Ju0),
            jnp.einsum("bnri,bnr->bni", Jx0, r0),
            jnp.einsum("bnri,bnr->bni", Ju0, r0))


def test_dyncore_plain_matches_jax_dynamics():
    js = _flagship(n_nodes=N)[0].spec
    spec = spec_from_numpy(js, device="cpu")
    rng = np.random.default_rng(11)
    M = 40
    X = np.concatenate([np.asarray(js.q_home)[None] + 0.3 * rng.standard_normal((M, 18)),
                        rng.standard_normal((M, 18))], 1).astype(np.float32)
    A = (3.0 * rng.standard_normal((M, 18))).astype(np.float32)
    Fe = (30.0 * rng.standard_normal((M, 12))).astype(np.float32)

    def one(x, a, f):
        q, v = x[:18], x[18:]
        return jnp.concatenate([jdyn.foot_positions(js, q).reshape(12),
                                jdyn.foot_velocities(js, q, v).reshape(12),
                                jdyn.rnea(js, q, v, a, f.reshape(4, 3))])

    ref = np.asarray(jax.jit(jax.vmap(one))(X, A, Fe))
    args = (spec, torch.as_tensor(X), torch.as_tensor(A), torch.as_tensor(Fe))
    out = dyncore_plain(*args)
    assert out.shape == (M, 42)
    # CPU tensors dispatch to the twin: identical by construction
    assert torch.equal(dyncore(*args), out)
    # fp32 reassociation between the packages: 1e-5 of the output scale
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def gram_case():
    """The every-row-group case of test_torch_ocp.py and its JAX Grams for
    both torque settings, compiled together once."""
    solver, X, U, pb = make_case()
    refs = jax.jit(lambda X_, U_, p_: tuple(
        _jax_gram(solver.spec, solver.weights, X_, U_, p_, inc)
        for inc in (True, False)))(X, U, pb)
    return solver, X, U, pb, dict(zip((True, False), refs))


@pytest.mark.parametrize("include_torque", [True, False])
def test_lingram_plain_matches_jacfwd_gram(gram_case, include_torque):
    solver, X, U, pb, refs = gram_case
    spec = spec_from_numpy(solver.spec, device="cpu")
    w = weights_from_numpy(solver.weights, device="cpu")
    tp = params_from_numpy(pb, device="cpu")
    Xt, Ut = torch.as_tensor(X), torch.as_tensor(U)
    out = lingram_plain(spec, w, Xt, Ut, tp, include_torque)
    for a, b in zip(lingram(spec, w, Xt, Ut, tp, include_torque), out):
        assert torch.equal(a, b)                 # CPU tensors take the twin
    for name, a, b in zip(("Q", "R", "M", "qx", "ru"), out, refs[include_torque]):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        # tests/test_fast_linearize.py's Gram bound: fp32 sums of products
        # over 142 rows whose weights span 1e-3..1e3
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=3e-4 * scale,
                                   err_msg=f"{name} include_torque={include_torque}")


@pytest.fixture(scope="module")
def riccati_case():
    """The golden converged flagship trajectory (N=25) with small
    per-problem state perturbations: a well-conditioned fp32 step, as in
    the RTI regime (a step from far away, e.g. a cold start, moves fp32
    results of either package by ~1e-2 against fp64)."""
    solver, _, _, p1 = _flagship()
    g = np.load(GOLDEN)
    rng = np.random.default_rng(5)
    X = np.repeat(g["X_conv"][None], B, 0)
    X[:, 1:] += (5e-4 * rng.standard_normal(X[:, 1:].shape)).astype(np.float32)
    U = np.repeat(g["U_conv"][None], B, 0)
    pb = jax.tree.map(lambda x: np.repeat(np.asarray(x)[None], B, 0), p1)
    pb = pb.__class__(**{**pb.__dict__, "lam_ineq": np.repeat(
        g["lam_ineq_conv"][None], B, 0)})
    return solver, X.astype(np.float32), U, pb


def test_riccati_rollout_plain_matches_structured_sweep(riccati_case):
    solver, X, U, pb = riccati_case
    js, jw = solver.spec, solver.weights
    h, lm, reg = solver.dt_nodes, float(solver.opt.lm_reg), float(solver.cost.reg_eps_e)

    spec, w = spec_from_numpy(js, device="cpu"), weights_from_numpy(jw, device="cpu")
    tp = params_from_numpy(pb, device="cpu")
    # the same GN blocks (the port's plain Gram) go into both sweeps
    blocks = lingram_plain(spec, w, torch.as_tensor(X), torch.as_tensor(U), tp)

    @jax.jit
    def jax_step(X, U, p, Q, R, M, qx, ru):
        def one(X_, U_, p_, Q_, R_, M_, qx_, ru_):
            rT, JT = jsqp._linearize_terminal(js, jw, X_[-1], p_)
            P_N = JT.T @ JT + reg * jnp.eye(36)
            p_N = JT.T @ rT
            d = solver._defects(X_, U_, p_)
            K, kff = jsqp._riccati_solve_structured(h, Q_, R_, M_, qx_, ru_, P_N, p_N,
                                                   d, jnp.float32(lm))
            dX, dU = jsqp._forward_delta_structured(h, K, kff, d, p_.x0 - X_[0],
                                                    jnp.float32(1.0))
            return P_N, p_N, d, dX, dU

        return jax.vmap(one)(X, U, p, Q, R, M, qx, ru)

    P_N0, p_N0, d0, dX0, dU0 = jax_step(X, U, pb, *(b.numpy() for b in blocks))
    xN = torch.as_tensor(X[:, -1])
    P_N, p_N = terminal_gram(spec, w, reg, xN, tp.peak[:, :, -1], tp.base_ref_e,
                             tp.joint_ref, tp.step_height)
    # terminal Gram: fp32 products of the same foot Jacobians, 1e-5 of scale
    for a, b in ((P_N, P_N0), (p_N, p_N0)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(b).max())))
    args = (spec, w, h, lm, reg, *blocks, torch.as_tensor(np.array(d0)),
            tp.x0 - torch.as_tensor(X[:, 0]), xN, tp.peak[:, :, -1],
            tp.base_ref_e, tp.joint_ref, tp.step_height)
    dX, dU = riccati_rollout_plain(*args)
    for a, b in zip(riccati_rollout(*args), (dX, dU)):
        assert torch.equal(a, b)                 # CPU tensors take the twin
    # the bench's rel |dU| / (1 + |dU|) gate, on the step itself
    for name, a, b in (("dX", dX, dX0), ("dU", dU, dU0)):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.max(np.abs(a.numpy() - b) / (1.0 + np.abs(b)))) <= 1e-3, name
