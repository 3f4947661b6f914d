"""``riccati_mode="associative"`` (``solver/parallel_riccati.py``) and the
generic sweep (``solver/sqp.riccati_solve`` / ``forward_delta``) against the
JAX package, on the CPU.

- float64: the port's ``parallel_riccati`` against the JAX package's on the
  random LQR blocks of ``tests/test_parallel_riccati.py``
  (``jax_enable_x64`` switched on and back in ``try/finally``), to 1e-6,
  and the port's ``riccati_solve`` against it to 1e-8, as the JAX
  package's sequential and associative sweeps agree;
- fp32: the JAX package's envelope of the associative scan against the
  sequential sweep (2e-2 of the gains' largest entry) on its OCP-scale
  blocks and on the port's Gauss-Newton blocks around the golden converged
  trot (``tests/data/go2_trot_n25_golden.npz``, x0 perturbed as the main
  path's chain perturbs it), to 1e-6 in float64;
- the suffix scan against a left fold of the composition;
- the generic sweep and rollout against the structured ones
  (``tests/test_solver.py::test_structured_riccati_matches_generic``);
- the associative mode with the time-optimal one refused.

~8 s of worker time; one JAX compile (the JAX ``parallel_riccati``).
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.solver.parallel_riccati import parallel_riccati as jax_par
from iterative_learning_nmpc_tpu_torch import flagship as F
from iterative_learning_nmpc_tpu_torch.interop import warm_start_from_numpy
from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram
from iterative_learning_nmpc_tpu_torch.ops.riccati import (
    forward_delta_structured, riccati_sweep_structured, terminal_gram)
from iterative_learning_nmpc_tpu_torch.solver.linearize import lingram_structured
from iterative_learning_nmpc_tpu_torch.solver.parallel_riccati import (
    _compose, parallel_riccati, suffix_scan)
from iterative_learning_nmpc_tpu_torch.solver.sqp import (
    TrajOptSolver, forward_delta, riccati_solve)

from test_parallel_riccati import _random_lqr

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def batch1(args):
    """Unbatched blocks (the JAX package's) -> the port's batch of one;
    the constant A, B stay 2-D."""
    A, B, *rest = (torch.as_tensor(np.asarray(a)) for a in args)
    return (A, B, *(t[None] for t in rest))


@pytest.fixture(scope="module")
def jax_par64():
    """The JAX package's parallel_riccati, jitted once for both seeds."""
    return jax.jit(jax_par)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_float64(seed, jax_par64):
    jax.config.update("jax_enable_x64", True)
    try:
        args = _random_lqr(np.random.default_rng(seed), dtype=jnp.float64)
        K_par, k_par = (np.asarray(a) for a in jax_par64(*args, jnp.asarray(1e-8, jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    tb = batch1(args)
    assert tb[2].dtype == torch.float64
    K, k = parallel_riccati(*tb, 1e-8)
    np.testing.assert_allclose(K[0].numpy(), K_par, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(k[0].numpy(), k_par, rtol=1e-6, atol=1e-6)
    # the generic sweep, the oracle of both, as the JAX package's agree (1e-8)
    Kg, kg = riccati_solve(*tb, 1e-8)
    np.testing.assert_allclose(Kg.numpy(), K.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(kg.numpy(), k.numpy(), rtol=1e-8, atol=1e-8)


def test_fp32_ocp_scale():
    """tests/test_parallel_riccati.py::test_fp32_ocp_scale's blocks and
    envelope, on the port's two sweeps."""
    N, nx = 25, 36
    r = np.random.default_rng(3)
    A = np.eye(nx) + 0.04 * np.diag(np.ones(nx))
    B = np.concatenate([0.04 * r.normal(size=(nx, 18)), np.zeros((nx, 12))], axis=1)

    def spd(n, scales):
        W = r.normal(size=(N, n, n)) * scales
        return np.einsum("nij,nkj->nik", W, W) + 1e-2 * np.eye(n)

    Q, R = spd(nx, 10.0), spd(30, 2.0)
    M = r.normal(size=(N, nx, 30))
    qx, ru = 100 * r.normal(size=(N, nx)), 10 * r.normal(size=(N, 30))
    d = 0.01 * r.normal(size=(N, nx))
    W0 = r.normal(size=(nx, nx)) * 10
    P_N, p_N = W0 @ W0.T + np.eye(nx), r.normal(size=nx)
    tb = batch1([np.asarray(a, np.float32) for a in (A, B, Q, R, M, qx, ru, P_N, p_N, d)])
    K_seq, k_seq = riccati_solve(*tb, 1e-6)
    K_par, k_par = parallel_riccati(*tb, 1e-6)
    assert float((K_par - K_seq).abs().max()) < 2e-2 * float(K_seq.abs().max())
    assert float((k_par - k_seq).abs().max()) < 2e-2 * float(k_seq.abs().max())


@pytest.fixture(scope="module")
def gn_case():
    """The port's GN blocks, terminal Gram and defects of a batch of four
    around the golden converged trot (N = 25): x0 perturbed as the main
    path's chain perturbs it (``flagship.perturbed_batch``, std 0.01)."""
    g = np.load(os.path.join(DATA, "go2_trot_n25_golden.npz"))
    solver, _, _, p = F.flagship(device="cpu")
    X, U, _, li = warm_start_from_numpy(g["X_conv"], g["U_conv"], g["U_conv"][:, :18],
                                        g["lam_ineq_conv"], device="cpu")
    X, U, p = F.perturbed_batch(X, U, p.replace(lam_ineq=li), 4, seed=0)
    blocks = lingram_structured(solver.spec, solver.weights, X, U, p)
    P_N, p_N = terminal_gram(solver.spec, solver.weights, float(solver.cost.reg_eps_e),
                             X[:, -1], p.peak[:, :, -1], p.base_ref_e, p.joint_ref,
                             p.step_height)
    return solver, blocks, P_N, p_N, solver._defects(X, U, p), p.x0 - X[:, 0], (X, U, p)


def per_problem(a, b):
    """max |a - b| over max |b|, each problem (leading dim) alone."""
    dims = tuple(range(1, a.dim()))
    return ((a - b).abs().amax(dims) / b.abs().amax(dims)).max().item()


def test_envelope_on_gn_blocks(gn_case):
    """The JAX package's fp32 envelope of the associative gains against the
    sequential ones (2e-2 of the largest entry, each problem), on the
    solver's blocks; in float64 the two agree to 1e-6."""
    solver, blocks, P_N, p_N, d, *_ = gn_case
    h, lm = solver.dt_nodes, float(solver.opt.lm_reg)
    for dtype, tol in ((torch.float32, 2e-2), (torch.float64, 1e-6)):
        c = lambda t: t.to(dtype)
        args = (*map(c, blocks), c(P_N), c(p_N), c(d))
        K_s, k_s = riccati_sweep_structured(h, *args, lm)
        K_p, k_p = parallel_riccati(c(solver.A), c(solver.B), *args, lm)
        assert per_problem(K_p, K_s) <= tol, dtype
        assert per_problem(k_p, k_s) <= tol, dtype


@pytest.mark.parametrize("n", [1, 2, 5, 26, 27])
def test_suffix_scan_is_the_fold(gn_case, n):
    """out[k] = e_k * ... * e_last for the non-commutative composition,
    random float64 elements (J symmetric, shifted by the solver's Q), at
    lengths that take every branch of the tree."""
    blocks = gn_case[1]
    rng = np.random.default_rng(n)
    nx = 36
    A = torch.eye(nx, dtype=torch.float64) + 0.05 * torch.as_tensor(rng.normal(size=(n, nx, nx)))
    b = torch.as_tensor(rng.normal(size=(n, nx)))
    W = torch.as_tensor(rng.normal(size=(n, nx, 8)))
    C = W @ W.transpose(1, 2)
    eta = torch.as_tensor(rng.normal(size=(n, nx)))
    W2 = torch.as_tensor(rng.normal(size=(n, nx, nx)))
    J = W2 @ W2.transpose(1, 2) / nx + blocks[0][0, :1].double() * 1e-6
    elems = tuple(t[None] for t in (A, b, C, eta, J))
    out = suffix_scan(elems, axis=1)
    for k in range(n):
        acc = tuple(t[:, n - 1] for t in elems)
        for j in range(n - 2, k - 1, -1):
            acc = _compose(tuple(t[:, j] for t in elems), acc)
        for a, o in zip(acc, out):
            assert float((a - o[:, k]).abs().max()) <= 1e-9 * max(1.0, float(a.abs().max()))


def test_generic_sweep_matches_structured(gn_case):
    """tests/test_solver.py::test_structured_riccati_matches_generic, on
    the port's two sweeps and rollouts (here at alpha = 1)."""
    solver = gn_case[0]
    N, nx, nu = solver.N, 36, 30
    rng = np.random.RandomState(7)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    Jq, Jr = mk(N, 50, nx), mk(N, 50, nu)
    Q = np.einsum("nri,nrj->nij", Jq, Jq) + 1e-3 * np.eye(nx, dtype=np.float32)
    R = np.einsum("nri,nrj->nij", Jr, Jr) + 1.0 * np.eye(nu, dtype=np.float32)
    M = 0.1 * np.einsum("nri,nrj->nij", Jq, Jr)
    qx, ru = mk(N, nx), mk(N, nu)
    PT = mk(60, nx)
    P_N = PT.T @ PT + np.eye(nx, dtype=np.float32)
    p_N, d = mk(nx), 0.01 * mk(N, nx)
    t = lambda a: torch.as_tensor(a)[None]
    args = (t(Q), t(R), t(M), t(qx), t(ru), t(P_N), t(p_N), t(d))
    K0, k0 = riccati_solve(solver.A, solver.B, *args, 1e-6)
    K1, k1 = riccati_sweep_structured(solver.dt_nodes, *args, 1e-6)
    assert float((K1 - K0).abs().max()) <= 2e-3 * float(K0.abs().max())
    assert float((k1 - k0).abs().max()) <= 2e-3 * max(1.0, float(k0.abs().max()))
    dx0 = t(mk(nx))
    dX0, dU0 = forward_delta(solver.A, solver.B, K0, k0, t(d), dx0)
    dX1, dU1 = forward_delta_structured(solver.dt_nodes, K0, k0, t(d), dx0)
    np.testing.assert_allclose(dX1.numpy(), dX0.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dU1.numpy(), dU0.numpy(), atol=1e-4, rtol=1e-4)
    # per-node A/B repeated from the constant ones: the same sweep
    An = solver.A.expand(1, N, nx, nx)
    Bn = solver.B.expand(1, N, nx, nu)
    K2, k2 = riccati_solve(An, Bn, *args, 1e-6)
    assert torch.equal(K2, K0) and torch.equal(k2, k0)


def test_associative_step_is_in_the_envelope(gn_case):
    """One solver step by the associative route (dynjac blocks, the
    generic rollout) against the sequential route's."""
    solver, blocks, P_N, p_N, d, dx0, (X, U, p) = gn_case
    opt = dataclasses.replace(solver.opt, riccati_mode="associative")
    assoc = TrajOptSolver(solver.spec, opt, solver.cost, device="cpu")
    seq = TrajOptSolver(solver.spec, dataclasses.replace(opt, riccati_mode="sequential"),
                        solver.cost, device="cpu")
    dX_a, dU_a, _ = assoc.gn_step(X, U, p)
    dX_s, dU_s, _ = seq.gn_step(X, U, p)
    assert bool(torch.isfinite(dU_a).all())
    assert per_problem(dU_a, dU_s) <= 2e-2
    # the batch route's blocks (kernel 2's plain twin on the CPU)
    blocks = lingram(solver.spec, solver.weights, X, U, p)
    K, kff = parallel_riccati(solver.A, solver.B, *blocks, P_N, p_N, d, float(opt.lm_reg))
    dX, dU = forward_delta(solver.A, solver.B, K, kff, d, dx0)
    assert torch.equal(dU, dU_a) and torch.equal(dX, dX_a)


def test_associative_with_time_opt_raises():
    solver, _, _, _ = F.flagship(device="cpu", n_nodes=4)
    opt = dataclasses.replace(solver.opt, riccati_mode="associative", enable_time_opt=True)
    with pytest.raises(ValueError, match="associative"):
        TrajOptSolver(solver.spec, opt, solver.cost, device="cpu")
    A = solver.A.expand(4, 36, 36)
    z = lambda *s: torch.zeros(1, *s)
    with pytest.raises(ValueError, match="constant"):
        parallel_riccati(A, solver.B, z(4, 36, 36), z(4, 30, 30), z(4, 36, 30), z(4, 36),
                         z(4, 30), z(36, 36), z(36), z(4, 36), 1e-6)
