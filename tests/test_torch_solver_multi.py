"""The port's multi-iteration solve against the JAX package, and the port's
plain path against the golden JAX-on-CPU flagship solution that
``chip_smoke.py`` holds the GPU kernels to (scripts/make_torch_golden.py).
"""
import json
import os

import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu_torch import flagship as tflag
from iterative_learning_nmpc_tpu_torch.interop import (
    params_from_numpy, warm_start_from_numpy)

from test_torch_solver import near_converged_batch, rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_trot_n25_golden.npz")
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def converged():
    """The converged N=6 flagship trajectory for two problems (one port
    solve serves both tests that use it; each test copies the arrays)."""
    return near_converged_batch(6, 2, seed=2)


def _copy(converged):
    jsol, tsol, X, U, pb, rng = converged
    return jsol, tsol, X.copy(), U.copy(), jax.tree.map(np.copy, pb), rng


def test_three_iteration_solve_matches_jax(converged):
    """n_iter=3 (full line-search set, outer nlp_tol exit) from the
    converged N=6 trajectory with the initial joint angles moved by 0.01 rad
    (per problem): all three iterations run and contract the step."""
    jsol, tsol, X, U, pb, rng = _copy(converged)
    shift = (0.01 * rng.standard_normal((2, 12))).astype(np.float32)
    pb.x0[:, 6:18] += shift
    X[:, 0, 6:18] += shift
    js = jax.jit(jax.vmap(lambda x, u, p: jsol.solve(x, u, p, 3)))(X, U, pb)
    ts = tsol.solve(torch.as_tensor(X), torch.as_tensor(U),
                    params_from_numpy(pb, device="cpu"), 3)
    np.testing.assert_array_equal(ts.stats.sqp_iters.numpy(), np.asarray(js.stats.sqp_iters))
    assert int(ts.stats.sqp_iters.min()) > 1
    np.testing.assert_array_equal(ts.stats.qp_iters.numpy(), np.asarray(js.stats.qp_iters))
    for b in range(2):
        # the bench's gate; 1.3e-4 measured between the port in fp32 and fp64
        assert rel(ts.U[b], js.U[b]) <= 1e-3, b
        assert rel(ts.X[b], js.X[b]) <= 1e-3, b
    np.testing.assert_allclose(ts.lam_ineq.numpy(), np.asarray(js.lam_ineq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.stats.cost.numpy(), np.asarray(js.stats.cost), rtol=1e-4)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_plain_path_matches_golden_flagship(golden):
    """Plain path on the CPU, Go2 trot N=25: the flagship instance, its
    15-iteration converged solve (cost in the BENCH_ANCHOR.json band) and
    one RTI step from the golden converged point, against the JAX solve."""
    solver, X, U, params = tflag.flagship(device="cpu")
    # the port rebuilds the same instance: fp32 FK of the standing pose
    np.testing.assert_allclose(params.x0[0].numpy(), golden["x0"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(params.cnt[0].numpy(), golden["cnt"])
    np.testing.assert_allclose(U[0].numpy(), golden["U_cold"], rtol=0, atol=1e-4)

    conv = solver.solve(X, U, params, 15)
    with open(os.path.join(ROOT, "BENCH_ANCHOR.json")) as f:
        anchor = json.load(f)
    cost = float(conv.stats.cost[0])
    assert abs(cost / anchor["converged_cost_cpu"] - 1.0) <= anchor["tol_rel"]
    assert rel(conv.U[0], golden["U_conv"]) <= 1e-3     # the bench's gate

    Xg, Ug, _, lig = warm_start_from_numpy(golden["X_conv"], golden["U_conv"],
                                           golden["U_conv"][:, :18],
                                           golden["lam_ineq_conv"], device="cpu")
    rti = solver.solve(Xg, Ug, params.replace(lam_ineq=lig), 1)
    assert rel(rti.U[0], golden["U_rti"]) <= 1e-3
    assert rel(rti.X[0], golden["X_rti"]) <= 1e-3
    np.testing.assert_allclose(rti.lam_ineq[0].numpy(), golden["lam_ineq_rti"], rtol=0, atol=1e-5)
    # r_eq: w_dyn (~31.6) times ~150 N base forces, see test_torch_solver.py
    np.testing.assert_allclose(rti.r_eq[0].numpy(), golden["r_eq_rti"], rtol=0, atol=5e-3)


def test_warm_start_helpers_match_jax(converged):
    """cold_start, shift_warmstart and shift_multipliers on a batch of two
    problems with different contact schedules: exact index/mask semantics."""
    jsol, tsol, X, U, pb, rng = _copy(converged)
    pb.cnt[1] = (rng.random(pb.cnt[1].shape) > 0.5).astype(np.float32)
    lam = rng.standard_normal(pb.lam_eq.shape).astype(np.float32)
    jX0, jU0 = jax.vmap(jsol.cold_start)(pb)
    tX0, tU0 = tsol.cold_start(params_from_numpy(pb, device="cpu"))
    # fz = g * m_total / n_active: fp32, the mass sum reassociated
    np.testing.assert_allclose(tU0.numpy(), np.asarray(jU0), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tX0.numpy(), np.asarray(jX0))
    for shift in (0, 1, 3, 9):
        jX, jU = jax.vmap(lambda x, u: jsol.shift_warmstart(x, u, shift))(X, U)
        tX, tU = tsol.shift_warmstart(torch.as_tensor(X), torch.as_tensor(U), shift)
        np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
        np.testing.assert_array_equal(tU.numpy(), np.asarray(jU))
        jl = jax.vmap(lambda l: jsol.shift_multipliers(l, shift))(lam)
        np.testing.assert_array_equal(tsol.shift_multipliers(torch.as_tensor(lam), shift).numpy(),
                                      np.asarray(jl))
