"""``solve(use_fast_linearize=True)``: the structure-assembled stage
Jacobian (``solver/linearize.linearize_stages_fast``, its Gram
``gn_blocks_fast``) on the CPU.

- The constant tracking rows against the JAX package's
  ``make_const_blocks`` (numpy there, no compile).
- (r, Jx, Ju) against the port's jacfwd Jacobian of the stage residual on
  ``tests/test_fast_linearize.py``'s random case (restricted contacts,
  shifted hinges, half the feet in swing), with and without the torque
  rows, at that test's bounds.
- The blocks at the golden converged trot against ``gn_blocks_jacfwd``, and
  at a fixed-dt iterate off it against the JAX package's
  ``linearize_stages_fast`` blocks (``tests/data/
  go2_trot_time_opt_golden.npz``, ``fast_*``).
- One RTI step by ``linearize_mode="jacfwd"`` + ``riccati_mode="pallas"``
  with the fast blocks against the jacfwd step (the kernels' plain twins on
  the CPU), the route it takes, and the routes that ignore the option.

~4 s of worker time; no JAX compile.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config as jax_configs
from iterative_learning_nmpc_tpu.ocp.problem import make_weights as jax_weights
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.solver.linearize import make_const_blocks as jax_const
from iterative_learning_nmpc_tpu_torch import flagship as F
from iterative_learning_nmpc_tpu_torch.interop import warm_start_from_numpy
from iterative_learning_nmpc_tpu_torch.ocp.problem import NX, stage_residual
from iterative_learning_nmpc_tpu_torch.ops import riccati as ric
from iterative_learning_nmpc_tpu_torch.solver import linearize as lin
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver, make_params

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GATE = 1.0e-3


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def block_err(a, b):
    """max |a - b| over max(1, |b|): tests/test_fast_linearize.py's scale."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def test_const_blocks_match_jax():
    _, opt, cost = jax_configs("trot", "go2")
    Jx, Ju = jax_const(jax_weights(opt, cost, jax_go2()))
    solver, *_ = F.flagship(device="cpu", n_nodes=4)
    tJx, tJu = lin.make_const_blocks(solver.weights)
    np.testing.assert_array_equal(tJx.numpy(), Jx)
    np.testing.assert_array_equal(tJu.numpy(), Ju)


@pytest.fixture(scope="module")
def random_case():
    """tests/test_fast_linearize.py's case: numpy RandomState(3)."""
    solver, *_ = F.flagship(device="cpu")
    rng = np.random.RandomState(3)
    N = solver.N
    q0 = solver.spec.q_home.numpy().astype(np.float32)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None], (N + 1, 1))
    X[:, :36] += 0.05 * rng.randn(N + 1, 36).astype(np.float32)
    U = 0.3 * rng.randn(N, 30).astype(np.float32)
    U[:, 20::3] += 30.0
    cnt = (rng.rand(4, N + 1) > 0.4).astype(np.float32)
    p = make_params(solver, X[0], cnt,
                    cnt_loc=0.3 * rng.randn(4, N + 1, 3).astype(np.float32),
                    patch_radius=np.full((4, N + 1), 0.05, np.float32), restrict=1.0,
                    lam_eq=0.1 * rng.randn(N, 18).astype(np.float32),
                    lam_ineq=0.5 * np.abs(rng.randn(N, 36)).astype(np.float32))
    return solver, torch.as_tensor(X)[None], torch.as_tensor(U)[None], p


@pytest.mark.parametrize("include_torque", [False, True])
def test_fast_jacobian_matches_jacfwd(random_case, include_torque):
    solver, X, U, p = random_case
    spec, w, N = solver.spec, solver.weights, solver.N
    r1, Jx1, Ju1 = lin.linearize_stages_fast(spec, w, X, U, p, *solver._jac_const,
                                             include_torque=include_torque)
    nv = {k: t.reshape((N,) + t.shape[2:]) for k, t in lin.node_view(p, N).items()}
    Z = torch.cat([X[0, :-1], U[0]], 1)

    def res(z, kw):
        return stage_residual(spec, w, z[..., :NX], z[..., NX:],
                              include_torque=include_torque, **kw)

    J0 = torch.func.vmap(torch.func.jacfwd(res))(Z, nv)
    r0 = res(Z, nv)
    assert r1.shape[1:] == r0.shape and Jx1.shape[1:] == J0[..., :NX].shape
    np.testing.assert_allclose(r1[0].numpy(), r0.numpy(), atol=1e-6, rtol=0)
    Jx0, Ju0 = J0[..., :NX], J0[..., NX:]
    np.testing.assert_allclose(Jx1[0].numpy(), Jx0.numpy(), rtol=0,
                               atol=2e-4 * max(1.0, float(Jx0.abs().max())))
    np.testing.assert_allclose(Ju1[0].numpy(), Ju0.numpy(), rtol=0,
                               atol=2e-4 * max(1.0, float(Ju0.abs().max())))


@pytest.fixture(scope="module")
def golden_point():
    g = np.load(os.path.join(DATA, "go2_trot_n25_golden.npz"))
    solver, _, _, p = F.flagship(device="cpu")
    X, U, _, li = warm_start_from_numpy(g["X_conv"], g["U_conv"], g["U_conv"][:, :18],
                                        g["lam_ineq_conv"], device="cpu")
    return solver, X, U, p.replace(lam_ineq=li), g


def test_fast_blocks_match_jacfwd_and_jax(golden_point):
    """At the golden point against gn_blocks_jacfwd; at the golden file's
    fixed-dt iterate (the converged point moved by noise, where the
    gradient blocks are not sums of cancelling fp32 terms) also against the
    JAX package's blocks."""
    solver, X, U, p, _ = golden_point
    ref = np.load(os.path.join(DATA, "go2_trot_time_opt_golden.npz"))
    Xf, Uf, _, lf = warm_start_from_numpy(ref["fast_X"], ref["fast_U"], ref["fast_U"][:, :18],
                                          ref["fast_lam_ineq"], device="cpu")
    for Xa, Ua, pa, jax_ref in ((X, U, p, False), (Xf, Uf, p.replace(lam_ineq=lf), True)):
        fast = lin.gn_blocks_fast(solver.spec, solver.weights, Xa, Ua, pa, *solver._jac_const)
        jac = lin.gn_blocks_jacfwd(solver.spec, solver.weights, Xa, Ua, pa)
        for name, b_f, b_j in zip(("Q", "R", "M", "qx", "ru"), fast, jac):
            # the lingram gate's bound per block: 3e-4 of max(1, |block|)
            assert block_err(b_f, b_j) <= 3e-4, name
            if jax_ref:
                assert block_err(b_f[0], torch.as_tensor(ref["fast_" + name])) <= 3e-4, name


def _spied(opt, cost, spec, log):
    def spy(name, fn):
        def call(*a, **k):
            log.append(name)
            return fn(*a, **k)
        return staticmethod(call)

    class Spied(TrajOptSolver):
        gn_blocks_fast = spy("gn_blocks_fast", lin.gn_blocks_fast)
        gn_blocks_jacfwd = spy("gn_blocks_jacfwd", lin.gn_blocks_jacfwd)
        riccati_sweep = spy("riccati_sweep", ric.riccati_sweep)
        forward_rollout = spy("forward_rollout", ric.forward_rollout)

    return Spied(spec, opt, cost, device="cpu")


def test_fast_rti_step_matches_jacfwd(golden_point):
    """From the golden converged point (a batch of two): the step with the
    fast blocks against the jacfwd step and the JAX package's RTI step.
    (Off the converged point, at the main path's x0 noise of 0.01, the two
    blocks' 1e-7 differences move the step by ~1e-2 in float64 too: the
    sweep's conditioning there, not the blocks.)"""
    solver, X, U, p, g = golden_point
    log = []
    s = _spied(dataclasses.replace(solver.opt, linearize_mode="jacfwd", riccati_mode="pallas"),
               solver.cost, solver.spec, log)
    rep = lambda t: t.expand((2,) + t.shape[1:]).contiguous()
    Xb, Ub, pb = rep(X), rep(U), p.map(rep)
    fast = s.solve(Xb, Ub, pb, 1, use_fast_linearize=True)
    assert log == ["gn_blocks_fast", "riccati_sweep", "forward_rollout"]
    log.clear()
    jac = s.solve(Xb, Ub, pb, 1)
    assert log == ["gn_blocks_jacfwd", "riccati_sweep", "forward_rollout"]
    assert rel(fast.U, jac.U) <= GATE and rel(fast.X, jac.X) <= GATE
    assert rel(fast.U[1], g["U_rti"]) <= GATE


@pytest.mark.parametrize("change", [dict(linearize_mode="dynjac"),
                                    dict(linearize_mode="jacfwd", enable_time_opt=True)])
def test_routes_that_ignore_the_option(change):
    """The dynjac route and the time-optimal mode linearize as without it,
    as in the JAX package."""
    base, X, U, p = F.flagship(device="cpu", n_nodes=4)
    log = []
    s = _spied(dataclasses.replace(base.opt, **change), base.cost, base.spec, log)
    X, U = s.cold_start(p)
    a = s.gn_step(X, U, p, use_fast_linearize=True)
    b = s.gn_step(X, U, p)
    assert "gn_blocks_fast" not in log
    for x, y in zip(a, b):
        assert torch.equal(x, y)
