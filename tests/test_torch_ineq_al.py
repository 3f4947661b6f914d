"""The AL hinge duals and the inner QP loop of the port's solver, on
``tests/test_ineq_al.py``'s stress trot (Go2 at 0.8 m/s with mu = 0.25, so
the cone hinges are active) and its cold 15-iteration solve, on the CPU:

- the converged plan's cone and torque violations within 0.5 N / 0.3 Nm,
  the duals annealed, the cost finite,
- max_qp_iter and qp_tol consumed (a cold single SQP iteration takes more
  than one inner pass, a budget of one caps it, a loose qp_tol exits after
  one; the budgeted solve no more violated than the unbudgeted one),
- warm-started RTI with the duals carried: violations bounded, one inner
  pass a solve,
- swing feet's cone duals reset,

and the port's ``_ineq_g`` / ``update_ineq_multipliers`` against the JAX
package's (its XLA path, under one ``jax.jit``) on the same (X, U, params,
lam_ineq), given as numpy.

~11 s of worker time; one JAX compile.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config as jax_configs
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.solver import sqp as JS
from iterative_learning_nmpc_tpu_torch.gait.planner import ContactPlanner
from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu_torch.ocp.problem import NC_CONE, NC_TORQUE
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver, make_params

torch.set_num_threads(1)


def _stress_inputs(N, dt_nodes, gait, spec_q_home, feet):
    q0 = np.asarray(spec_q_home, np.float64).copy()
    x0 = np.concatenate([q0, np.zeros(18)]).astype(np.float32)
    cnt = ContactPlanner(feet, dt_nodes, gait).get_contacts(0, N + 1).astype(np.float32)
    base_ref = np.zeros(12, np.float32)
    base_ref[:3] = q0[:3]
    base_ref[2] = gait.nom_height
    base_ref[6] = 0.8
    return x0, cnt, dict(base_ref=base_ref, base_ref_e=base_ref, step_height=gait.step_height)


def _stress_problem(**opt_overrides):
    """tests/test_ineq_al.py's _stress_problem on the port (CPU)."""
    gait, opt, cost = get_quadruped_config("trot", "go2")
    opt.mu = 0.25
    opt = dataclasses.replace(opt, **opt_overrides)
    spec = go2_spec(device="cpu")
    solver = TrajOptSolver(spec, opt, cost, device="cpu")
    x0, cnt, kw = _stress_inputs(solver.N, solver.dt_nodes, gait, spec.q_home.numpy(),
                                 spec.feet_frame_names)
    return solver, make_params(solver, x0, cnt, **kw)


def _max_violations(solver, sol, params):
    """(max cone violation [N], max torque violation [Nm]) over the plan."""
    g = solver._ineq_g(sol.X, sol.U, params)
    return (float(g[..., :NC_CONE].clamp_min(0.0).max()),
            float(g[..., NC_CONE:NC_CONE + NC_TORQUE].clamp_min(0.0).max()))


@pytest.fixture(scope="module")
def stress_solved():
    solver, params = _stress_problem()
    X, U = solver.cold_start(params)
    return solver, params, solver.solve(X, U, params, 15)


def test_converged_trot_cone_and_torque_bounded(stress_solved):
    solver, params, sol = stress_solved
    cone_viol, tau_viol = _max_violations(solver, sol, params)
    assert cone_viol <= 0.5, f"cone violation {cone_viol:.3f} N > 0.5 N"
    assert tau_viol <= 0.3, f"torque violation {tau_viol:.3f} Nm"
    assert float(sol.lam_ineq.max()) > 0.0
    assert np.isfinite(float(sol.stats.cost))


def test_qp_budget_consumed(stress_solved):
    solver, params, sol6 = stress_solved
    X, U = solver.cold_start(params)
    assert int(sol6.stats.qp_iters) >= 1
    assert float(sol6.stats.viol) <= solver.opt.qp_tol + 1e-6

    sol_cold = solver.solve(X, U, params, 1)
    assert int(sol_cold.stats.qp_iters) > 1

    solver1, _ = _stress_problem(max_qp_iter=1)
    assert int(solver1.solve(X, U, params, 1).stats.qp_iters) == 1
    sol1 = solver1.solve(X, U, params, 15)
    v6, _ = _max_violations(solver, sol6, params)
    v1, _ = _max_violations(solver1, sol1, params)
    assert v6 <= v1 + 1e-6, f"budget=6 viol {v6:.4f} vs budget=1 {v1:.4f}"

    solver_loose, _ = _stress_problem(qp_tol=1.0e9)
    assert int(solver_loose.solve(X, U, params, 1).stats.qp_iters) == 1


def test_rti_dual_warmstart_steady_state(stress_solved):
    solver, params, sol = stress_solved
    X, U, lami = sol.X, sol.U, sol.lam_ineq
    for _ in range(5):
        s = solver.solve(X, U, params.replace(lam_ineq=lami), 1)
        X, U, lami = s.X, s.U, s.lam_ineq
    cone_viol, _ = _max_violations(solver, s, params)
    assert cone_viol <= 0.5
    assert float(s.stats.viol) <= solver.opt.qp_tol + 1e-6
    assert int(s.stats.qp_iters) == 1


def test_swing_duals_reset_on_liftoff(stress_solved):
    solver, params, sol = stress_solved
    lami = sol.lam_ineq[0].numpy()
    cnt = params.cnt[0, :, :solver.N].T.numpy()                 # (N, 4)
    swing_cone = lami[:, :NC_CONE].reshape(-1, 4, 5)[cnt < 0.5]
    assert swing_cone.size > 0 and np.all(swing_cone == 0.0)


def test_ineq_g_and_update_match_jax(stress_solved):
    """At the port's converged plan, with its annealed shifts perturbed so
    that rows grow, decay, clip and reset: g to 1e-4 of the largest |g|, the
    updated shifts to 1e-4 of the largest shift, the violation to 1e-4."""
    solver, params, sol = stress_solved
    rng = np.random.RandomState(0)
    lam_in = np.abs(sol.lam_ineq[0].numpy()
                    + rng.randn(*sol.lam_ineq.shape[1:]).astype(np.float32))
    X, U = sol.X[0].numpy(), sol.U[0].numpy()

    gait, opt, cost = jax_configs("trot", "go2")
    opt.mu = 0.25
    jsolver = JS.TrajOptSolver(jax_go2(), opt, cost)
    x0, cnt, kw = _stress_inputs(jsolver.N, jsolver.dt_nodes, gait,
                                 np.asarray(jsolver.spec.q_home), jsolver.spec.feet_frame_names)
    jp = JS.make_params(jsolver, x0, cnt, **kw)
    np.testing.assert_array_equal(np.asarray(jp.cnt), params.cnt[0].numpy())

    def jax_fn(X_, U_, p_, l_):
        return (jsolver._ineq_g(X_, U_, p_),) + tuple(
            jsolver.update_ineq_multipliers(X_, U_, p_, l_))

    g0, lam0, viol0 = (np.asarray(a) for a in jax.jit(jax_fn)(
        jnp.asarray(X), jnp.asarray(U), jp, jnp.asarray(lam_in)))
    g1 = solver._ineq_g(sol.X, sol.U, params)[0].numpy()
    lam1, viol1 = solver.update_ineq_multipliers(sol.X, sol.U, params,
                                                 torch.as_tensor(lam_in)[None])
    np.testing.assert_allclose(g1, g0, rtol=0, atol=1e-4 * float(np.abs(g0).max()))
    np.testing.assert_allclose(lam1[0].numpy(), lam0, rtol=0,
                               atol=1e-4 * float(np.abs(lam0).max()))
    assert abs(float(viol1[0]) - float(viol0)) <= 1e-4
