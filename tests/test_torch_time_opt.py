"""The time-optimal mode (``enable_time_opt``: each node's duration a 31st
input) of the port against the JAX package, on the CPU.

- The bilinear shooting step and its per-node A_k / B_k (the port's closed
  form, ``ocp.problem.dynamics_jacobians``) against the JAX package's
  ``dynamics_step`` and ``jax.jacfwd`` of it, eager on a few nodes.
- The 31-column Gauss-Newton blocks at the bench instance's cold point, the
  15-iteration solve and one RTI step from its converged point against
  ``tests/data/go2_trot_time_opt_golden.npz`` (``scripts/
  make_torch_time_opt_golden.py``: the JAX package on the CPU, sequential +
  jacfwd), at the bench's gate; the checks of ``tests/test_time_opt.py`` on
  the port's solve.
- ``interpolate_plan`` with one row of node durations a problem against the
  JAX function row by row, and with shared durations bit for bit as it was
  before the per-problem rows (a frozen copy of that code).
- The controller in the time-optimal mode: its first plan against the JAX
  controller's, and ``_last_dt_sol`` / ``dt_plan_full`` after it.

~14 s of worker time (the 15-iteration solve ~6 s, the controller's first
plan ~6 s); one JAX compile (``interpolate_plan``).
"""
import contextlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.mpc.interpolate import interpolate_plan as jax_interp
from iterative_learning_nmpc_tpu.ocp import problem as jprob
from iterative_learning_nmpc_tpu_torch import flagship as F
from iterative_learning_nmpc_tpu_torch.interop import warm_start_from_numpy
from iterative_learning_nmpc_tpu_torch.mpc import controller as controller_module
from iterative_learning_nmpc_tpu_torch.mpc.interpolate import hermite_interp, interpolate_plan
from iterative_learning_nmpc_tpu_torch.ocp.problem import (
    dt_residual, dynamics_jacobians, dynamics_step, stage_residual)
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.solver import linearize as lin

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GATE = 1.0e-3      # the bench's rel |dU| / (1 + |U|) gate (bench.py _cold_conv, _rti1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(DATA, "go2_trot_time_opt_golden.npz"))


@pytest.fixture(scope="module")
def case(g):
    """The bench instance in the time-optimal mode and the port's
    15-iteration solve from its cold start."""
    solver, X, U, p = F.flagship(device="cpu", time_opt=True)
    return solver, X, U, p, solver.solve(X, U, p, 15)


def test_bilinear_step_and_jacobians_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 36)).astype(np.float32)
    u = rng.normal(size=(3, 31)).astype(np.float32)
    u[:, 30] = rng.uniform(0.02, 0.07, 3)
    dt_nom = np.full(3, 0.04, np.float32)
    ref = [np.asarray(jprob.dynamics_step(jnp.asarray(a), jnp.asarray(b), d))
           for a, b, d in zip(x, u, dt_nom)]
    out = dynamics_step(torch.as_tensor(x), torch.as_tensor(u), torch.as_tensor(dt_nom))
    np.testing.assert_allclose(out.numpy(), np.stack(ref), rtol=0, atol=1e-6)
    # the nominal dt where the input has no slot
    out30 = dynamics_step(torch.as_tensor(x), torch.as_tensor(u[:, :30]),
                          torch.as_tensor(dt_nom))
    ref30 = jprob.dynamics_step(jnp.asarray(x[0]), jnp.asarray(u[0, :30]), dt_nom[0])
    np.testing.assert_allclose(out30[0].numpy(), np.asarray(ref30), rtol=0, atol=1e-6)
    # per-node A_k / B_k: the closed form against jax.jacfwd of the step
    z = np.concatenate([x, u], 1)
    J = [np.asarray(jax.jacfwd(lambda zz: jprob.dynamics_step(zz[:36], zz[36:], 0.04))(
        jnp.asarray(zk))) for zk in z]
    A, B = dynamics_jacobians(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(A.numpy(), np.stack(J)[:, :, :36], rtol=0, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), np.stack(J)[:, :, 36:], rtol=0, atol=1e-6)
    # and against torch.func.jacfwd of the port's own step, in float64
    x64, u64 = torch.as_tensor(x, dtype=torch.float64), torch.as_tensor(u, dtype=torch.float64)
    Jt = torch.func.vmap(torch.func.jacfwd(lambda zz: dynamics_step(
        zz[:36], zz[36:], torch.tensor(0.04, dtype=torch.float64))))(torch.cat([x64, u64], 1))
    A64, B64 = dynamics_jacobians(x64, u64)
    assert float((A64 - Jt[..., :36]).abs().max()) <= 1e-15
    assert float((B64 - Jt[..., 36:]).abs().max()) <= 1e-15


def test_dt_rows_are_the_jax_rows():
    """The three dt rows of the residual (cost rows only), inside and
    outside the bounds, against the JAX package's formula for them
    (``ocp/problem.py:359-366``), placed where it places them."""
    solver, X, U, p = F.flagship(device="cpu", n_nodes=4, time_opt=True)
    w = solver.weights
    dts = torch.tensor([0.04, 0.005, 0.1, float(w.dt_min)])
    rows = dt_residual(w, dts)
    want = np.stack([[(d - w.dt_nom.item()) * w.dt_reg.item(),
                      max(w.dt_min.item() - d, 0.0) * w.dt_bound.item(),
                      max(d - w.dt_max.item(), 0.0) * w.dt_bound.item()] for d in dts.tolist()])
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-6, atol=1e-3)
    assert rows[0, 1] == 0 and rows[0, 2] == 0 and rows[1, 1] > 0 and rows[2, 2] > 0
    nv = lin.node_view(p, 4)
    r31 = stage_residual(solver.spec, w, X[:, :-1], U, include_torque=True, **nv)
    r30 = stage_residual(solver.spec, w, X[:, :-1], U[..., :30], include_torque=True, **nv)
    assert r31.shape[-1] == r30.shape[-1] + 3
    # the dt rows sit before the torque rows, as in the JAX package
    assert torch.equal(r31[..., 130:133], dt_residual(w, U[..., 30]))
    assert torch.equal(torch.cat([r31[..., :130], r31[..., 133:]], -1), r30)


def test_cold_blocks_match_jax(g, case):
    solver, X, U, p, _ = case
    assert solver.nu == 31 and U.shape == (1, solver.N, 31)
    assert float(np.abs(p.x0[0].numpy() - g["x0"]).max()) <= 1e-6
    assert np.array_equal(p.cnt[0].numpy(), g["cnt"])
    assert torch.equal(U[0], torch.as_tensor(g["cold_U"]))
    assert torch.all(U[..., 30] == solver.dt_nodes)
    blocks = lin.gn_blocks_jacfwd(solver.spec, solver.weights, X, U, p)
    for name, b in zip(("Q", "R", "M", "qx", "ru"), blocks):
        ref = g["cold_" + name]
        assert b.shape[1:] == ref.shape
        # tests/test_fast_linearize.py's bound on the Gram blocks
        assert float(np.abs(b[0].numpy() - ref).max()) <= 3e-4 * max(1.0, np.abs(ref).max()), name
    A, B = dynamics_jacobians(X[:, :-1], U)
    np.testing.assert_allclose(A[0].numpy(), g["cold_A"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(B[0].numpy(), g["cold_B"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(solver._defects(X, U, p)[0].numpy(), g["cold_defects"],
                               rtol=0, atol=1e-6)


def test_solve_and_rti_step_match_jax(g, case):
    solver, X, U, p, sol = case
    assert rel(sol.U[0], g["conv_U"]) <= GATE
    assert int(sol.stats.sqp_iters[0]) == int(g["conv_sqp_iters"])
    assert abs(float(sol.stats.cost[0]) / float(g["conv_cost"]) - 1.0) <= 1e-4
    # one RTI step from the JAX package's converged point and shifts
    Xc, Uc, _, li = warm_start_from_numpy(g["conv_X"], g["conv_U"], g["conv_U"][:, :18],
                                          g["conv_lam_ineq"], device="cpu")
    assert Uc.shape == (1, solver.N, 31)
    s1 = solver.solve(Xc, Uc, p.replace(lam_ineq=li), 1)
    assert rel(s1.U[0], g["rti_U"]) <= GATE
    assert rel(s1.X[0], g["rti_X"]) <= GATE


def test_time_opt_checks(case):
    """tests/test_time_opt.py's checks on the port's solve."""
    solver, _, _, p, sol = case
    dt_min, dt_max = solver.opt.get_dt_bounds()
    dts = sol.dt_sol(p.dt)[0].numpy()
    assert dts.shape == (solver.N,)
    assert dts.min() > dt_min - 1e-4 and dts.max() < dt_max + 1e-4
    assert dts.std() > 1e-5
    defect = float(solver._defects(sol.X, sol.U, p).abs().max())
    assert defect < 1e-2 and float(sol.stats.defect[0]) == defect
    z = sol.X[0, :, 2].numpy()
    assert np.all(z > 0.18) and np.all(z < 0.42)
    # the warm-start shifts carry every column
    Xs, Us = solver.shift_warmstart(sol.X, sol.U, 2)
    assert Us.shape == sol.U.shape and torch.equal(Us[0, -3:], sol.U[0, -1:].expand(3, 31))
    assert torch.equal(solver.shift_multipliers(sol.lam_ineq, 1)[0, :-1], sol.lam_ineq[0, 1:])


def _interpolate_before(q_sol, v_sol, a_sol, dt_sol, n_interp):
    """interpolate_plan as it was before it took one row of durations a
    problem (the reference of the shared-durations case)."""
    N = a_sol.shape[-2]
    t_knots = torch.cat([torch.zeros(1, dtype=dt_sol.dtype, device=dt_sol.device),
                         torch.cumsum(dt_sol, 0)])
    t_query = torch.linspace(float(t_knots[0]), float(t_knots[-1]), n_interp + 1,
                             dtype=dt_sol.dtype, device=dt_sol.device)[1:]
    K = t_knots.shape[0]
    tq = torch.clamp(t_query, t_knots[0], t_knots[-1])
    idx = torch.clamp(torch.searchsorted(t_knots, tq, right=True) - 1, 0, K - 2)
    t0, t1 = t_knots[idx], t_knots[idx + 1]
    h = torch.clamp_min(t1 - t0, 1e-9)
    s = ((tq - t0) / h)[:, None]

    def herm(y, dy):
        y0, y1, d0, d1 = y[..., idx, :], y[..., idx + 1, :], dy[..., idx, :], dy[..., idx + 1, :]
        return ((1 + 2 * s) * (1 - s) ** 2 * y0 + s * (1 - s) ** 2 * (h[:, None] * d0)
                + s * s * (3 - 2 * s) * y1 + s * s * (s - 1) * (h[:, None] * d1))

    id_repeat = (torch.linspace(0.0, 1.0, n_interp, device=dt_sol.device)
                 * (N - 1)).to(torch.int64)
    return (herm(q_sol, v_sol), herm(v_sol, torch.cat([a_sol[..., :1, :], a_sol], dim=-2)),
            id_repeat)


def test_interpolate_plan_per_problem_durations():
    rng = np.random.default_rng(2)
    B, N, n = 3, 25, 1000
    q, v = (rng.standard_normal((B, N + 1, 18)).astype(np.float32) for _ in range(2))
    a = rng.standard_normal((B, N, 18)).astype(np.float32)
    dt = rng.uniform(0.02, 0.07, (B, N)).astype(np.float32)
    out = interpolate_plan(*map(torch.as_tensor, (q, v, a, dt)), n)
    ref_fn = jax.jit(lambda *x: jax_interp(*x, n))
    for b in range(B):
        ref = ref_fn(q[b], v[b], a[b], dt[b])
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
        for o, r in zip(out[:2], ref[:2]):
            # query times a few ulps of the horizon apart; slopes of ~100/s
            np.testing.assert_allclose(o[b].numpy(), np.asarray(r), rtol=0, atol=5e-5)
    # shared durations: bit for bit as before
    before = _interpolate_before(*map(torch.as_tensor, (q, v, a, dt[0])), n)
    shared = interpolate_plan(*map(torch.as_tensor, (q, v, a, dt[0])), n)
    for o, r in zip(shared, before):
        assert torch.equal(o, r)
    # the batched knots evaluate each row as its own knots would
    tk = torch.cat([torch.zeros(B, 1), torch.cumsum(torch.as_tensor(dt), 1)], 1)
    tq = torch.rand(B, 7) * tk[:, -1:]
    yb = hermite_interp(tk, torch.as_tensor(q), torch.as_tensor(v), tq)
    for b in range(B):
        assert torch.allclose(yb[b], hermite_interp(tk[b], torch.as_tensor(q[b]),
                                                    torch.as_tensor(v[b]), tq[b]),
                              rtol=0, atol=1e-6)


@contextlib.contextmanager
def time_opt_configs():
    """The controller's configurations with ``enable_time_opt`` set."""
    orig = controller_module.get_quadruped_config

    def configs(*a, **k):
        gait, opt, cost = orig(*a, **k)
        opt.enable_time_opt = True
        return gait, opt, cost

    controller_module.get_quadruped_config = configs
    try:
        yield
    finally:
        controller_module.get_quadruped_config = orig


class PlantData:
    time, qpos, qvel = 0.0, None, None


def test_controller_first_plan_and_durations(g):
    """The time-optimal LocomotionMPC's first plan at the JAX run's boot
    offset against the JAX controller's; the plan's durations are the
    optimized 31st input, and the next control step records the first."""
    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp

    with time_opt_configs():
        mpc = controller_module.LocomotionMPC(go2_spec(device="cpu"), gait_name="trot",
                                              solve_async=False, phase_aligned_boot=False,
                                              device="cpu")
    assert mpc.solver.time_opt and mpc.solver.nu == 31
    np.testing.assert_array_equal(mpc._last_dt_sol, np.full(mpc.config_opt.n_nodes,
                                                            mpc.dt_nodes))
    mpc.set_command(g["loop_v_des"])
    mpc.current_opt_node = int(g["loop_boot_offset"])
    data = PlantData()
    data.qpos, data.qvel = tnp.convert_to_mujoco(g["loop_q0"], np.zeros(18))
    mpc.compute_torques_dof(data)          # the first plan, then its first step
    U = mpc._U_prev[0].numpy()
    assert U.shape == (mpc.config_opt.n_nodes, 31)
    assert rel(U, g["loop_U"]) <= GATE
    np.testing.assert_array_equal(mpc._last_dt_sol, U[:, 30].astype(np.float64))
    assert np.ptp(mpc._last_dt_sol) > 0
    assert mpc.dt_plan_full == [float(U[0, 30])]
    mpc.close()
