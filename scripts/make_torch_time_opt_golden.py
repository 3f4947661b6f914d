"""Write the golden of the solver's last options, which the PyTorch port is
held to: the time-optimal mode and ``solve(use_fast_linearize=True)``.

Runs the JAX package on the CPU with ``riccati_mode="sequential"`` and
``linearize_mode="jacfwd"`` (the JAX bench's CPU reference,
``bench._cpu_solver``) and stores ``tests/data/go2_trot_time_opt_golden.npz``:

- the bench instance in the time-optimal mode (``bench._instance("trot",
  time_opt=True)``: Go2 trot, N = 25, the 31st input each node's duration):
  its x0 and contacts, the cold start, the Gauss-Newton blocks there over
  31 input columns and the per-node A_k / B_k of the bilinear shooting step
  (``jax.jacfwd(dynamics_step)``, as ``sqp._sqp_iter`` takes them);
  ``cold_*``;
- the 15-iteration solve from the cold start and one RTI step from its
  converged point with its inequality shifts (the bench's ``_cold_conv``
  and ``_rti1`` cases for the time-optimal trot); ``conv_*``, ``rti_*``;
- the blocks of ``linearize_stages_fast`` at a fixed-dt iterate: the
  converged point of ``tests/data/go2_trot_n25_golden.npz`` with its
  states and inputs moved by seeded noise (stored); ``fast_*``;
- ``LocomotionMPC`` in the time-optimal mode (the trot configuration with
  ``enable_time_opt``, sync, phase-aligned boot, 0.3 m/s) on the JAX device
  plant (``sim/jax_sim``, 1 kHz) for 0.5 s from the standing state: the
  first plan (X, U, boot offset), the chart state and the joint torques of
  every control step, the node durations each step's plan used
  (``dt_plan_full``), and the fall time (-1 for none) or the error it
  raised; ``loop_*``.

The CPU tests (``tests/test_torch_time_opt.py``,
``tests/test_torch_fast_linearize.py``) and ``chip_smoke.py`` phase 29 read
it; the card's machine has no JAX.

    python scripts/make_torch_time_opt_golden.py
"""
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "go2_trot_time_opt_golden.npz")
N25 = os.path.join(ROOT, "tests", "data", "go2_trot_n25_golden.npz")
LOOP_S, V_DES = 0.5, 0.3


def instance(time_opt: bool):
    """The bench instance and its solver on the CPU reference routes."""
    import bench
    from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver

    solver, params = bench._instance("trot", time_opt=time_opt)
    opt = solver.opt
    opt.riccati_mode, opt.linearize_mode = "sequential", "jacfwd"
    return TrajOptSolver(solver.spec, opt, solver.cost), params


def gram(r, Jx, Ju):
    """(Q, R, M, qx, ru) of the stacked Jacobian, as sqp._sqp_iter forms them."""
    nx, nu = Jx.shape[-1], Ju.shape[-1]
    J = jnp.concatenate([Jx, Ju, r[..., None]], axis=-1)
    G = jnp.einsum("nri,nrj->nij", J, J)
    return dict(Q=G[:, :nx, :nx], R=G[:, nx:nx + nu, nx:nx + nu], M=G[:, :nx, nx:nx + nu],
                qx=G[:, :nx, nx + nu], ru=G[:, nx:nx + nu, nx + nu])


def solver_cases():
    import dataclasses

    from iterative_learning_nmpc_tpu.ocp.problem import NX, dynamics_step
    from iterative_learning_nmpc_tpu.solver import sqp

    solver, params = instance(True)
    assert solver.nu == 31 and solver._riccati_mode == "sequential"
    out = {"x0": params.x0, "cnt": params.cnt}
    X, U = jax.jit(solver.cold_start)(params)
    inc = solver.opt.torque_limit_in_qp

    @jax.jit
    def cold_blocks(X, U, p):
        r, Jx, Ju = sqp._linearize_stages(solver.spec, solver.weights, X, U, p,
                                          include_torque=inc)
        Z = jnp.concatenate([X[:-1], U], axis=1)
        J = jax.vmap(jax.jacfwd(lambda z, d: dynamics_step(z[:NX], z[NX:], d)))(Z, p.dt)
        return gram(r, Jx, Ju), J[:, :, :NX], J[:, :, NX:], solver._defects(X, U, p)

    blocks, A, B, d = cold_blocks(X, U, params)
    out.update(cold_X=X, cold_U=U, cold_A=A, cold_B=B, cold_defects=d,
               **{f"cold_{k}": v for k, v in blocks.items()})
    t0 = time.perf_counter()
    s = jax.jit(lambda x, u, p: solver.solve(x, u, p, 15))(X, U, params)
    out.update(conv_X=s.X, conv_U=s.U, conv_lam_ineq=s.lam_ineq, conv_cost=s.stats.cost,
               conv_sqp_iters=s.stats.sqp_iters, conv_qp_iters=s.stats.qp_iters,
               conv_defect=s.stats.defect)
    p1 = dataclasses.replace(params, lam_ineq=s.lam_ineq)
    s1 = jax.jit(lambda x, u, p: solver.solve(x, u, p, 1))(s.X, s.U, p1)
    out.update(rti_X=s1.X, rti_U=s1.U, rti_cost=s1.stats.cost, rti_lam_ineq=s1.lam_ineq)
    dts = np.asarray(s.U[:, 30])
    print(f"[time-opt] 15 iterations: cost {float(s.stats.cost):.4f}, {int(s.stats.sqp_iters)} "
          f"SQP iterations, dt {dts.min():.4f}..{dts.max():.4f} (std {dts.std():.2e}), defect "
          f"{float(s.stats.defect):.2e}; RTI cost {float(s1.stats.cost):.4f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def fast_case():
    import dataclasses

    from iterative_learning_nmpc_tpu.solver.linearize import linearize_stages_fast

    solver, params = instance(False)
    g = np.load(N25)
    assert np.abs(np.asarray(params.x0) - g["x0"]).max() <= 1e-6
    # off the converged point, where the gradient blocks are not sums of
    # cancelling fp32 terms: the states and inputs moved by seeded noise
    rng = np.random.default_rng(7)
    X = g["X_conv"].copy()
    X[1:] += (0.01 * rng.standard_normal(X[1:].shape)).astype(np.float32)
    U = g["U_conv"] + (0.1 * rng.standard_normal(g["U_conv"].shape)).astype(np.float32)
    p = dataclasses.replace(params, lam_ineq=g["lam_ineq_conv"])
    r, Jx, Ju = jax.jit(lambda X, U, p: linearize_stages_fast(
        solver.spec, solver.weights, X, U, p, *solver._jac_const,
        include_torque=solver.opt.torque_limit_in_qp))(X, U, p)
    return dict(fast_X=X, fast_U=U, fast_lam_ineq=g["lam_ineq_conv"],
                **{f"fast_{k}": v for k, v in gram(r, Jx, Ju).items()})


@contextlib.contextmanager
def time_opt_configs(module):
    """``module.get_quadruped_config`` with ``enable_time_opt`` set: how a
    ``LocomotionMPC`` of that module is built in the time-optimal mode."""
    orig = module.get_quadruped_config

    def configs(*a, **k):
        gait, opt, cost = orig(*a, **k)
        opt.enable_time_opt = True
        return gait, opt, cost

    module.get_quadruped_config = configs
    try:
        yield
    finally:
        module.get_quadruped_config = orig


class PlantData:
    time, qpos, qvel = 0.0, None, None


def closed_loop():
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu.mpc import controller as jc
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim import jax_sim

    go2 = go2_spec()
    q0 = np.asarray(go2.q_home, np.float32).copy()
    q0[2] += -np.asarray(dyn.foot_positions(go2, q0))[0, 2] + float(np.asarray(go2.foot_radius))
    with time_opt_configs(jc):
        mpc = jc.LocomotionMPC(go2, gait_name="trot", solve_async=False)
    assert mpc.solver.time_opt
    mpc.set_command(np.array([V_DES, 0.0, 0.0]))
    cp = jax_sim.contact_params_for(go2)
    step = jax.jit(lambda st, tau: jax_sim.step(go2, st, tau, cp, mpc.sim_dt))
    st = jax_sim.SimState(jnp.asarray(q0), jnp.zeros(18, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))
    data, qs, vs, taus, first = PlantData(), [], [], [], None
    n = int(round(LOOP_S / mpc.sim_dt))
    error = ""
    t0 = time.perf_counter()
    try:
        for i in range(n):
            x = np.asarray(jnp.concatenate([st.q, st.v]), np.float64)
            data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
            data.time = i * mpc.sim_dt
            mpc.compute_torques_dof(data)
            if first is None:
                first = dict(loop_X=np.asarray(mpc._X_prev), loop_U=np.asarray(mpc._U_prev),
                             loop_boot_offset=np.int64(mpc.boot_offsets[0]))
            tau = np.array(mpc.torques_dof[-go2.nu:], np.float64)      # a copy
            st = step(st, jnp.asarray(tau, jnp.float32))
            qs.append(x[:18])
            vs.append(x[18:])
            taus.append(tau)
    except Exception as e:       # recorded: the port is held to the same outcome
        error = f"{type(e).__name__}: {e}"
    qs.append(np.asarray(st.q, np.float64))
    qs = np.asarray(qs)
    bad = (qs[:, 2] < 0.5 * mpc.config_gait.nom_height) | (
        np.degrees(np.abs(qs[:, 4:6])).max(1) > 25.0)
    fall = float(np.argmax(bad) * mpc.sim_dt) if bad.any() else -1.0
    dt_plan = np.asarray(mpc.dt_plan_full, np.float64)
    print(f"[closed loop] {LOOP_S} s at {V_DES} m/s on the JAX device plant, time-optimal: "
          f"boot offset {int(first['loop_boot_offset'])}, fell at {fall} s, error {error!r}, "
          f"base z {qs[:, 2].min():.4f}..{qs[:, 2].max():.4f}, x {qs[-1, 0]:.4f}, dt_plan_full "
          f"{dt_plan.min():.4f}..{dt_plan.max():.4f}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(first, loop_q0=q0.astype(np.float64), loop_v_des=np.array([V_DES, 0.0, 0.0]),
                loop_q=qs, loop_v=np.asarray(vs), loop_tau=np.asarray(taus),
                loop_dt_plan=dt_plan, loop_fall=np.float64(fall), loop_error=np.str_(error))


def main():
    out = {}
    for part in (solver_cases, fast_case, closed_loop):
        out.update({k: np.asarray(v) for k, v in part().items()})
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
