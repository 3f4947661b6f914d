"""How far apart the two packages' time-optimal RTI replans are, and why.

Runs the JAX package's ``LocomotionMPC`` in the time-optimal mode on the
JAX device plant on the CPU (the loop of
``scripts/make_torch_time_opt_golden.py``) for the first 81 control steps,
which hold its boot plan and two RTI replans, and records each replan's
state and warm start. The port's controller then replays the same states
(its own internal references evolve as the JAX one's), with the JAX warm
start installed before each RTI replan, so both solvers get identical
inputs; the script captures the port's parameters and, for each RTI
replan, prints

- the port's and the JAX package's fp32 solve on those inputs,
  rel |dU| / (1 + |U|) between them;
- the alpha = 1 Gauss-Newton step of each in fp32 and the port's step in
  float64 (blocks, terminal Gram, per-node A/B, generic sweep, rollout):
  each fp32 step's distance to the float64 one; and the port's sweep on the
  JAX blocks.

Where both fp32 steps are equally far from float64 and the blocks agree to
rounding, the two packages' difference is the step's fp32 conditioning.

    python scripts/time_opt_replan_conditioning_torch.py
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

STEPS = 81


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def jax_run(g):
    """The JAX controller's first STEPS control steps: the states, and each
    replan's (state, node, warm start before it, plan)."""
    import make_torch_time_opt_golden as G
    from iterative_learning_nmpc_tpu.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu.mpc import controller as jc
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim import jax_sim

    go2 = go2_spec()
    with G.time_opt_configs(jc):
        mpc = jc.LocomotionMPC(go2, gait_name="trot", solve_async=False)
    mpc.set_command(g["loop_v_des"])
    cp = jax_sim.contact_params_for(go2)
    step = jax.jit(lambda st, tau: jax_sim.step(go2, st, tau, cp, mpc.sim_dt))
    st = jax_sim.SimState(jnp.asarray(g["loop_q0"], jnp.float32), jnp.zeros(18, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))
    replans, xs, optimize = [], [], mpc.optimize

    def recording(q, v):
        pre = tuple(None if a is None else np.array(a)
                    for a in (mpc._X_prev, mpc._U_prev, mpc._lam_prev, mpc._lami_prev))
        last = mpc.last_node
        out = optimize(q, v)
        replans.append(dict(pre=pre, last=last, U=np.array(mpc._U_prev)))
        return out

    mpc.optimize = recording
    data = G.PlantData()
    for i in range(STEPS):
        x = np.asarray(jnp.concatenate([st.q, st.v]), np.float64)
        xs.append(x)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = i * mpc.sim_dt
        mpc.compute_torques_dof(data)
        st = step(st, jnp.asarray(np.array(mpc.torques_dof[-go2.nu:]), jnp.float32))
    return mpc.solver, xs, replans


def port_replay(g, xs, replans):
    """The port's controller on the JAX states, the JAX warm start before
    each RTI replan; returns each replan's parameters and node."""
    from chip_smoke import time_opt_configs
    from iterative_learning_nmpc_tpu_torch.interop import controller_state_from_numpy
    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

    with time_opt_configs():
        mpc = LocomotionMPC(go2_spec(device="cpu"), gait_name="trot", solve_async=False,
                            device="cpu")
    mpc.set_command(g["loop_v_des"])
    seen, optimize, solve_plan = [], mpc.optimize, mpc._solve_plan

    def warm(q, v):
        k = len(seen)
        if k:
            controller_state_from_numpy(mpc, *replans[k]["pre"])
        return optimize(q, v)

    mpc.optimize = warm
    mpc._solve_plan = lambda params, node: solve_plan(seen.append((params, node)) or params,
                                                      node)

    class Data:
        time, qpos, qvel = 0.0, None, None

    data = Data()
    for i, x in enumerate(xs):
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = i * mpc.sim_dt
        mpc.compute_torques_dof(data)
    mpc.close()
    return mpc.solver, seen


def main():
    from iterative_learning_nmpc_tpu.ocp.problem import OCPParams as JaxParams
    from iterative_learning_nmpc_tpu.solver import sqp as jsqp
    from iterative_learning_nmpc_tpu_torch.ocp.problem import dynamics_jacobians
    from iterative_learning_nmpc_tpu_torch.ops.lingram import _double
    from iterative_learning_nmpc_tpu_torch.ops.riccati import terminal_gram
    from iterative_learning_nmpc_tpu_torch.solver import linearize as lin
    from iterative_learning_nmpc_tpu_torch.solver.sqp import forward_delta, riccati_solve

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    g = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_time_opt_golden.npz"))
    js, xs, replans = jax_run(g)
    ts, seen = port_replay(g, xs, replans)
    lm, reg_e = float(js.opt.lm_reg), float(js.cost.reg_eps_e)
    jsolve = jax.jit(lambda x, u, p: js.solve(x, u, p, 1))

    @jax.jit
    def jax_step(X, U, p):
        r, Jx, Ju = jsqp._linearize_stages(js.spec, js.weights, X, U, p, include_torque=True)
        nu = Ju.shape[-1]
        J = jnp.concatenate([Jx, Ju, r[..., None]], -1)
        G = jnp.einsum("nri,nrj->nij", J, J)
        blocks = (G[:, :36, :36], G[:, 36:36 + nu, 36:36 + nu], G[:, :36, 36:36 + nu],
                  G[:, :36, 36 + nu], G[:, 36:36 + nu, 36 + nu])
        rT, JT = jsqp._linearize_terminal(js.spec, js.weights, X[-1], p)
        P_N, p_N = JT.T @ JT + reg_e * jnp.eye(36), JT.T @ rT
        d = js._defects(X, U, p)
        Jd = jax.vmap(jax.jacfwd(lambda z, dt: jsqp.dynamics_step(z[:36], z[36:], dt)))(
            jnp.concatenate([X[:-1], U], 1), p.dt)
        A, B = Jd[:, :, :36], Jd[:, :, 36:]
        K, kff = jsqp._riccati_solve(A, B, *blocks, P_N, p_N, d, jnp.float32(lm))
        dU = jsqp._forward_delta(A, B, K, kff, d, p.x0 - X[0], jnp.float32(1.0))[1]
        return blocks, P_N, p_N, d, A, B, dU

    def port_step(spec, w, X, U, p, blocks=None):
        term = (X[:, -1], p.peak[:, :, -1], p.base_ref_e, p.joint_ref, p.step_height)
        blocks = lin.gn_blocks_jacfwd(spec, w, X, U, p) if blocks is None else blocks
        P_N, p_N = terminal_gram(spec, w, reg_e, *term)
        A, B = dynamics_jacobians(X[:, :-1], U)
        d = ts._defects(X, U, p)
        K, kff = riccati_solve(A, B, *blocks, P_N, p_N, d, lm)
        return forward_delta(A, B, K, kff, d, p.x0 - X[:, 0])[1][0].numpy()

    for k in range(1, len(replans)):
        p, node = seen[k]
        X, U, lam, lami = replans[k]["pre"]
        shift = node - replans[k]["last"]
        Xw, Uw = ts.shift_warmstart(torch.as_tensor(X)[None], torch.as_tensor(U)[None], shift)
        Xw = torch.cat([p.x0[:, None], Xw[:, 1:]], 1)
        p = p.replace(lam_eq=ts.shift_multipliers(torch.as_tensor(lam)[None], shift),
                      lam_ineq=ts.shift_multipliers(torch.as_tensor(lami)[None], shift))
        jp = JaxParams(**{f.name: getattr(p, f.name)[0].numpy()
                          for f in dataclasses.fields(JaxParams)})
        sp, sj = ts.solve(Xw, Uw, p, 1), jsolve(Xw[0].numpy(), Uw[0].numpy(), jp)
        print(f"[replan {k}] node {node}: the JAX solve on the port's inputs reproduces the JAX "
              f"controller's plan to {rel(np.asarray(sj.U), replans[k]['U']):.1e}; port vs JAX "
              f"solve rel|dU| {rel(sp.U[0].numpy(), np.asarray(sj.U)):.3e} (alpha "
              f"{float(sp.stats.alpha[0])} / {float(sj.stats.alpha)}, cost "
              f"{float(sp.stats.cost[0]):.3f} / {float(sj.stats.cost):.3f})", flush=True)
        jb, *_, jdU = (jax.tree.map(np.asarray, a) for a in jax_step(Xw[0].numpy(),
                                                                     Uw[0].numpy(), jp))
        tb = lin.gn_blocks_jacfwd(ts.spec, ts.weights, Xw, Uw, p)
        blk = max(float((a[0] - torch.as_tensor(b)).abs().max()) / max(1.0, np.abs(b).max())
                  for a, b in zip(tb, jb))
        dU32 = port_step(ts.spec, ts.weights, Xw, Uw, p, tb)
        dU64 = port_step(_double(ts.spec), _double(ts.weights), Xw.double(), Uw.double(),
                         _double(p))
        dU_on_jax = port_step(ts.spec, ts.weights, Xw, Uw, p,
                              tuple(torch.as_tensor(b)[None] for b in jb))
        print(f"[replan {k}] the alpha = 1 step: blocks apart {blk:.1e} of their scale; rel|dU| "
              f"port vs JAX {rel(dU32, jdU):.3e}; to the float64 step: port {rel(dU32, dU64):.3e}, "
              f"JAX {rel(jdU, dU64):.3e}; the port's sweep on the JAX blocks: to JAX "
              f"{rel(dU_on_jax, jdU):.3e}, to float64 {rel(dU_on_jax, dU64):.3e}", flush=True)


if __name__ == "__main__":
    main()
