"""Triage: is the port's fp32 Riccati solve further from float64 than the
JAX package's on the blocks where the card's sweep kernel strayed?

Two cases, each a batch of Gauss-Newton blocks formed once (the port's
plain Gram, fp32) and handed to both packages' fp32 sequential solve:

- ``solo12``: Solo12's converged standing trot (``flagship(robot=
  "solo12")``, 15 iterations), one warm RTI step from starts with joint
  noise N(0, 0.03^2) (env 0 clean), as ``chip_smoke.py`` phase 22 builds
  it;
- ``restricted``: the Raibert controller's parameters (``restrict = 1``,
  footsteps from each start) for the same noisy Go2 starts, half of them at
  a 3 cm patch radius, from the cold start, as phase 23 builds its B = 512
  step.

For each: the terminal Gram (``ops.riccati.terminal_gram``) and the defects
go with the blocks into (a) the JAX package's ``_riccati_solve_structured``
+ ``_forward_delta_structured`` (the ``riccati_mode="sequential"`` solve,
jitted on the CPU in fp32; no Pallas), (b) the port's twin
(``ops.riccati.riccati_sweep_structured`` + ``forward_delta_structured``,
fp32) and (c) the port's twin in float64 on the same blocks cast up, the
reference; (d) the JAX solve in float64 checks (c). Printed per case: each
fp32 step's distance to (c), rel |d(dU, dX)| / (1 + |ref|), the largest
and the median over problems.

    python scripts/triage_riccati_fp32_torch.py [--batch 64]
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

NOISE, SEED = 0.03, 0


def noisy(q0, n, rng):
    qb = np.tile(np.reshape(q0, (1, -1)), (n, 1)).astype(np.float32)
    qb[1:, 6:] += rng.normal(0, NOISE, (n - 1, 12)).astype(np.float32)
    return qb


def solo12_case(B):
    from iterative_learning_nmpc_tpu_torch import flagship as F

    solver, X, U, params = F.flagship(device="cpu", robot="solo12")
    conv = solver.solve(X, U, params, 15)
    q0 = params.x0[0, :18].numpy()
    x0b = np.concatenate([noisy(q0, B, np.random.default_rng(SEED)),
                          np.zeros((B, 18), np.float32)], 1)
    pb = params.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
    pb = pb.replace(x0=torch.as_tensor(x0b), lam_ineq=conv.lam_ineq.expand(B, -1, -1).clone())
    Xb = conv.X.expand(B, -1, -1).clone()
    Xb[:, 0] = pb.x0
    return solver, Xb, conv.U.expand(B, -1, -1).contiguous(), pb


def restricted_case(B):
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.ocp.problem import OCPParams
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

    g = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_raibert_golden.npz"))
    mpc = LocomotionMPC(go2_spec(device="cpu"), gait_name="trot", contact_planner="raibert",
                        solve_async=False, device="cpu")
    mpc.set_command(g["v_des"])
    mpc._solve_plan = lambda params, node: params
    ps = [mpc.optimize(q, g["v0"]) for q in
          noisy(g["q0"], B, np.random.default_rng(SEED)).astype(np.float64)]
    mpc.close()
    pb = OCPParams(**{f.name: torch.cat([getattr(p, f.name) for p in ps])
                      for f in dataclasses.fields(OCPParams)})
    half = B // 2
    pb = pb.replace(patch_radius=torch.cat([pb.patch_radius[:half],
                                            torch.full_like(pb.patch_radius[half:], 0.03)]))
    Xb, Ub = mpc.solver.cold_start(pb)
    return mpc.solver, Xb, Ub, pb


def rel_rows(a, b):
    """Per problem: max |a - b| / (1 + |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b) / (1.0 + np.abs(b))).reshape(a.shape[0], -1).max(1)


def triage(name, solver, X, U, p):
    from iterative_learning_nmpc_tpu.solver import sqp as jsqp
    from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram_plain
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        forward_delta_structured, riccati_sweep_structured, terminal_gram)

    spec, w, h = solver.spec, solver.weights, solver.dt_nodes
    lm = float(solver.opt.lm_reg)
    blocks = lingram_plain(spec, w, X, U, p, solver.opt.torque_limit_in_qp)
    P_N, p_N = terminal_gram(spec, w, float(solver.cost.reg_eps_e), X[:, -1], p.peak[:, :, -1],
                             p.base_ref_e, p.joint_ref, p.step_height)
    d, dx0 = solver._defects(X, U, p), p.x0 - X[:, 0]
    inputs = (*blocks, P_N, p_N, d)

    def port(dtype):
        c = lambda t: t.to(dtype)
        K, kff = riccati_sweep_structured(h, *map(c, inputs), lm)
        return forward_delta_structured(h, K, kff, c(d), c(dx0))

    def jax_step(dtype):
        def one(Q, R, M, qx, ru, P_N, p_N, d, dx0):
            K, kff = jsqp._riccati_solve_structured(h, Q, R, M, qx, ru, P_N, p_N, d,
                                                    jnp.asarray(lm, dtype))
            return jsqp._forward_delta_structured(h, K, kff, d, dx0, jnp.asarray(1.0, dtype))

        args = [jnp.asarray(t.double().numpy(), dtype) for t in (*inputs, dx0)]
        return jax.jit(jax.vmap(one))(*args)

    ref = port(torch.float64)
    out = {"port twin fp32": port(torch.float32), "JAX sequential fp32": jax_step(jnp.float32)}
    jax.config.update("jax_enable_x64", True)
    try:
        out["JAX sequential float64"] = jax_step(jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    rows = {}
    for k, (dX, dU) in out.items():
        r = np.maximum(rel_rows(dU, ref[1]), rel_rows(dX, ref[0]))
        rows[k] = r
        print(f"[{name}] B={X.shape[0]} {k}: to the port's float64 step max {r.max():.3e}, "
              f"median {np.median(r):.3e}", flush=True)
    ratio = rows["port twin fp32"].max() / rows["JAX sequential fp32"].max()
    print(f"[{name}] port twin / JAX, largest distance: {ratio:.3f}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    triage("solo12", *solo12_case(args.batch))
    triage("restricted", *restricted_case(args.batch))


if __name__ == "__main__":
    main()
