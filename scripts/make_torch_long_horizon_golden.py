"""Write the long-horizon golden the PyTorch port is held to.

Runs the JAX package on the CPU (sequential Riccati + jacfwd linearization)
on the flagship instance at N=100 nodes over 4 s
(``__graft_entry__._flagship(n_nodes=100)``: Go2 trot), the horizon at which
the JAX package's batched solver takes its long-horizon route (N > 88):

- a converged solve from the cold start: 30 SQP iterations, with the
  config's early exit (nlp_tol) off,
- one warm-started RTI step (n_iter=1) of a batch of two problems from that
  solution, their initial states moved by N(0, 1e-4^2) (numpy seed 0),
  with the converged inequality duals and zero equality duals (a 1e-4
  move keeps the step fp32-conditioned: at 1e-3 one ulp of noise on X
  moves the second problem's step in the port by rel |dU| 1.7e-3..2.2e-3,
  at 1e-4 by at most 4e-4; scripts/measure_riccati_conditioning.py),

and stores them in ``tests/data/go2_trot_n100_golden.npz``. The card's
machine has no JAX, so ``chip_smoke.py`` holds the port's N=100 route to this
file; ``tests/test_torch_riccati_modes.py`` does so on the CPU. The step is
taken near convergence because a fp32 GN step far from a solution moves
either package by 1e-3..1e-1 against fp64.

    python scripts/make_torch_long_horizon_golden.py
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(ROOT, "tests", "data", "go2_trot_n100_golden.npz")
N_NODES, N_ITER, B, X0_STD, SEED = 100, 30, 2, 1e-4, 0


def main():
    from __graft_entry__ import _flagship

    solver, X, U, params = _flagship(n_nodes=N_NODES)
    assert solver._riccati_mode == "sequential" and solver._linearize_mode == "jacfwd"
    solver.opt.nlp_tol = 0.0
    conv = jax.jit(lambda x, u, p: solver.solve(x, u, p, N_ITER))(X, U, params)
    Xc, Uc = np.asarray(conv.X), np.asarray(conv.U)
    lam_ineq = np.asarray(conv.lam_ineq)

    rng = np.random.default_rng(SEED)
    rep = lambda a: np.repeat(np.asarray(a)[None], B, 0)
    pb = dataclasses.replace(jax.tree.map(rep, params), lam_ineq=rep(lam_ineq))
    x0b = (pb.x0 + X0_STD * rng.standard_normal(pb.x0.shape)).astype(np.float32)
    pb = dataclasses.replace(pb, x0=x0b)
    rti = jax.jit(jax.vmap(lambda x, u, p: solver.solve(x, u, p, 1)))(
        rep(Xc), rep(Uc), pb)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT,
        x0=np.asarray(params.x0), cnt=np.asarray(params.cnt),
        X_conv=Xc, U_conv=Uc, lam_ineq_conv=lam_ineq,
        cost_conv=np.asarray(conv.stats.cost),
        step_norm_conv=np.asarray(conv.stats.step_norm),
        x0_rti=x0b, X_rti=np.asarray(rti.X), U_rti=np.asarray(rti.U),
        lam_ineq_rti=np.asarray(rti.lam_ineq), cost_rti=np.asarray(rti.stats.cost),
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): converged cost "
          f"{float(conv.stats.cost):.4f}, {int(conv.stats.sqp_iters)} SQP "
          f"iterations, last step norm {float(conv.stats.step_norm):.3e}; "
          f"RTI step costs {np.asarray(rti.stats.cost)}")


if __name__ == "__main__":
    main()
