"""Write the golden reference the PyTorch port is held to on the GPU.

Runs the JAX package on the CPU (sequential Riccati + jacfwd linearization)
on the flagship instance (``__graft_entry__._flagship``: Go2 trot, N=25):

- the 15-iteration converged solve from the cold start,
- one warm-started RTI step (n_iter=1) from that solution, with its
  annealed inequality duals,

and stores them in ``tests/data/go2_trot_n25_golden.npz``. The card's
machine has no JAX, so ``chip_smoke.py`` gates the port against this file;
``tests/test_torch_solver_multi.py`` holds the port's plain path to the RTI
step on the CPU.

    python scripts/make_torch_golden.py
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(ROOT, "tests", "data", "go2_trot_n25_golden.npz")


def main():
    from __graft_entry__ import _flagship

    solver, X, U, params = _flagship()
    assert solver._riccati_mode == "sequential" and solver._linearize_mode == "jacfwd"
    conv = jax.jit(lambda x, u, p: solver.solve(x, u, p, 15))(X, U, params)
    p1 = dataclasses.replace(jax.tree.map(np.asarray, params),
                             lam_ineq=np.asarray(conv.lam_ineq))
    Xc, Uc = np.asarray(conv.X), np.asarray(conv.U)
    rti = jax.jit(lambda x, u, p: solver.solve(x, u, p, 1))(Xc, Uc, p1)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT,
        x0=np.asarray(params.x0), cnt=np.asarray(params.cnt),
        X_cold=np.asarray(X), U_cold=np.asarray(U),
        X_conv=Xc, U_conv=Uc, lam_ineq_conv=np.asarray(conv.lam_ineq),
        cost_conv=np.asarray(conv.stats.cost),
        X_rti=np.asarray(rti.X), U_rti=np.asarray(rti.U),
        lam_ineq_rti=np.asarray(rti.lam_ineq), r_eq_rti=np.asarray(rti.r_eq),
    )
    print(f"wrote {OUT}: converged cost {float(conv.stats.cost):.4f}, "
          f"{int(conv.stats.sqp_iters)} SQP iterations")


if __name__ == "__main__":
    main()
