"""Measure how far fp32 rounding alone moves the Riccati gains and the RTI
step, on the CPU, to set the bounds the sweeps are held to.

1. Gains (the inputs of tests/test_torch_riccati_modes.py: the N=25 golden
   converged trajectory, B=3, interior states moved by 5e-4): how far one
   ulp of noise on the GN blocks moves the port's fp32 K and kff, and how
   far the port's and the JAX package's fp32 sweeps each are from the
   port's sweep in float64 (from JAX's P_N), as fractions of max |K|,
   max |kff|.
2. The N=100 RTI step (tests/data/go2_trot_n100_golden.npz's converged
   point, B=2): how far one ulp of noise on X moves the port's step, as
   rel |dU| / (1 + |U|), with x0 moved by N(0, s^2) for s = 1e-3 and 1e-4
   (numpy seed 0, as scripts/make_torch_long_horizon_golden.py).

    python scripts/measure_riccati_conditioning.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

ULP = 2.0 ** -23


def scaled(a, b):
    """max |a - b| / max(1, max |b|) for K and kff."""
    return [float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
            for x, y in ((a[..., :36], b[..., :36]), (a[..., 36], b[..., 36]))]


def gains():
    from test_torch_kernels_plain import riccati_case
    from test_torch_riccati_modes import sweep_case

    from iterative_learning_nmpc_tpu_torch.ops import riccati as ric

    c = sweep_case.__wrapped__(riccati_case.__wrapped__())
    r = c["ref"]
    port = ric.riccati_sweep(c["h"], c["lm"], *c["blocks"], r["P_N"], r["p_N"], r["d"])
    jax32 = torch.cat([r["K"], r["kff"][..., None]], dim=-1)
    f64 = ric.riccati_sweep_plain(c["h"], c["lm"], *(b.double() for b in c["blocks"]),
                                  r["P_N"].double(), r["p_N"].double(), r["d"].double())
    rng = np.random.default_rng(0)
    for k in range(3):
        noisy = [b * (1 + ULP * torch.as_tensor(rng.standard_normal(b.shape),
                                                dtype=b.dtype)) for b in c["blocks"]]
        g = ric.riccati_sweep(c["h"], c["lm"], *noisy, r["P_N"], r["p_N"], r["d"])
        print("gains: 1-ulp noise on the blocks moves (K, kff) by %.3e, %.3e of scale"
              % tuple(scaled(g, port)))
    print("gains: port fp32 vs float64 (K, kff) %.3e, %.3e of scale"
          % tuple(scaled(port.double(), f64)))
    print("gains: JAX fp32 vs float64 (K, kff) %.3e, %.3e of scale"
          % tuple(scaled(jax32.double(), f64)))


def n100_step():
    from iterative_learning_nmpc_tpu_torch import flagship as F

    g = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_n100_golden.npz"))
    solver, _, _, p = F.flagship(device="cpu", n_nodes=100)
    B = 2
    rep = lambda a: torch.as_tensor(np.repeat(a[None], B, 0))
    X, U = rep(g["X_conv"]), rep(g["U_conv"])
    for std in (1e-3, 1e-4):
        x0 = (g["x0"][None] + std * np.random.default_rng(0).standard_normal((B, 36))
              ).astype(np.float32)
        pb = p.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
        pb = pb.replace(x0=torch.as_tensor(x0), lam_ineq=rep(g["lam_ineq_conv"]))
        U0 = solver.solve(X, U, pb, 1).U
        rng = np.random.default_rng(1)
        for k in range(3):
            Xn = X * (1 + ULP * torch.as_tensor(rng.standard_normal(X.shape),
                                                dtype=X.dtype))
            U1 = solver.solve(Xn, U, pb, 1).U
            r = [float(((U1[b] - U0[b]).abs() / (1 + U0[b].abs())).max()) for b in range(B)]
            print(f"N=100 step, x0 moved by {std:.0e}: 1-ulp noise on X moves rel |dU| "
                  f"per problem by {r[0]:.3e}, {r[1]:.3e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    gains()
    n100_step()
