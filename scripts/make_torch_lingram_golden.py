"""Write the JAX package's Gram blocks at the lingram stress case, which the
port's plain twin ``lingram_plain`` is held to.

The inputs are ``tests/test_torch_lingram_structure.stress_case`` at B=1,
N=25, seed 8 (every row group active; stance feet with exactly zero force
and no cone shift, s > 0 and s = 0 AL shifts, swing feet below the plane,
torque hinges past their limits). The blocks are the JAX package's jacfwd
path on the CPU (``solver/sqp.py:_linearize_stages`` and the einsum Gram of
tests/test_fast_linearize.py), with the torque-hinge rows, once with every
row group on ("all") and once for each row group of
``ops/lingram.ROW_GROUPS`` alone. Inputs and blocks go to
``tests/data/go2_trot_lingram_stress_golden.npz``;
``tests/test_torch_lingram_structure.py`` reads them without JAX.

    python scripts/make_torch_lingram_golden.py
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(ROOT, "tests", "data", "go2_trot_lingram_stress_golden.npz")
N_NODES, B, SEED = 25, 1, 8


def main():
    import jax.numpy as jnp

    from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu.ocp.problem import OCPParams as JParams
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
    from iterative_learning_nmpc_tpu.solver import sqp as jsqp
    from iterative_learning_nmpc_tpu_torch.ops.lingram import ROW_GROUPS, isolate_group
    from test_torch_lingram_structure import go2_solver, stress_case

    solver = go2_solver(N_NODES)
    X, U, p = stress_case(solver, B, seed=SEED)
    _, opt, cost = get_quadruped_config("trot", "go2")
    opt.n_nodes, opt.time_horizon = N_NODES, N_NODES * 0.04
    jsolver = jsqp.TrajOptSolver(jax_go2(), opt, cost)
    for f in dataclasses.fields(jsolver.weights):
        np.testing.assert_allclose(np.asarray(getattr(jsolver.weights, f.name)),
                                   getattr(solver.weights, f.name).numpy(), rtol=1e-6,
                                   err_msg=f.name)
    pn = {f.name: getattr(p, f.name).numpy() for f in dataclasses.fields(p)}
    jp = JParams(**{k: jnp.asarray(v) for k, v in pn.items()})

    @jax.jit
    def gram(w, X, U, p):
        r, Jx, Ju = jax.vmap(lambda X_, U_, p_: jsqp._linearize_stages(
            jsolver.spec, w, X_, U_, p_, include_torque=True))(X, U, p)
        return (jnp.einsum("bnri,bnrj->bnij", Jx, Jx), jnp.einsum("bnri,bnrj->bnij", Ju, Ju),
                jnp.einsum("bnri,bnrj->bnij", Jx, Ju), jnp.einsum("bnri,bnr->bni", Jx, r),
                jnp.einsum("bnri,bnr->bni", Ju, r))

    out = {"X": X.numpy(), "U": U.numpy(), **{f"p_{k}": v for k, v in pn.items()}}
    for label in ("all", *ROW_GROUPS):
        w = jsolver.weights
        if label != "all":
            zero = isolate_group(solver.weights, label)
            w = dataclasses.replace(w, **{f.name: jnp.asarray(getattr(zero, f.name).numpy())
                                          for f in dataclasses.fields(w)})
        blocks = gram(w, jnp.asarray(out["X"]), jnp.asarray(out["U"]), jp)
        for name, b in zip(("Q", "R", "M", "qx", "ru"), blocks):
            out[f"{label}_{name}"] = np.asarray(b, np.float32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
