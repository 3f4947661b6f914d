"""Write the golden of the generic tree dynamics, which the PyTorch port's
``models/tree_dynamics.py`` is held to.

Runs the JAX package's ``models/tree_dynamics.py`` on the CPU in float32 at
three random states of Go2 and of Solo12 (drawn as
``tests/test_structured_dynamics.py`` draws them, numpy seed 0) and stores
each function's output in ``tests/data/tree_dynamics_golden.npz``:
``{robot}_{q, v, a, f, tau}`` the inputs, ``{robot}_{function}`` the outputs.
Compiling the unrolled recursions takes about a minute, so the CPU test
(``tests/test_torch_tree_dynamics.py``) reads this file.

    python scripts/make_torch_tree_golden.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "tree_dynamics_golden.npz")
N_STATES = 3


def states(spec, rng, n):
    """n random (q, v, a, f, tau), as tests/test_structured_dynamics.py
    draws (q, v, a, f) and its forward-dynamics test draws tau."""
    out = []
    for _ in range(n):
        q = np.array(spec.q_home, dtype=np.float64)
        q[:3] += rng.uniform(-0.5, 0.5, 3)
        q[3:6] = rng.uniform(-0.4, 0.4, 3)
        q[6:] += rng.uniform(-0.4, 0.4, spec.nu)
        out.append((q, rng.uniform(-1.5, 1.5, spec.nv), rng.uniform(-6.0, 6.0, spec.nv),
                    rng.uniform(-40.0, 40.0, (4, 3)), rng.uniform(-8.0, 8.0, spec.nu)))
    return [np.asarray(x, np.float32) for x in zip(*out)]


def outputs(spec, q, v, a, f, tau):
    from iterative_learning_nmpc_tpu.models import tree_dynamics as t

    return dict(
        fk_R=t.fk_pos(spec, q)[0], fk_p=t.fk_pos(spec, q)[1],
        fk_w=t.fk_vel(spec, q, v).w, fk_vlin=t.fk_vel(spec, q, v).vlin,
        foot_positions=t.foot_positions(spec, q),
        foot_velocities=t.foot_velocities(spec, q, v),
        foot_jacobians=t.foot_jacobians(spec, q),
        rnea=t.rnea(spec, q, v, a, f_ext_feet=f),
        bias_forces=t.bias_forces(spec, q, v),
        mass_matrix=t.mass_matrix(spec, q),
        id_torques=t.id_torques(spec, q, v, a, f),
        com_position=t.com_position(spec, q),
        centroidal_momentum=t.centroidal_momentum(spec, q, v),
        centroidal_momentum_rate=t.centroidal_momentum_rate(spec, q, v, a),
        contact_wrench_about_com=t.contact_wrench_about_com(spec, q, f),
        forward_dynamics=t.forward_dynamics(spec, q, v, tau, f_ext_feet=f))


def main():
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec

    rng = np.random.default_rng(0)
    out = {}
    for name, spec in (("go2", go2_spec()), ("solo12", solo12_spec())):
        xs = states(spec, rng, N_STATES)
        res = jax.jit(jax.vmap(lambda *z, s=spec: outputs(s, *z)))(*map(jnp.asarray, xs))
        out.update({f"{name}_{k}": x for k, x in zip(("q", "v", "a", "f", "tau"), xs)})
        out.update({f"{name}_{k}": np.asarray(x) for k, x in res.items()})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.1f} kB)")


if __name__ == "__main__":
    main()
