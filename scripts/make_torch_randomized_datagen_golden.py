"""Write the reference that ``chip_smoke.py`` phase 26 holds the port's
randomized datagen to.

Draws B=256 randomized plants with the port's samplers (seeded CPU
``torch.Generator``s: ``randomize_payload``, ``randomize_terrain``,
``sample_force_windows`` over the 0.8 s rollout, the first half of the
envs push-free, as the DAgger loop keeps them) and the starts and commands
of the datagen CLI (numpy ``default_rng``: joint noise N(0, 0.03^2), vx
uniform in [0, 0.3)), runs the JAX package's ``make_batched_mpc_rollout``
(expert mode, 20 replanning intervals) on the CPU with the same plants,
and stores the inputs, the draws and each env's valid share in
``tests/data/go2_trot_randomized_datagen_golden.npz``. The card's machine
has no JAX; phase 26 draws again on the card, checks the draws equal the
stored ones, and compares its valid share with this run's.

It also stores the payload plants alone, without the controller: the
JAX package's ``jax_sim.step`` under ``jax.vmap(in_axes=payload_spec_axes)``
on the same 256 plants (payload, terrain and contact per env), from the
starts, with no joint torque and each env's push force
(``force_windows[:, 2:5]``, zero on the push-free half) held on for
PLANT_STEPS steps, its q and v at the PLANT_CHECK steps (the legs give
under the payload and the push; random torques of 2 Nm would flail them
to 85 rad/s, where fp32 libraries part by 0.3 rad/s in 50 steps). Phase 26 steps
the port's ``device_sim.step`` on the card from the same inputs and holds
it to these states, which no aggregate can hide: a push divided by the
wrong mass, a payload on the wrong env.

    python scripts/make_torch_randomized_datagen_golden.py   # ~4 min, 8 CPU threads
    python scripts/make_torch_randomized_datagen_golden.py --plant-only  # ~20 s: the
        # plant reference alone, the stored rollout's fields kept
"""
import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "go2_trot_randomized_datagen_golden.npz")
B, N_INTERVALS, SEED, NOISE, V_MAX = 256, 20, 26, 0.03, 0.3
PLANT_STEPS, PLANT_CHECK = 50, (10, 25, 50)


def port_draws(spec_t, n=B, seed=SEED):
    """The phase's inputs: starts (n, 36) and commands (n, 3) from numpy,
    the payload (mass, com), terrain and force windows from the port's
    samplers on seeded CPU generators."""
    from iterative_learning_nmpc_tpu_torch.learning.randomize import (
        randomize_payload, randomize_terrain, sample_force_windows)
    from iterative_learning_nmpc_tpu_torch.models.dynamics import settled_state

    rng = np.random.default_rng(seed)
    x0b = np.tile(settled_state(spec_t)[None], (n, 1))
    x0b[:, 6:18] += rng.normal(0, NOISE, (n, 12)).astype(np.float32)
    vd = np.zeros((n, 3), np.float32)
    vd[:, 0] = rng.uniform(0.0, V_MAX, n)
    gen = lambda k: torch.Generator().manual_seed(seed + k)
    ps = randomize_payload(spec_t, gen(0), n)
    tr = randomize_terrain(gen(1), n, device="cpu")
    fw = sample_force_windows(gen(2), n, N_INTERVALS * 40, device="cpu")
    fw[: n // 2] = 0.0
    npy = lambda t: t.numpy()
    return dict(x0=x0b, v_des=vd, mass=npy(ps.mass), com=npy(ps.com),
                ground_height=npy(tr.ground_height), stiffness=npy(tr.contact.stiffness),
                damping=npy(tr.contact.damping), friction_mu=npy(tr.contact.friction_mu),
                vel_smoothing=npy(tr.contact.vel_smoothing), force_windows=npy(fw))


def jax_plant(spec, ps, tr, d):
    """The payload plants alone: q, v at PLANT_CHECK of PLANT_STEPS steps of
    ``jax_sim.step`` under vmap, each env with its payload, contact and
    ground, no joint torque and its push held on."""
    from iterative_learning_nmpc_tpu.learning.randomize import payload_spec_axes
    from iterative_learning_nmpc_tpu.sim import jax_sim

    def one_env(s, cp, gh, q, f):
        def body(st, _):
            st = jax_sim.step(s, st, jnp.zeros(12), cp, 1e-3, f_ext=f, ground_height=gh)
            return st, (st.q, st.v)
        _, (Q, V) = jax.lax.scan(body, jax_sim.SimState(q, jnp.zeros(18), jnp.zeros(())),
                                 None, length=PLANT_STEPS)
        return Q, V

    run = jax.jit(jax.vmap(one_env, in_axes=(payload_spec_axes(spec), 0, 0, 0, 0)))
    Q, V = run(ps, tr.contact, tr.ground_height, jnp.asarray(d["x0"][:, :18]),
               jnp.asarray(d["force_windows"][:, 2:5]))
    k = np.asarray(PLANT_CHECK) - 1
    return dict(plant_q=np.asarray(Q)[:, k].transpose(1, 0, 2),
                plant_v=np.asarray(V)[:, k].transpose(1, 0, 2),
                plant_check=np.asarray(PLANT_CHECK))


def main():
    from iterative_learning_nmpc_tpu.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu.learning.randomize import TerrainParams
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.sim import jax_sim
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2

    ap = argparse.ArgumentParser()
    ap.add_argument("--plant-only", action="store_true",
                    help="recompute the plant reference alone, keep the stored rollout's")
    args = ap.parse_args()
    d = port_draws(torch_go2(device="cpu"))
    spec = go2_spec()
    ps = dataclasses.replace(spec, mass=jnp.asarray(d["mass"]), com=jnp.asarray(d["com"]))
    tr = TerrainParams(ground_height=jnp.asarray(d["ground_height"]),
                       contact=jax_sim.ContactParams(
                           *(jnp.asarray(d[k]) for k in ("stiffness", "damping",
                                                         "friction_mu", "vel_smoothing"))))
    d.update(jax_plant(spec, ps, tr, d))
    if args.plant_only:
        old = np.load(OUT)
        for k in d:
            if k in old.files and not k.startswith("plant_"):
                assert np.array_equal(old[k], d[k]), f"the draws of {k} moved"
        np.savez(OUT, **{**{k: old[k] for k in old.files if k != "plant_tau"}, **d})
        print(f"wrote {OUT} (plant reference; rollout fields kept)")
        return
    rollout = make_batched_mpc_rollout(spec, n_intervals=N_INTERVALS)
    t0 = time.time()
    out = rollout(jnp.asarray(d["x0"]), jnp.asarray(d["v_des"]), ps, tr,
                  force_windows=jnp.asarray(d["force_windows"]))
    jax.block_until_ready(out.q)
    valid = np.asarray(out.valid)
    z = np.asarray(out.q)[..., 2]
    pushed = np.arange(B) >= B // 2
    fell = valid[:, -1] < 0.5
    print(f"JAX on the CPU, B={B} x {N_INTERVALS} intervals, {time.time() - t0:.1f} s: "
          f"valid share {valid.mean():.4f} (push-free {valid[~pushed].mean():.4f}, pushed "
          f"{valid[pushed].mean():.4f}), fell {int(fell.sum())} ({int(fell[~pushed].sum())} "
          f"push-free), base z {z.min():.4f}..{z.max():.4f}, expert share "
          f"{np.asarray(out.is_expert).mean():.4f}")
    np.savez(OUT, **d, seed=SEED, n_intervals=N_INTERVALS, valid_env=valid.mean(axis=1),
             fell=fell)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
