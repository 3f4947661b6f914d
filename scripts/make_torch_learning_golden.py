"""Write the learning-stack goldens the PyTorch port is held to on the GPU.

Runs the JAX package on the CPU with the shipped policy
``assets/policy_go2_trot_ondevice_dagger.pkl`` from the standing pose of
the flagship instance, for B=2 environments: env 0 clean, env 1 with joint
noise N(0, 0.03^2) (numpy seed 0), both commanded 0.3 m/s forward, and
stores:

- ``tests/data/go2_trot_policy_rollout_golden.npz``: the inputs (q0, v0,
  v_des) and ``jax_sim.make_batched_policy_rollout``'s (Q, V, fell) over
  T=100 steps;
- ``tests/data/go2_trot_safedagger_golden.npz``: the inputs (x0, v_des, the
  SafeDAgger settings) and the rows of ``make_batched_mpc_rollout`` in
  SafeDAgger mode over 2 replanning intervals (80 control steps),
  ``delay_steps=20``, ``mpc_min_steps=60``.

The CPU tests (``tests/test_torch_policy.py``, ``tests/test_torch_ondevice.py``)
read their inputs from these files and hold the port to the live JAX
functions; the card's machine has no JAX, so ``chip_smoke.py`` holds the
port to the stored outputs.

    python scripts/make_torch_learning_golden.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
DATA = os.path.join(ROOT, "tests", "data")
ROLLOUT_OUT = os.path.join(DATA, "go2_trot_policy_rollout_golden.npz")
DAGGER_OUT = os.path.join(DATA, "go2_trot_safedagger_golden.npz")
B, T, V_DES, NOISE, SEED = 2, 100, 0.3, 0.03, 0
N_INTERVALS, DELAY_STEPS, MPC_MIN_STEPS = 2, 20, 60


def inputs(spec):
    """(q0 (B, 18), v0 (B, 18), v_des (B, 3)) float32."""
    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    q = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(dyn.foot_positions(spec, q))
    q[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    q0 = np.tile(q[None], (B, 1))
    rng = np.random.default_rng(SEED)
    q0[1:, 6:] += rng.normal(0, NOISE, (B - 1, 12)).astype(np.float32)
    v_des = np.zeros((B, 3), np.float32)
    v_des[:, 0] = V_DES
    return q0, np.zeros((B, 18), np.float32), v_des


def policy_rollout(spec, q0, v0, v_des, T):
    """The JAX package's policy rollout of the artifact (the apply of
    tests/test_policy_artifact.py): (Q, V, fell) as numpy."""
    from iterative_learning_nmpc_tpu.learning.network import load_policy
    from iterative_learning_nmpc_tpu.sim import jax_sim

    net, variables, norm = load_policy(ARTIFACT)
    mu_s, sd_s, mu_g, sd_g = [np.asarray(x, np.float32) for x in norm]
    sd_s = np.where(sd_s > 1e-8, sd_s, 1.0)

    def apply_fn(x):
        s, g = x[:44], x[44:]
        s = s.at[1:].set((s[1:] - mu_s[1:]) / sd_s[1:])
        g = (g - mu_g) / sd_g
        return net.apply(variables, jnp.concatenate([s, g])[None], train=False)[0]

    rollout = jax_sim.make_batched_policy_rollout(spec, apply_fn, T)
    return tuple(np.asarray(a) for a in rollout(q0, v0, v_des))


def safedagger_rollout(spec, x0, v_des, n_intervals):
    """The JAX package's on-device rollout in SafeDAgger mode with the
    artifact: the RolloutBatch fields as a dict of numpy arrays."""
    from iterative_learning_nmpc_tpu.learning.network import load_policy
    from iterative_learning_nmpc_tpu.learning.ondevice import make_batched_mpc_rollout

    rollout = make_batched_mpc_rollout(
        spec, n_intervals=n_intervals, policy=load_policy(ARTIFACT),
        delay_steps=DELAY_STEPS, mpc_min_steps=MPC_MIN_STEPS)
    out = rollout(jnp.asarray(x0), jnp.asarray(v_des))
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def main():
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    q0, v0, v_des = inputs(spec)
    Q, V, fell = policy_rollout(spec, q0, v0, v_des, T)
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(ROLLOUT_OUT, q0=q0, v0=v0, v_des=v_des, Q=Q, V=V, fell=fell)
    print(f"wrote {ROLLOUT_OUT}: x after {T} steps {Q[:, -1, 0]}, fell {fell}")

    x0 = np.concatenate([q0, v0], axis=1)
    rows = safedagger_rollout(spec, x0, v_des, N_INTERVALS)
    np.savez_compressed(DAGGER_OUT, x0=x0, v_des=v_des, n_intervals=N_INTERVALS,
                        delay_steps=DELAY_STEPS, mpc_min_steps=MPC_MIN_STEPS, **rows)
    print(f"wrote {DAGGER_OUT}: is_expert share {rows['is_expert'].mean():.3f}, "
          f"valid share {rows['valid'].mean():.3f}")


if __name__ == "__main__":
    main()
