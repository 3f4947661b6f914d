"""Write the closed-loop golden the PyTorch port's controller is held to on
the GPU.

Runs the JAX package's ``LocomotionMPC`` on the CPU (Go2 trot, sync mode,
phase-aligned cold boot, 0.3 m/s command) for its first replan from the
standing state of the flagship instance, and stores in
``tests/data/go2_trot_closed_loop_golden.npz``:

- the standing state (q0, v0) and the command,
- the boot: the merit probe's costs over the 12 gait-phase offsets and the
  offset it picked,
- the first plan (15 SQP iterations from the cold start): the solution
  (X, U), the multipliers it hands to the next replan, and the
  interpolated plan at the control rate (q_plan, v_plan, tau_ff).

The card's machine has no JAX, so ``chip_smoke.py`` gates the port's
controller against this file.

    python scripts/make_torch_closed_loop_golden.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(ROOT, "tests", "data", "go2_trot_closed_loop_golden.npz")
V_DES = 0.3


def standing_state(spec):
    """The flagship's standing pose: q_home with the feet on the ground."""
    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(dyn.foot_positions(spec, q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    return q0.astype(np.float64), np.zeros(18)


def main():
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    spec = go2_spec()
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False,
                        phase_aligned_boot=True)
    probe = {}
    boot = mpc._boot_jit

    def recorded_boot(params):
        out = boot(params)
        probe["costs"] = np.asarray(out[2])
        return out

    mpc._boot_jit = recorded_boot
    q0, v0 = standing_state(spec)
    mpc.set_command(np.array([V_DES, 0.0, 0.0]))
    q_plan, v_plan, _, _, tau_ff = mpc.optimize(q0, v0)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, q0=q0, v0=v0, v_des=np.array([V_DES, 0.0, 0.0]),
        probe_costs=probe["costs"], boot_offset=np.int64(mpc.boot_offsets[0]),
        X=np.asarray(mpc._X_prev), U=np.asarray(mpc._U_prev),
        lam=np.asarray(mpc._lam_prev), lami=np.asarray(mpc._lami_prev),
        q_plan=q_plan, v_plan=v_plan, tau_ff=tau_ff)
    print(f"wrote {OUT}: boot offset {mpc.boot_offsets[0]}, "
          f"probe costs {probe['costs'].min():.2f}..{probe['costs'].max():.2f}")


if __name__ == "__main__":
    main()
