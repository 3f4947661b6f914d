"""Write the goldens of the controller's other modes, the second robot and
the policy warm starts, which the PyTorch port is held to.

Runs the JAX package on the CPU and stores, under ``tests/data/``:

- ``go2_trot_raibert_golden.npz``: ``LocomotionMPC(contact_planner=
  "raibert")`` (Go2 trot, sync mode) from the standing state at 0.3 m/s:
  the first plan's footsteps ``cnt_loc``, base references, (X, U) and the
  interpolated plan (q_plan, tau_ff);
- ``go2_trot_custom_golden.npz``: ``contact_planner="custom"`` with a fixed
  footstep table (the standing footholds at the Raibert planner's foot
  height, 6 cm further forward each cycle; a location with a zero
  coordinate would count as not given):
  the table, ``cnt_loc``, base references and (X, U);
- ``go2_acyclic_golden.npz``: ``AcyclicMPC`` with the contact sequence of
  the trot and 6 cm square patches at the standing footholds (15 first-solve
  iterations, 0.2 m/s; with its interpolated plan), and the standing hop
  (an all-flight window of nodes 10..13, 30 first-solve iterations): each
  first plan's (X, U);
- ``solo12_trot_golden.npz``: ``LocomotionMPC(solo12_spec())`` (sync,
  phase-aligned boot) at 0.2 m/s: the boot's probe costs and offset, the
  first plan's (X, U) and interpolated plan;
- ``go2_trot_policy_warmstart_golden.npz``: ``policy_warmstart`` and
  ``phase_aligned_warmstart`` with ``assets/policy_go2_trot_ondevice_dagger.pkl``
  for 4 problems of the flagship instance (problem 0 the standing state,
  the others with joint noise N(0, 0.03^2), numpy seed 0; 0.3 m/s): their
  inputs, (X, U) and offsets.

The CPU tests (``tests/test_torch_controller_modes.py``,
``tests/test_torch_warmstart.py``) and ``chip_smoke.py`` phases 22-25 read
these files; no tier-1 test compiles a JAX controller.

``--closed-loops`` instead runs the JAX controllers on the JAX device plant
(``sim/jax_sim``) for the closed-loop scenarios of phases 22-24 (Solo12's
trot and push, the Raibert trot, the standing hop) and prints what the
gates read, which settles the gates those phases hold the port to.

    python scripts/make_torch_controller_modes_golden.py [--closed-loops]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
V_GO2, V_SOLO12, V_ACYCLIC = 0.3, 0.2, 0.2
N_WS, NOISE, SEED = 4, 0.03, 0
CUSTOM_STRIDE, CUSTOM_CYCLES = 0.06, 4
PATCH = 0.06                              # square patch side, m
HOP_FLIGHT = (10, 14)                     # all-flight nodes [10, 14)


def standing_state(spec):
    """q_home with the feet on the ground, at rest: (q0 (18,), v0 (18,))."""
    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(dyn.foot_positions(spec, q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    return q0.astype(np.float64), np.zeros(18)


def plan_record(mpc, plan):
    q_plan, v_plan, _, _, tau_ff = plan
    return dict(X=np.asarray(mpc._X_prev), U=np.asarray(mpc._U_prev),
                base_ref=mpc._last_base_ref, base_ref_e=mpc._last_base_ref_e,
                q_plan=q_plan, tau_ff=tau_ff)


def custom_table(spec, q0):
    """(CUSTOM_CYCLES, 4, 3) footholds: the standing feet at the foot height
    the Raibert planner gives (0.0085 m), CUSTOM_STRIDE further forward each
    cycle."""
    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    p = np.asarray(dyn.foot_positions(spec, np.asarray(q0, np.float32)), np.float64)
    p[:, 2] = 0.0085
    return np.stack([p + [CUSTOM_STRIDE * i, 0.0, 0.0] for i in range(CUSTOM_CYCLES)])


def acyclic_patch_case(spec, q0, N):
    """The contact sequence and patches of the patch scenario: the trot's
    contacts over 2 (N+1) nodes, 6 cm squares at the standing footholds."""
    from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner
    from iterative_learning_nmpc_tpu.models import dynamics as dyn
    from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config

    gait, opt, _ = get_quadruped_config("trot", spec.name)
    T = 2 * (N + 1)
    seq = ContactPlanner(spec.feet_frame_names, opt.get_dt_nodes(), gait).get_contacts(0, T)
    p_feet = np.asarray(dyn.foot_positions(spec, jnp.asarray(q0)))
    centers = np.zeros((4, T, 3), np.float32)
    centers[:, :, :2] = p_feet[:, None, :2]
    return seq, centers, np.zeros((4, T), np.float32), np.full((4, T, 2), PATCH, np.float32)


def hop_sequence():
    cnt = np.ones((4, 80))
    cnt[:, HOP_FLIGHT[0]:HOP_FLIGHT[1]] = 0.0
    return cnt


def controller_goldens():
    from iterative_learning_nmpc_tpu.mpc.acyclic import AcyclicMPC
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec

    go2 = go2_spec()
    q0, v0 = standing_state(go2)

    mpc = LocomotionMPC(go2, gait_name="trot", contact_planner="raibert", solve_async=False)
    mpc.set_command(np.array([V_GO2, 0.0, 0.0]))
    rec = plan_record(mpc, mpc.optimize(q0, v0))
    out = os.path.join(DATA, "go2_trot_raibert_golden.npz")
    np.savez_compressed(out, q0=q0, v0=v0, v_des=np.array([V_GO2, 0.0, 0.0]),
                        cnt_loc=mpc._last_cnt_loc, **rec)
    print(f"wrote {out}: base_ref {rec['base_ref'][:3]}, |U| {np.abs(rec['U']).max():.2f}")

    mpc = LocomotionMPC(go2, gait_name="trot", contact_planner="custom", solve_async=False)
    table = custom_table(go2, q0)
    mpc.contact_planner.set_contact_locations(table)
    mpc.set_command(np.array([V_GO2, 0.0, 0.0]))
    rec = plan_record(mpc, mpc.optimize(q0, v0))
    out = os.path.join(DATA, "go2_trot_custom_golden.npz")
    np.savez_compressed(out, q0=q0, v0=v0, v_des=np.array([V_GO2, 0.0, 0.0]), table=table,
                        cnt_loc=mpc._last_cnt_loc, **rec)
    print(f"wrote {out}: base_ref {rec['base_ref'][:3]}")

    mpc = AcyclicMPC(go2, gait_name="trot", n_sqp_first=15, solve_async=False,
                     compute_timings=False)
    N = mpc.config_opt.n_nodes
    seq, centers, rotations, sizes = acyclic_patch_case(go2, q0, N)
    mpc.set_contact_sequence(seq)
    mpc.set_patches(centers, rotations, sizes)
    mpc.set_command(np.array([V_ACYCLIC, 0.0, 0.0]), 0.0)
    q_plan, _, _, _, tau_ff = mpc.optimize(q0, v0)
    patch = dict(X=np.asarray(mpc._X_prev), U=np.asarray(mpc._U_prev), q_plan=q_plan,
                 tau_ff=tau_ff)
    mpc = AcyclicMPC(go2, gait_name="trot", n_sqp_first=30, solve_async=False)
    mpc.set_contact_sequence(hop_sequence())
    mpc.set_command(np.array([0.0, 0.0, 0.0]), 0.0)
    mpc.optimize(q0, v0)
    out = os.path.join(DATA, "go2_acyclic_golden.npz")
    np.savez_compressed(out, q0=q0, v0=v0, seq=seq, centers=centers, sizes=sizes,
                        X_patch=patch["X"], U_patch=patch["U"], q_plan=patch["q_plan"],
                        tau_ff=patch["tau_ff"], hop_cnt=hop_sequence(),
                        X_hop=np.asarray(mpc._X_prev), U_hop=np.asarray(mpc._U_prev))
    print(f"wrote {out}: hop apex {np.asarray(mpc._X_prev)[:, 2].max():.4f} m")

    solo = solo12_spec()
    q0s, v0s = standing_state(solo)
    mpc = LocomotionMPC(solo, gait_name="trot", solve_async=False, phase_aligned_boot=True)
    probe = {}
    boot = mpc._boot_jit
    mpc._boot_jit = lambda p: probe.setdefault("out", boot(p))
    mpc.set_command(np.array([V_SOLO12, 0.0, 0.0]))
    rec = plan_record(mpc, mpc.optimize(q0s, v0s))
    out = os.path.join(DATA, "solo12_trot_golden.npz")
    np.savez_compressed(out, q0=q0s, v0=v0s, v_des=np.array([V_SOLO12, 0.0, 0.0]),
                        probe_costs=np.asarray(probe["out"][2]),
                        boot_offset=np.int64(mpc.boot_offsets[0]), **rec)
    print(f"wrote {out}: boot offset {mpc.boot_offsets[0]}")


def policy_apply():
    """The shipped policy's (47,) -> (12,) PD targets (the apply of
    scripts/make_torch_learning_golden.py)."""
    from iterative_learning_nmpc_tpu.learning.network import load_policy

    net, variables, norm = load_policy(ARTIFACT)
    mu_s, sd_s, mu_g, sd_g = [np.asarray(x, np.float32) for x in norm]
    sd_s = np.where(sd_s > 1e-8, sd_s, 1.0)

    def apply_fn(x):
        s, g = x[:44], x[44:]
        s = s.at[1:].set((s[1:] - mu_s[1:]) / sd_s[1:])
        g = (g - mu_g) / sd_g
        return net.apply(variables, jnp.concatenate([s, g])[None], train=False)[0]

    return apply_fn


def warmstart_golden():
    import dataclasses

    from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner
    from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.solver.sqp import TrajOptSolver, make_params
    from iterative_learning_nmpc_tpu.solver.warmstart import (
        contact_windows, phase_aligned_warmstart, policy_warmstart)

    spec = go2_spec()
    gait, opt, cost = get_quadruped_config("trot", "go2")
    solver = TrajOptSolver(spec, opt, cost)
    N = solver.N
    planner = ContactPlanner(spec.feet_frame_names, solver.dt_nodes, gait)
    windows = contact_windows(planner, N)
    q0, _ = standing_state(spec)
    x0 = np.tile(np.concatenate([q0, np.zeros(18)]).astype(np.float32), (N_WS, 1))
    rng = np.random.default_rng(SEED)
    x0[1:, 6:18] += rng.normal(0, NOISE, (N_WS - 1, 12)).astype(np.float32)
    v_des = np.array([V_GO2, 0.0, 0.0], np.float32)
    cnt = planner.get_contacts(0, N + 1).astype(np.float32)
    base_ref = np.zeros(12, np.float32)
    base_ref[:3] = q0[:3]
    base_ref[2] = gait.nom_height
    params = make_params(solver, x0[0], cnt, base_ref=base_ref,
                         step_height=gait.step_height,
                         ground_height=float(np.asarray(spec.foot_radius)))
    apply_fn = policy_apply()

    def both(x):
        p = dataclasses.replace(params, x0=x)
        X1, U1 = policy_warmstart(solver, apply_fn, p, v_des)
        X2, U2, p2, off = phase_aligned_warmstart(solver, apply_fn, p, v_des, windows)
        return X1, U1, X2, U2, p2.cnt, off

    t0 = time.perf_counter()
    X1, U1, X2, U2, cnt2, off = (np.asarray(a) for a in jax.jit(jax.vmap(both))(x0))
    out = os.path.join(DATA, "go2_trot_policy_warmstart_golden.npz")
    np.savez_compressed(out, x0=x0, v_des=v_des, cnt=cnt, base_ref=base_ref,
                        windows=windows, X_policy=X1, U_policy=U1, X_aligned=X2,
                        U_aligned=U2, cnt_aligned=cnt2, offset=off)
    print(f"wrote {out} in {time.perf_counter() - t0:.1f} s: offsets {off}, "
          f"final base x {X1[:, -1, 0]}")


# ---------------------------------------------------------------------------
class PlantData:
    time, qpos, qvel = 0.0, None, None


def jax_closed_loop(spec, mpc, q0, seconds, pushes=()):
    """The controller on the JAX device plant for ``seconds`` at 1 kHz, with
    (start, end, force) base pushes; returns the chart states (steps + 1,
    18) and the control steps' wall."""
    from iterative_learning_nmpc_tpu.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu.sim import jax_sim

    cp = jax_sim.contact_params_for(spec)
    step = jax.jit(lambda st, tau, f: jax_sim.step(spec, st, tau, cp, mpc.sim_dt, f_ext=f))
    st = jax_sim.SimState(jnp.asarray(q0, jnp.float32), jnp.zeros(18, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))
    data, qs = PlantData(), []
    n = int(round(seconds / mpc.sim_dt))
    t0 = time.perf_counter()
    for i in range(n):
        t = i * mpc.sim_dt
        f = np.zeros(3, np.float32)
        for a, b, force in pushes:
            if a <= t < b:
                f += np.asarray(force, np.float32)
        x = np.asarray(jnp.concatenate([st.q, st.v]), np.float64)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = t
        mpc.compute_torques_dof(data)
        st = step(st, jnp.asarray(mpc.torques_dof[-mpc.nu:], jnp.float32), jnp.asarray(f))
        qs.append(x[:18])
    qs.append(np.asarray(st.q, np.float64))
    return np.asarray(qs), time.perf_counter() - t0


def fall_time(qs, nom_height, dt=1e-3):
    """The first time the base is below half the nominal height or tilted
    beyond 25 degrees, or None."""
    bad = (qs[:, 2] < 0.5 * nom_height) | (np.degrees(np.abs(qs[:, 4:6])).max(1) > 25.0)
    return float(np.argmax(bad) * dt) if bad.any() else None


def report(name, qs, mpc, q0, seconds, nom_height):
    z, tilt = qs[:, 2], np.abs(qs[:, 4:6])
    qf = np.vstack(mpc.q_full) if mpc.q_full else qs
    half = len(qf) // 2
    t_fall = fall_time(qs, nom_height)
    upto = qs[: int(round(t_fall / 1e-3))] if t_fall else qs
    print(f"[{name}] {seconds} s: fell at {t_fall} s (before it: z {upto[:, 2].min():.4f}.."
          f"{upto[:, 2].max():.4f}, max |roll| {np.abs(upto[:, 5]).max():.4f}, vx "
          f"{(upto[-1, 0] - q0[0]) / max(len(upto) * 1e-3, 1e-9):.4f} m/s); "
          f"z {z.min():.4f}..{z.max():.4f} (final {z[-1]:.4f}), "
          f"max |pitch| {tilt[:, 0].max():.4f}, max |roll| {tilt[:, 1].max():.4f} rad, "
          f"mean vx {(qs[-1, 0] - q0[0]) / seconds:.4f} m/s, controller's q: max |roll| "
          f"{np.abs(qf[:, 5]).max():.4f}, second-half mean z {qf[half:, 2].mean():.4f}, "
          f"max z {qf[:, 2].max():.4f}; fallen (z < {0.5 * nom_height:.3f} or tilt > 25 deg) "
          f"{bool(z.min() < 0.5 * nom_height or np.degrees(tilt).max() > 25.0)}, "
          f"diverged {mpc.diverged}", flush=True)


def closed_loops():
    from iterative_learning_nmpc_tpu.mpc.acyclic import AcyclicMPC
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec

    solo = solo12_spec()
    q0, _ = standing_state(solo)
    mpc = LocomotionMPC(solo, gait_name="trot", solve_async=False)
    mpc.set_command(np.array([V_SOLO12, 0.0, 0.0]))
    qs, wall = jax_closed_loop(solo, mpc, q0, 2.0)
    report("solo12 trot 0.2 m/s", qs, mpc, q0, 2.0, mpc.config_gait.nom_height)
    mpc = LocomotionMPC(solo, gait_name="trot", solve_async=True, async_sim_latency=0.02)
    mpc.set_command(np.array([0.25, 0.0, 0.0]))
    qs, wall = jax_closed_loop(solo, mpc, q0, 3.0, pushes=((1.2, 1.4, (8.0, 4.0, 0.0)),))
    report("solo12 push 8 N / 4 N at 1.2-1.4 s, 0.25 m/s", qs, mpc, q0, 3.0,
           mpc.config_gait.nom_height)
    mpc.executor.shutdown(wait=True)

    go2 = go2_spec()
    q0, v0 = standing_state(go2)
    mpc = LocomotionMPC(go2, gait_name="trot", contact_planner="raibert", solve_async=False)
    mpc.set_command(np.array([V_GO2, 0.0, 0.0]))
    qs, wall = jax_closed_loop(go2, mpc, q0, 2.0)
    report("go2 raibert trot 0.3 m/s", qs, mpc, q0, 2.0, mpc.config_gait.nom_height)

    mpc = AcyclicMPC(go2, gait_name="trot", n_sqp_first=30, solve_async=False)
    mpc.set_contact_sequence(hop_sequence())
    mpc.set_command(np.array([0.0, 0.0, 0.0]), 0.0)
    mpc.optimize(q0, v0)
    z0 = float(np.asarray(mpc._X_prev)[0, 2])
    qs, wall = jax_closed_loop(go2, mpc, q0, 2.5)
    report(f"go2 standing hop (plan z0 {z0:.4f})", qs, mpc, q0, 2.5,
           mpc.config_gait.nom_height)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--closed-loops", action="store_true")
    args = ap.parse_args()
    if args.closed_loops:
        closed_loops()
        return
    os.makedirs(DATA, exist_ok=True)
    controller_goldens()
    warmstart_golden()


if __name__ == "__main__":
    main()
