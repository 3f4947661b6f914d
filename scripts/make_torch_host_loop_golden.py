"""Write the golden of the host MuJoCo plant's controllers and of Go2's push
recovery and turning, which the PyTorch port is held to.

Runs the JAX package on the CPU and stores ``tests/data/go2_host_loop_golden.npz``:

- ``rollout_mpc`` (Go2 trot, sync, 0.3 m/s) in MuJoCo for 0.2 s: the first
  plan's (X, U) and boot offset, and every recorder row (``mpc_*``);
- ``rollout_combined`` with the shipped policy
  (``assets/policy_go2_trot_ondevice_dagger.pkl``, 0.3 m/s, ``delay_steps``
  100, ``mpc_min_steps`` 200, monitor v2) in MuJoCo for 0.2 s: the first
  plan, every recorder row and ``mode_log`` (``comb_*``);
- the JAX ``LocomotionMPC`` on the JAX device plant (``sim/jax_sim``, 1
  kHz, sync, from the settled standing state) for the scenarios of
  ``chip_smoke.py`` phase 27: the push (zero command, 40 N in x and 20 N
  in y on the trunk over 0.7-0.9 s, 1.6 s), the turn (0.2 m/s, ``w_yaw``
  0.4, 2.0 s) and the combined controller (the shipped policy at
  ``COMB_V`` with the MPC, ``delay_steps`` 100, ``mpc_min_steps`` 200,
  monitor v2, pushed by ``COMB_PUSH``, 1.0 s; its policy reads the feet
  from the plant state through a simulator stand-in), and the same without
  the push, which shows that the push trips the monitor first: the chart
  base states every 10 ms, the fall time (-1 for none), the final yaw and,
  for the combined runs, the times the mode switches (``push_*``,
  ``turn_*``, ``plant_comb_*``, ``plant_comb_nopush_*``);
- a Solo12 replan from the state of ``tests/data/solo12_trot_golden.npz``
  (sync, phase-aligned boot): the ``SolveStats.sqp_iters`` and
  ``qp_iters`` of the cold first solve and of an RTI replan from the same
  state after it (``solo12_*``).

The CPU tests (``tests/test_torch_rollouts.py``,
``tests/test_torch_combined_rollout.py``, ``tests/test_torch_solo12_stats.py``)
and ``chip_smoke.py`` phase 27 read it; no tier-1 test runs a JAX
controller.

    python scripts/make_torch_host_loop_golden.py [--combined-only]

``--combined-only`` reruns the two combined runs alone and rewrites their
keys, keeping the rest of the file.
"""
import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")
OUT = os.path.join(DATA, "go2_host_loop_golden.npz")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
ROLL_S, ROLL_V = 0.2, 0.3
DELAY_STEPS, MPC_MIN_STEPS = 100, 200
PUSH_S, PUSH = 1.6, ((0.7, 0.9, (40.0, 20.0, 0.0)),)
TURN_S, TURN_V, TURN_W = 2.0, 0.2, 0.4
COMB_S, COMB_V, COMB_PUSH = 1.0, 0.15, ((0.2, 0.3, (0.0, 30.0, 0.0)),)
EVERY = 10                               # steps between stored base states


def standing_state(spec):
    """q_home with the feet on the ground, at rest: (q0 (18,), v0 (18,))."""
    from iterative_learning_nmpc_tpu.models import dynamics as dyn

    q0 = np.asarray(spec.q_home, np.float32).copy()
    p0 = np.asarray(dyn.foot_positions(spec, q0))
    q0[2] += -p0[0, 2] + float(np.asarray(spec.foot_radius))
    return q0.astype(np.float64), np.zeros(18)


def recording_mpc_class():
    """A LocomotionMPC that keeps its first plan's (X, U) and boot offset."""
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC

    class Recording(LocomotionMPC):
        first = None

        def optimize(self, q, v):
            out = super().optimize(q, v)
            if Recording.first is None:
                Recording.first = dict(X=np.asarray(self._X_prev), U=np.asarray(self._U_prev),
                                       boot_offset=np.int64(self.boot_offsets[0]))
            return out

    return Recording


def rows(recorder, prefix):
    return {f"{prefix}_{k}": np.asarray(v) for k, v in recorder.data.items()}


def mujoco_rollouts():
    from iterative_learning_nmpc_tpu.learning import rollouts
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    go2 = go2_spec()
    out = {}
    v_des = np.array([ROLL_V, 0.0, 0.0])
    orig_mpc, orig_comb = rollouts.LocomotionMPC, rollouts.CombinedController
    seen = {}

    class Combined(orig_comb):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["combined"] = self

    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in ("mpc", "comb"):
                rollouts.LocomotionMPC = recording_mpc_class()
                rollouts.CombinedController = Combined
                t0 = time.perf_counter()
                if name == "mpc":
                    res = rollouts.rollout_mpc(go2, sim_time=ROLL_S, v_des=v_des, record_dir=tmp)
                else:
                    res = rollouts.rollout_combined(
                        go2, ARTIFACT, sim_time=ROLL_S, v_des=v_des, record_dir=tmp,
                        delay_steps=DELAY_STEPS, mpc_min_steps=MPC_MIN_STEPS)
                    out["comb_mode_log"] = np.asarray(seen["combined"].mode_log, bool)
                first = rollouts.LocomotionMPC.first
                out.update({f"{name}_{k}": v for k, v in first.items()})
                out.update(rows(res.recorder, name))
                print(f"[rollout_{name}] {ROLL_S} s in MuJoCo: {res.sim}, "
                      f"{len(res.recorder.data['time'])} rows, boot offset "
                      f"{int(first['boot_offset'])}; {time.perf_counter() - t0:.1f} s",
                      flush=True)
        finally:
            rollouts.LocomotionMPC, rollouts.CombinedController = orig_mpc, orig_comb
    print(f"[rollout_comb] expert from step {int(np.argmax(out['comb_mode_log']))}, "
          f"{int(out['comb_mode_log'].sum())} expert steps of {len(out['comb_mode_log'])}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
class PlantData:
    time, qpos, qvel = 0.0, None, None


class PlantStandIn:
    """What the policy controller reads of a simulator: ``spec``,
    ``foot_geoms`` and ``data.geom_xpos`` (the feet, from the plant state)."""

    foot_geoms = {0: "FL", 1: "FR", 2: "RL", 3: "RR"}

    def __init__(self, spec):
        from iterative_learning_nmpc_tpu.models import dynamics as dyn

        self.spec = spec
        self.data = PlantData()
        self.data.geom_xpos = np.zeros((4, 3))
        self._feet = jax.jit(lambda q: dyn.foot_positions(spec, q))

    def update(self, q):
        self.data.geom_xpos = np.asarray(self._feet(jnp.asarray(q, jnp.float32)), np.float64)


def jax_loop(spec, controller, q0, seconds, pushes=(), standin=None, dt=1e-3):
    """``controller`` on the JAX device plant for ``seconds`` from (q0, 0):
    the chart states (steps + 1, 18)."""
    from iterative_learning_nmpc_tpu.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu.sim import jax_sim

    cp = jax_sim.contact_params_for(spec)
    step = jax.jit(lambda st, tau, f: jax_sim.step(spec, st, tau, cp, dt, f_ext=f))
    st = jax_sim.SimState(jnp.asarray(q0, jnp.float32), jnp.zeros(18, jnp.float32),
                          jnp.asarray(0.0, jnp.float32))
    data, qs = PlantData(), []
    n = int(round(seconds / dt))
    for i in range(n):
        t = i * dt
        f = np.zeros(3, np.float32)
        for a, b, force in pushes:
            if a <= t < b:
                f += np.asarray(force, np.float32)
        x = np.asarray(jnp.concatenate([st.q, st.v]), np.float64)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = t
        if standin is not None:
            standin.update(x[:18])
        controller.compute_torques_dof(data)
        st = step(st, jnp.asarray(controller.torques_dof[-spec.nu:], jnp.float32),
                  jnp.asarray(f))
        qs.append(x[:18])
    qs.append(np.asarray(st.q, np.float64))
    return np.asarray(qs)


def fall_time(qs, nom_height, dt=1e-3):
    """The first time the base is below half the nominal height or tilted
    beyond 25 degrees, or -1."""
    bad = (qs[:, 2] < 0.5 * nom_height) | (np.degrees(np.abs(qs[:, 4:6])).max(1) > 25.0)
    return float(np.argmax(bad) * dt) if bad.any() else -1.0


def switch_times(mode_log, dt=1e-3):
    m = np.asarray(mode_log, np.int8)
    return (np.flatnonzero(np.diff(np.concatenate([[0], m]))) * dt).astype(np.float64)


def push_turn_loops():
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    go2 = go2_spec()
    q0, _ = standing_state(go2)
    out = {"plant_q0": q0}
    for name, v, w, seconds, pushes in (("push", 0.0, 0.0, PUSH_S, PUSH),
                                        ("turn", TURN_V, TURN_W, TURN_S, ())):
        t0 = time.perf_counter()
        mpc = LocomotionMPC(go2, gait_name="trot", solve_async=False)
        mpc.set_command(np.array([v, 0.0, 0.0]), w)
        qs = jax_loop(go2, mpc, q0, seconds, pushes)
        nom = mpc.config_gait.nom_height
        out.update({f"{name}_qs": qs[::EVERY], f"{name}_fall": fall_time(qs, nom),
                    f"{name}_yaw": float(qs[-1, 3])})
        print(f"[{name}] {seconds} s on the JAX device plant: fell at {out[name + '_fall']} s, "
              f"final z {qs[-1, 2]:.4f}, yaw {qs[-1, 3]:.4f}, max |pitch|, |roll| "
              f"{np.abs(qs[:, 4]).max():.4f}, {np.abs(qs[:, 5]).max():.4f}, x, y "
              f"{qs[-1, 0]:.4f}, {qs[-1, 1]:.4f}; {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def combined_loops():
    from iterative_learning_nmpc_tpu.learning.combined_controller import CombinedController
    from iterative_learning_nmpc_tpu.learning.policy_controller import PolicyController
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec

    go2 = go2_spec()
    q0, _ = standing_state(go2)
    out = {"plant_comb_v": np.float64(COMB_V),
           "plant_comb_push": np.asarray([[a, b, *f] for a, b, f in COMB_PUSH], np.float64)}
    v_des = np.array([COMB_V, 0.0, 0.0])
    for name, pushes in (("plant_comb", COMB_PUSH), ("plant_comb_nopush", ())):
        t0 = time.perf_counter()
        standin = PlantStandIn(go2)
        mpc = LocomotionMPC(go2, gait_name="trot", solve_async=False)
        policy = PolicyController(standin, ARTIFACT, v_des=v_des)
        comb = CombinedController(standin, mpc, policy, v_des=v_des,
                                  delay_steps=DELAY_STEPS, mpc_min_steps=MPC_MIN_STEPS)
        comb.set_command(v_des)
        qs = jax_loop(go2, comb, q0, COMB_S, pushes, standin=standin)
        sw = switch_times(comb.mode_log)
        out.update({f"{name}_qs": qs[::EVERY],
                    f"{name}_fall": fall_time(qs, mpc.config_gait.nom_height),
                    f"{name}_yaw": float(qs[-1, 3]), f"{name}_switch": sw,
                    f"{name}_expert_steps": np.int64(np.sum(comb.mode_log))})
        print(f"[{name}] {COMB_S} s at {COMB_V} m/s, pushed {pushes}: fell at "
              f"{out[name + '_fall']} s, switches at {sw} s, {int(np.sum(comb.mode_log))} "
              f"expert steps, final z {qs[-1, 2]:.4f}, x {qs[-1, 0]:.4f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def solo12_stats():
    from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu.robots.solo12 import solo12_spec

    g = np.load(os.path.join(DATA, "solo12_trot_golden.npz"))
    mpc = LocomotionMPC(solo12_spec(), gait_name="trot", solve_async=False)
    stats = []
    plan = mpc._plan_jit

    def recording(*a):
        res = plan(*a)
        stats.append(res[-1])
        return res

    mpc._plan_jit = recording
    mpc.set_command(g["v_des"])
    mpc.optimize(g["q0"], g["v0"])
    mpc.first_solve = False
    mpc.optimize(g["q0"], g["v0"])
    out = {"solo12_sqp_iters": np.array([int(s.sqp_iters) for s in stats]),
           "solo12_qp_iters": np.array([int(s.qp_iters) for s in stats]),
           "solo12_cost": np.array([float(s.cost) for s in stats])}
    print(f"[solo12] first solve and RTI replan: sqp_iters {out['solo12_sqp_iters']}, "
          f"qp_iters {out['solo12_qp_iters']}, cost {out['solo12_cost']}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--combined-only", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.combined_only:
        out = dict(np.load(OUT))
        out.update(combined_loops())
    else:
        out = {"roll_v": np.float64(ROLL_V), "delay_steps": np.int64(DELAY_STEPS),
               "mpc_min_steps": np.int64(MPC_MIN_STEPS), "every": np.int64(EVERY)}
        out.update(solo12_stats())
        out.update(mujoco_rollouts())
        out.update(push_turn_loops())
        out.update(combined_loops())
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
