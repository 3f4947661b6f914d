"""The port's closed-loop controller against the JAX package's, on the CPU.

One JAX ``LocomotionMPC`` (Go2 trot, sync mode, phase-aligned cold boot)
serves the file; its compiled first-solve and RTI replans are shared by the
tests. Checked against it: ``interpolate_plan``, the merit probe of the cold
boot, the first plan (15 iterations from the cold start), three RTI replans
from shared states, and a 0.2 s closed loop of each controller on its own
package's plant. A short asynchronous run of the port, with an injected
solver fault, checks the worker, the delay compensation and the cold
reboot.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.mpc.controller import LocomotionMPC as JaxMPC
from iterative_learning_nmpc_tpu.mpc.interpolate import interpolate_plan as jax_interp
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.sim import jax_sim
from iterative_learning_nmpc_tpu_torch.interop import (
    controller_state_from_numpy, sim_state_from_numpy)
from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
from iterative_learning_nmpc_tpu_torch.mpc import controller as controller_module
from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
from iterative_learning_nmpc_tpu_torch.mpc.interpolate import interpolate_plan
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.sim import device_sim

# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)
V_DES = np.array([0.3, 0.0, 0.0])
GATE = 1.0e-3      # the bench's rel |dU| / (1 + |U|) gate


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def standing_state(spec):
    from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn

    q0 = spec.q_home.numpy().astype(np.float32).copy()
    p0 = tdyn.foot_positions(spec, torch.as_tensor(q0)).numpy()
    q0[2] += -p0[0, 2] + float(spec.foot_radius)
    return q0.astype(np.float64), np.zeros(18)


class PlantData:
    time, qpos, qvel = 0.0, None, None


def run_loop(mpc, step, state_np, st, steps):
    """Couple a controller to a plant for ``steps`` control steps through
    compute_torques_dof; returns the chart states seen (steps, 36)."""
    data, xs = PlantData(), []
    for i in range(steps):
        x = state_np(st)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = i * mpc.sim_dt
        mpc.compute_torques_dof(data)
        st = step(st, mpc.torques_dof[-mpc.nu:])
        xs.append(x)
    return np.asarray(xs), st


@pytest.fixture(scope="module")
def pair():
    """(JAX controller, port controller, standing (q0, v0), the JAX boot
    probe's costs, both first plans)."""
    js, ts = jax_go2(), torch_go2(device="cpu")
    jm = JaxMPC(js, gait_name="trot", solve_async=False, phase_aligned_boot=True)
    tm = LocomotionMPC(ts, gait_name="trot", solve_async=False, phase_aligned_boot=True,
                       device="cpu")
    probe = {}
    boot = jm._boot_jit
    jm._boot_jit = lambda p: probe.setdefault("out", boot(p))
    q0, v0 = standing_state(ts)
    for m in (jm, tm):
        m.set_command(V_DES)
    first = jm.optimize(q0, v0), tm.optimize(q0, v0)
    jm._boot_jit = boot
    warm = tuple(np.asarray(a) for a in (jm._X_prev, jm._U_prev, jm._lam_prev,
                                         jm._lami_prev))
    yield jm, tm, (q0, v0), np.asarray(probe["out"][2]), first, warm
    tm.close()


def test_interpolate_plan_matches_jax():
    rng = np.random.default_rng(2)
    N, n = 25, 1000
    q, v, a = (rng.standard_normal((k, 18)).astype(np.float32) for k in (N + 1, N + 1, N))
    dt = np.full(N, 0.04, np.float32)
    ref = jax.jit(lambda *x: jax_interp(*x, n))(q, v, a, dt)
    out = interpolate_plan(*map(torch.as_tensor, (q, v, a, dt)), n)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))   # ZOH index
    for o, r in zip(out[:2], ref[:2]):
        # the query times agree to an ulp of the 1 s horizon (6e-8 s), and
        # random knots 40 ms apart give slopes of ~100 per second: measured
        # 1.0e-5
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=5e-5)


def test_cold_boot_matches_jax(pair, monkeypatch):
    """The merit probe picks the same gait-phase offset; its costs (three GN
    iterations from a cold start in fp32) agree loosely."""
    jm, tm, (q0, v0), jcosts, _, _ = pair
    assert tm.boot_offsets == jm.boot_offsets
    assert tm.current_opt_node == jm.current_opt_node
    # the port's probe on the same (pre-boot) parameters, recorded from a
    # fresh controller's first optimize (its solve is skipped)
    probe = LocomotionMPC(tm.spec, solve_async=False, device="cpu")
    probe.set_command(V_DES)
    seen = {}
    boot = controller_module.merit_phase_boot
    monkeypatch.setattr(controller_module, "merit_phase_boot",
                        lambda *a, **k: seen.setdefault("boot", boot(*a, **k)))
    monkeypatch.setattr(probe, "_solve_plan", lambda params, node: None)
    probe.optimize(q0, v0)
    probe.close()
    _, off, tcosts = seen["boot"]
    assert off == int(np.argmin(jcosts)) == jm.boot_offsets[0]
    # cold three-iteration solves: fp32 moves either package by ~1e-3..1e-2
    # (PERF.md, Findings); the offsets' costs are 10 % apart
    np.testing.assert_allclose(tcosts.numpy(), jcosts, rtol=1e-2)


def test_first_plan_and_rti_replans_match_jax(pair):
    """The first plan (15 iterations, converged) to the gate; then three
    RTI replans, each from the JAX controller's warm start and a state of
    its plan 40 ms ahead."""
    jm, tm, _, _, (jplan, tplan), _ = pair
    assert rel(tm._U_prev[0].numpy(), jm._U_prev) <= GATE
    for k in (0, 1, 4):                       # q_plan, v_plan, tau_ff
        assert rel(tplan[k], jplan[k]) <= GATE, k
    steps = tm.replanning_steps
    for m in (jm, tm):
        m.first_solve = False
    for i in range(3):
        controller_state_from_numpy(tm, *(np.asarray(a) for a in (
            jm._X_prev, jm._U_prev, jm._lam_prev, jm._lami_prev)))
        q, v = jplan[0][steps - 1].copy(), jplan[1][steps - 1].copy()
        for m in (jm, tm):
            m.current_opt_node += 1
        jplan, tplan = jm.optimize(q, v), tm.optimize(q, v)
        # the plan the plant consumes before the next replan: measured
        # <= 1.3e-4 (the forces)
        for k in range(5):
            assert rel(tplan[k][:steps], jplan[k][:steps]) <= GATE, (i, k)
        # the whole horizon: after the shift the last nodes take RTI steps of
        # norm 20-140, where fp32 moves either package by percents (measured
        # 4.6e-2 on nodes 23-24); the multipliers follow those steps (0.03)
        assert rel(tm._U_prev[0].numpy(), jm._U_prev) <= 1e-1, i
        np.testing.assert_allclose(tm._lam_prev[0].numpy(), np.asarray(jm._lam_prev),
                                   rtol=0, atol=0.1)


def test_closed_loop_matches_jax(pair):
    """0.2 s (5 replans) of each controller on its own package's plant from
    the standing state: both stand, walk off, and agree on the base."""
    jm, tm, (q0, v0), _, _, _ = pair
    steps = 200
    js = jm.spec
    jcp = jax_sim.contact_params_for(js)
    jstep = jax.jit(lambda s, tau: jax_sim.step(js, s, tau, jcp, 1e-3))
    ts = tm.spec
    tcp = device_sim.contact_params_for(ts, device="cpu")
    for m in (jm, tm):
        m.reset()
        m.set_command(V_DES)
    jx, _ = run_loop(
        jm, lambda s, tau: jstep(s, jnp.asarray(tau, jnp.float32)),
        lambda s: np.concatenate([np.asarray(s.q), np.asarray(s.v)]).astype(np.float64),
        jax_sim.SimState(jnp.asarray(q0, jnp.float32), jnp.asarray(v0, jnp.float32),
                         jnp.asarray(0.0)), steps)
    tx, _ = run_loop(
        tm, lambda s, tau: device_sim.step(ts, s, torch.as_tensor(tau, dtype=torch.float32),
                                           tcp, 1e-3),
        lambda s: torch.cat([s.q, s.v]).numpy().astype(np.float64),
        sim_state_from_numpy(q0, v0, device="cpu"), steps)
    assert len(tm.timings["optimize"]) == len(jm.timings["optimize"]) == 5
    assert tm.boot_offsets == jm.boot_offsets and not tm.diverged
    for x in (jx, tx):
        assert np.isfinite(x).all() and 0.2 < x[:, 2].min() and x[:, 2].max() < 0.4
        assert x[-1, 0] - q0[0] > 0.01              # walking forward
    # base position and attitude after 0.2 s of contact-rich closed loop
    np.testing.assert_allclose(tx[:, :6], jx[:, :6], rtol=0, atol=2e-3)


def test_open_loop_matches_jax(pair):
    """open_loop (no plant: the controller follows its own plans and
    replans on its grid) for 0.1 s from the JAX first plan's warm start:
    three RTI replans, the same states."""
    jm, tm, (q0, v0), _, _, warm = pair
    q_mj, v_mj = tnp.convert_to_mujoco(q0, v0)
    node, out = tm.boot_offsets[0], []
    for m in (jm, tm):
        m.reset()
        m.set_command(V_DES)
        m.first_solve = False
        m.current_opt_node = m.last_node = node
    jm._X_prev, jm._U_prev, jm._lam_prev, jm._lami_prev = warm
    controller_state_from_numpy(tm, *warm)
    for m in (jm, tm):
        out.append(m.open_loop(q_mj, v_mj, 0.1))
    jq, tq = out
    assert tq.shape == jq.shape == (100, 19) and np.isfinite(tq).all()
    assert len(tm.timings["optimize"]) == 3
    # the consumed intervals of RTI plans, as in the replan test above:
    # measured 2.3e-4 absolute
    assert rel(tq, jq) <= GATE


def test_async_mode_and_cold_reboot(pair):
    """The asynchronous port controller on the port plant for 0.2 s, with
    the third replan failing: plans are picked up 20 ms after submission
    (delay 19 steps), the failure cold-reboots through the phase-aligned
    boot, and replanning resumes after it."""
    _, tm, (q0, v0), _, _, _ = pair
    ts = tm.spec
    mpc = LocomotionMPC(ts, solve_async=True, async_sim_latency=0.02,
                        recover_on_divergence=1, device="cpu")
    mpc.set_command(V_DES)
    calls = {"n": 0, "after_reboot": 0}
    orig = mpc.optimize

    def flaky(q, v):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected solver fault")
        if calls["n"] > 3:
            calls["after_reboot"] += 1
        return orig(q, v)

    mpc.optimize = flaky
    tcp = device_sim.contact_params_for(ts, device="cpu")
    delays = []
    step = lambda s, tau: device_sim.step(ts, s, torch.as_tensor(tau, dtype=torch.float32),
                                          tcp, 1e-3)
    st = sim_state_from_numpy(q0, v0, device="cpu")
    data = PlantData()
    for i in range(200):
        x = torch.cat([st.q, st.v]).numpy().astype(np.float64)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = i * mpc.sim_dt
        mpc.compute_torques_dof(data)
        if mpc.delay:
            delays.append(mpc.delay)
        st = step(st, mpc.torques_dof[-mpc.nu:])
    mpc.close()
    assert set(delays) == {19}
    assert len(mpc.boot_offsets) == 2 and not mpc.diverged
    assert calls["after_reboot"] >= 2               # replanning resumed
    assert np.isfinite(x).all() and 0.2 < x[2] < 0.4
