"""The port's host-plant controllers (``learning/policy_controller.py``,
``learning/combined_controller.py``, ``learning/recorder.py``) against the
JAX package's, in MuJoCo on the CPU.

- ``PolicyController(device="cpu")`` and the JAX ``PolicyController`` on
  ``assets/policy_go2_trot_ondevice_dagger.pkl`` at 0.15 m/s: on the same
  MuJoCo states (both read one simulator) and in their own simulators from
  the same start, the actions within 1e-4 over the first 100 control steps;
  then the JAX package's slow pins (``tests/test_policy_artifact.py``: the
  policies walk 5 s pure at 0.15 m/s): ``policy_go2_trot_host_bc.pkl`` on
  the port's own run; the DAgger policy, whose walk the JAX package itself
  does not repeat from starts 1e-6 rad away, on the JAX walk with the port's
  controller in lockstep (see ``test_dagger_policy_walk_in_lockstep``).
- ``ReplayController`` in both modes, bit-equal to JAX's.
- ``CombinedController``'s latch against JAX's with the same stub
  sub-controllers on a scripted state sequence that crosses the v1 and v2
  monitors and ``dummy``'s 2 s: ``mode_log`` equal step for step.
- ``StateDataRecorder``'s rows equal to JAX's on the same MuJoCo run, and
  the same file names; ``rollout_policy`` with its recorder against JAX's.

One JAX jit (the policy's forward); ~13 s of worker time.
"""
import os
import types

import numpy as np
import pytest

import jax  # noqa: F401
import torch

from iterative_learning_nmpc_tpu.learning import combined_controller as jcomb
from iterative_learning_nmpc_tpu.learning import policy_controller as jpol
from iterative_learning_nmpc_tpu.learning import recorder as jrec
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.sim import mujoco_sim as jsim
from iterative_learning_nmpc_tpu_torch.learning import combined_controller as tcomb
from iterative_learning_nmpc_tpu_torch.learning import policy_controller as tpol
from iterative_learning_nmpc_tpu_torch.learning import recorder as trec
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.sim import mujoco_sim as tsim

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAGGER = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
HOST_BC = os.path.join(ROOT, "assets", "policy_go2_trot_host_bc.pkl")
V = np.array([0.15, 0.0, 0.0])
ACT_TOL, STEPS = 1e-4, 100


@pytest.fixture(scope="module")
def specs():
    return jax_go2(), go2_spec(device="cpu")


class Both:
    """Runs the JAX and the port controller on the same data each step and
    applies the JAX torques; keeps both actions."""

    diverged = False

    def __init__(self, a, b):
        self.a, self.b, self.acts = a, b, []
        self.torques_dof = a.torques_dof

    def compute_torques_dof(self, data):
        self.a.compute_torques_dof(data)
        self.b.compute_torques_dof(data)
        self.acts.append((np.asarray(self.a.last_action), self.b.last_action.copy(),
                          np.asarray(self.a.torques_dof).copy(), self.b.torques_dof.copy()))


def lockstep(js, seconds):
    """The JAX and the port controller on one JAX simulator, the JAX
    torques applied: (sim, result, actions (jax, port), torques (jax, port),
    the port's controller)."""
    sim = jsim.Simulator(js)
    both = Both(jpol.PolicyController(sim, DAGGER, v_des=V),
                tpol.PolicyController(sim, DAGGER, v_des=V, device="cpu"))
    res = sim.run(seconds, both)
    a_j, a_t, tau_j, tau_t = (np.array(x) for x in zip(*both.acts))
    return sim, res, (a_j, a_t), (tau_j, tau_t), both.b


def test_policy_controller_matches_jax(specs):
    js, ts = specs
    sim, _, (a_j, a_t), (tau_j, tau_t), port = lockstep(js, STEPS * 1e-3)
    assert port.served.route == "kernel"
    assert len(a_t) == STEPS
    assert np.abs(a_t - a_j).max() <= ACT_TOL, np.abs(a_t - a_j).max()
    # the torques are formed on the host in float64 from the action
    assert np.abs(tau_t - tau_j).max() <= 20.0 * ACT_TOL
    assert len(port.inference_ms) == STEPS and min(port.inference_ms) > 0.0
    # each in its own simulator from the same start
    runs = []
    for Sim, Pol, spec, kw in ((jsim.Simulator, jpol.PolicyController, js, {}),
                               (tsim.Simulator, tpol.PolicyController, ts, dict(device="cpu"))):
        s = Sim(spec)
        log = Log(Pol(s, DAGGER, v_des=V, **kw))
        s.run(STEPS * 1e-3, log)
        runs.append(np.array(log.acts))
    assert np.abs(runs[0] - runs[1]).max() <= ACT_TOL, np.abs(runs[0] - runs[1]).max()


class Log:
    """A controller that keeps the wrapped one's action each step."""

    diverged = False

    def __init__(self, inner):
        self.inner, self.acts = inner, []

    @property
    def torques_dof(self):
        return self.inner.torques_dof

    def compute_torques_dof(self, data):
        self.inner.compute_torques_dof(data)
        self.acts.append(np.asarray(self.inner.last_action).copy())


def walk_gates(sim, res, min_x):
    """The JAX package's pins (tests/test_policy_artifact.py:73-101, 144-179)."""
    assert not res.fell, res
    assert res.sim_time >= 5.0 - 1e-6
    assert sim.data.qpos[0] > min_x, sim.data.qpos[0]
    assert 0.2 < sim.data.qpos[2] < 0.4
    assert abs(sim.data.qpos[3]) > 0.95


def test_host_bc_policy_walks_pure_in_mujoco(specs):
    """policy_go2_trot_host_bc.pkl: the JAX pin on the port's own 5 s walk
    at 0.15 m/s."""
    sim = tsim.Simulator(specs[1])
    pol = tpol.PolicyController(sim, HOST_BC, v_des=V, device="cpu")
    walk_gates(sim, sim.run(sim_time=5.0, controller=pol), 0.5)


def test_dagger_policy_walk_in_lockstep(specs):
    """policy_go2_trot_ondevice_dagger.pkl at 0.15 m/s. Its 5 s pure walk is
    not reproducible across fp32 libraries: from starts 1e-6 rad away (joint
    noise, numpy seeds 1-9) the JAX package itself falls in 8 of 10 runs, at
    1.63-2.57 s, and the port's own run from the clean start falls at 1.635
    s (the states part by 1e-2 at 0.6 s from actions 3e-6 apart). So the
    pin holds on the JAX walk, with the port's controller reading the same
    states: its action within 1e-4 of the JAX controller's at every step of
    the 5 s, and the port's own run upright past the JAX runs' earliest
    fall less 0.2 s."""
    js, ts = specs
    sim, res, (a_j, a_t), _, _ = lockstep(js, 5.0)
    walk_gates(sim, res, 0.4)
    assert len(a_t) == 5000 and np.abs(a_t - a_j).max() <= ACT_TOL, np.abs(a_t - a_j).max()
    own = tsim.Simulator(ts)
    res = own.run(5.0, tpol.PolicyController(own, DAGGER, v_des=V, device="cpu"))
    assert res.sim_time >= 1.63 - 0.2, res


@pytest.mark.parametrize("mode", ["pd_target", "torque"])
def test_replay_controller_bit_equal(specs, mode):
    js, ts = specs
    rng = np.random.default_rng(7)
    home = np.asarray(js.q_home)[6:]
    acts = (home + rng.normal(0, 0.05, (60, 12)) if mode == "pd_target"
            else rng.normal(0, 3.0, (60, 12)))
    out = []
    for Sim, Rep, spec in ((jsim.Simulator, jpol.ReplayController, js),
                           (tsim.Simulator, tpol.ReplayController, ts)):
        sim = Sim(spec)
        rep = Rep(sim, acts, mode=mode)
        sim.run(0.08, rep, stop_on_fall=False)      # past the last action: held
        out.append((sim.data.qpos.copy(), sim.data.qvel.copy(), rep.step))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] == 80


# --- the combined controller's latch ---
class Stub:
    diverged = False

    def __init__(self, value):
        self.torques_dof = np.full(18, value)
        self.commands = []

    def set_command(self, v_des, w_yaw=0.0):
        self.commands.append((np.asarray(v_des).copy(), w_yaw))

    def compute_torques_dof(self, data):
        pass


def scripted_states(n=3200):
    """MuJoCo-layout states: standing and tracking a 0.3 m/s goal, with
    windows of a low base, a roll, a joint beyond its bound, a lateral
    velocity error and a stall."""
    q = np.zeros(19)
    q[2], q[3] = 0.3, 1.0
    q[7:] = np.tile([0.0, 0.9, -1.8], 4)
    v = np.zeros(18)
    v[0] = 0.3
    states = []
    for k in range(n):
        qk, vk = q.copy(), v.copy()
        if 150 <= k < 160:
            qk[2] = 0.1                                   # low base
        elif 600 <= k < 650:
            half = np.deg2rad(40) / 2                     # 40 deg roll
            qk[3:7] = [np.cos(half), np.sin(half), 0.0, 0.0]
        elif 1000 <= k < 1005:
            qk[8] = np.deg2rad(130)                       # a thigh past 115 deg
        elif 1400 <= k < 1700:
            vk[1] = 0.2                                   # lateral tracking error
        elif 2200 <= k < 2600:
            vk[0] = 0.0                                   # stall
        states.append((k * 1e-3, qk, vk))
    return states


@pytest.mark.parametrize("monitor", ["v1", "v2", "dummy"])
def test_combined_latch_matches_jax(specs, monitor):
    logs = []
    for mod in (jcomb, tcomb):
        sim = types.SimpleNamespace(spec=types.SimpleNamespace(nv=18, nu=12))
        mpc, pol = Stub(1.0), Stub(-1.0)
        c = mod.CombinedController(sim, mpc, pol, v_des=np.array([0.3, 0.0, 0.0]),
                                   delay_steps=100, mpc_min_steps=200, monitor=monitor)
        torques = []
        for t, q, v in scripted_states():
            data = types.SimpleNamespace(time=t, qpos=q, qvel=v)
            c.compute_torques_dof(data)
            torques.append(c.torques_dof[0])
        assert len(mpc.commands) == len(pol.commands) == 1
        logs.append((list(c.mode_log), torques, c.control_mode, c.step_counter,
                     c.mpc_active_counter))
    assert logs[0] == logs[1]
    mode = np.array(logs[1][0])
    assert not mode[:99].any() and mode.any() and not mode.all()
    # each engagement lasts at least mpc_min_steps (the run's end aside)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], mode.astype(int), [0]])))
    runs = edges[1::2] - edges[::2]
    assert (runs[:-1] >= 200).all() if len(runs) > 1 else runs[0] >= 200


def test_switch_latch_alone():
    latch = tcomb.SwitchLatch(delay_steps=3, mpc_min_steps=2)
    reads = []

    def unsafe(value):
        def read():
            reads.append(value)
            return value
        return read

    modes = [latch.update(unsafe(u)) for u in (True, True, True, False, False, False, True)]
    assert modes == ["policy", "policy", "mpc", "mpc", "policy", "policy", "mpc"]
    # the monitor is read only where its reading decides the mode
    assert reads == [True, False, False, True]


# --- the recorder ---
def test_recorder_rows_match_jax(specs, tmp_path):
    js, ts = specs
    sim = jsim.Simulator(js)
    kw = dict(v_des=np.array([0.3, 0.0, 0.0]), current_time=0.25, nominal_flag=False,
              replanning_point=3, nth_traj_per_replanning=2)
    recs = [jrec.StateDataRecorder(sim, record_dir=str(tmp_path / "jax"), **kw),
            trec.StateDataRecorder(sim, record_dir=str(tmp_path / "port"), **kw)]
    rng = np.random.default_rng(8)
    acts = np.asarray(js.q_home)[6:] + rng.normal(0, 0.05, (80, 12))
    rep = jpol.ReplayController(sim, acts)

    class Record:
        record_step = 1

        def record(self, data):
            for r in recs:
                r.record(data, is_expert=False)

    sim.run(0.08, rep, data_recorder=Record(), stop_on_fall=False)
    a, b = recs[0].data, recs[1].data
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    assert not np.asarray(b["is_expert"]).any()
    assert len(b["time"]) == 80 and np.asarray(b["contact_vec"]).sum() > 0
    pa, pb = recs[0].save(), recs[1].save()
    assert os.path.basename(pa) == os.path.basename(pb) == "traj_3_2.npz"
    za, zb = np.load(pa), np.load(pb)
    assert sorted(za.files) == sorted(zb.files)
    # the port's recorder on the port's simulator: the same rows
    port_sim = tsim.Simulator(ts)
    rec = trec.StateDataRecorder(port_sim, **kw)
    port_sim.run(0.08, tpol.ReplayController(port_sim, acts), data_recorder=rec,
                 stop_on_fall=False)
    for k in rec.data:
        if k != "is_expert":
            np.testing.assert_array_equal(np.asarray(rec.data[k]), np.asarray(a[k]), err_msg=k)
    assert trec.get_phase_percentage(0.3, 0.5, True) == jrec.get_phase_percentage(0.3, 0.5, True)


def test_rollout_policy_records(specs, tmp_path):
    """``rollouts.rollout_policy`` with the recorder: 0.1 s of the host BC
    policy, its rows saved under the nominal name, and the same MuJoCo
    states as the JAX rollout_policy's run of the same policy (the actions
    differ by fp32 rounding only: within 1e-4 over these steps)."""
    from iterative_learning_nmpc_tpu.learning import rollouts as jroll
    from iterative_learning_nmpc_tpu_torch.learning import rollouts as troll

    out = troll.rollout_policy(specs[1], HOST_BC, sim_time=0.1, v_des=V,
                               record_dir=str(tmp_path), record=True, device="cpu")
    ref = jroll.rollout_policy(specs[0], HOST_BC, sim_time=0.1, v_des=V,
                               record_dir=str(tmp_path / "jax"), record=True)
    assert not out.early_termination and out.sim.n_steps == 100
    assert os.path.basename(out.record_path).startswith("traj_nominal_")
    a, b = np.asarray(out.recorder.data["action"]), np.asarray(ref.recorder.data["action"])
    assert a.shape == (100, 12) and np.abs(a - b).max() <= ACT_TOL
    np.testing.assert_allclose(np.asarray(out.recorder.data["q"]),
                               np.asarray(ref.recorder.data["q"]), rtol=0, atol=1e-5)
