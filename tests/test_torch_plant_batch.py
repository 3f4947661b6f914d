"""The port's batched plant collector (``learning/plant_batch.py``) against
the JAX package's, on the CPU.

The golden (``tests/data/go2_learning_pipeline_golden.npz``,
``scripts/make_torch_learning_pipeline_golden.py``) holds the JAX
``BatchedPlantCollector`` at E=2, 0.2 s, ``max_iter_first`` 4, expert-only
and combined (the shipped policy, delay 20, latch 60). Checked here:

- the per-env base references: ``mpc.controller.velocity_tracking_refs``
  (the controller's assembly, which the collector calls) against the JAX
  collector's own copy (``_batched_params``) on every replan's states of
  the golden, equal; on a yawed base they differ, as the JAX copy sets both
  yaw references to ``round(q[3], 1)``;
- the first RTI replan (B=2, one SQP iteration, the batch route) from the
  golden's warm start, duals and parameters, within ``REL`` of the JAX
  vmapped plan;
- the host loop in lockstep: the collector with its plans replaced by the
  JAX run's (``plans_cat``) gives the JAX rows bit for bit in expert-only
  mode (the same noise draws, cc goals, PD torques, recorder rows, MuJoCo
  steps); in combined mode, with the latch's delay one more than the JAX
  collector's, the same labels and rows within ``LOCKSTEP_TOL`` (the policy
  is served in float32 where the JAX collector runs it in float64);
- the two faults of the JAX collector: its inlined latch first consults the
  monitor at step ``delay_steps``, the port's ``SwitchLatch`` one step
  earlier (a rigged monitor: engages after the delay, holds
  ``mpc_min_steps``, releases; labels and ratio by hand count); and a
  goal-scheduled bundle serves each env by the member nearest its goal,
  where the JAX collector serves both with member 0.

- the whole 0.2 s E=2 runs against the golden: the first (cold) batched
  plan within ``REL``, the rows of the first 0.1 s within the closed loops'
  tolerance, the labels equal.

~12 s of worker time at one intra-op thread (no JAX compile: the JAX
collector's parameter assembly runs eager).
"""
import dataclasses
import os
import pickle
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy, random_policy_payload
from iterative_learning_nmpc_tpu_torch.learning import plant_batch as tpb
from iterative_learning_nmpc_tpu_torch.learning.network import (
    ServedPolicy, read_payload, save_policy_bundle)
from iterative_learning_nmpc_tpu_torch.mpc.controller import velocity_tracking_refs
from iterative_learning_nmpc_tpu_torch.ocp.problem import Weights
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.robots.spec import _TENSOR_FIELDS as SPEC_FIELDS

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_learning_pipeline_golden.npz")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
REL = 1e-3                 # the bench's rel |dU| / (1 + |U|) gate
ROW_TOL = {"q": 1e-4, "v": 1e-2, "action": 5e-3}   # the closed loops' row tolerance
# combined mode in lockstep: the float32 policy against the JAX float64
# one moves the states by ~1e-6 over 0.2 s
LOCKSTEP_TOL = 1e-4
ROW_KEYS = ("state", "action", "vc_goals", "cc_goals", "time", "env_id", "is_expert")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def spec():
    return go2_spec(device="cpu")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def settings(g):
    E, S, noise, seed, it_first, delay, min_steps = g["pb_settings"]
    return dict(E=int(E), S=float(S), noise=float(noise), seed=int(seed),
                it_first=int(it_first), delay=int(delay), min_steps=int(min_steps))


def collector(spec, g, policy=None, delay=None):
    s = settings(g)
    c = tpb.BatchedPlantCollector(spec, n_envs=s["E"], policy_path=policy,
                                  delay_steps=s["delay"] if delay is None else delay,
                                  mpc_min_steps=s["min_steps"], device="cpu")
    c.mpc.config_opt.max_iter_first = s["it_first"]
    return c


class ReplayPlans:
    """Stands in for ``LocomotionMPC._plan``: hands back the JAX run's
    consumed intervals, one a replan, and the warm start unchanged."""

    def __init__(self, cats):
        self.cats, self.i = cats, 0

    def __call__(self, X, U, lam, lami, shift, params, n_iter):
        cat = torch.as_tensor(self.cats[self.i])
        self.i += 1
        return (SimpleNamespace(X=X, U=U, lam_ineq=lami), lam,
                (cat[..., :18], cat[..., 18:36], None, None, cat[..., 36:]))


def replay_collect(spec, g, prefix, policy=None, delay=None):
    s = settings(g)
    c = collector(spec, g, policy, delay)
    c.mpc._plan = ReplayPlans(g[prefix + "plans_cat"])
    try:
        return c.collect(g["pb_v_des"], sim_time=s["S"], joint_noise=s["noise"], seed=s["seed"])
    finally:
        c.close()


class FakeSim:
    def __init__(self, qpos, qvel):
        self.data = SimpleNamespace(qpos=qpos, qvel=qvel)


def test_base_refs_match_the_jax_collector(g, spec):
    """velocity_tracking_refs on every replan's states of both golden runs
    equals the JAX collector's copy; on a yawed base the copies differ only
    in the yaw slots, where the port keeps the controller's rule."""
    from iterative_learning_nmpc_tpu.learning.plant_batch import (
        BatchedPlantCollector as JaxCollector)
    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jgo2

    c = collector(spec, g)
    jc = JaxCollector(jgo2(), n_envs=2)
    cfg_g, cfg_o = c.mpc.config_gait, c.mpc.config_opt
    v = g["pb_v_des"]
    n = 0
    for prefix in ("pb_exp_", "pb_comb_"):
        for qp, qv, rxy, node, br, bre in zip(*(g[prefix + k] for k in (
                "params_qpos", "params_qvel", "params_ref_xy", "params_node", "base_ref",
                "base_ref_e"))):
            sims = [FakeSim(qp[e], qv[e]) for e in range(2)]
            p = c._batched_params(sims, rxy, v, int(node))
            np.testing.assert_array_equal(p.base_ref.numpy(), br)
            np.testing.assert_array_equal(p.base_ref_e.numpy(), bre)
            n += 1
    assert n == 12          # the cold start and the five replans, each run
    # a yawed base: the JAX copy puts round(yaw, 1) in both yaw slots; the
    # controller's assembly blends the running one toward the tracked yaw
    # (0 here, no yaw command) and puts the tracked yaw in the terminal one
    qp = g["pb_exp_params_qpos"][1].copy()
    yaw = 0.3
    qp[:, 3:7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
    qv = g["pb_exp_params_qvel"][1]
    sims = [FakeSim(qp[e], qv[e]) for e in range(2)]
    rxy = g["pb_exp_params_ref_xy"][1]
    jp = jc._batched_params(sims, rxy, v, 1)
    tp = c._batched_params(sims, rxy, v, 1)
    jb, jbe = np.asarray(jp.base_ref), np.asarray(jp.base_ref_e)
    tb, tbe = tp.base_ref.numpy(), tp.base_ref_e.numpy()
    np.testing.assert_allclose(jb[:, 3], 0.3, rtol=1e-6)
    np.testing.assert_allclose(jbe[:, 3], 0.3, rtol=1e-6)
    np.testing.assert_allclose(tb[:, 3], 0.25 * 0.3, rtol=1e-6)
    np.testing.assert_array_equal(tbe[:, 3], 0.0)
    others = [i for i in range(12) if i != 3]
    np.testing.assert_array_equal(tb[:, others], jb[:, others])
    np.testing.assert_array_equal(tbe[:, others], jbe[:, others])
    # the function is the controller's: its method gives the same at yaw
    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
    q, _ = tnp.convert_from_mujoco(qp[0], qv[0])
    c.mpc.set_command(v[0])
    c.mpc.base_ref_vel_tracking[:2] = rxy[0]
    for a, b in zip(c.mpc.compute_base_ref_vel_tracking(q),
                    velocity_tracking_refs(q, rxy[0], 0.0, v[0], np.zeros(3),
                                           cfg_g.nom_height, cfg_o.time_horizon)):
        np.testing.assert_array_equal(a, b)
    c.close()


def to_float64(c):
    """The collector's solver and plan in float64 (spec, weights, AL scales):
    the reference an fp32 step is measured against."""
    d64 = lambda t: t.double() if t.is_floating_point() else t
    s = c.mpc.solver
    s.spec = dataclasses.replace(s.spec, **{f: d64(getattr(s.spec, f)) for f in SPEC_FIELDS})
    s.weights = Weights(**{f.name: d64(getattr(s.weights, f.name))
                           for f in dataclasses.fields(Weights)})
    s._ineq_scales, s._lam_ineq_max = s._ineq_scales.double(), s._lam_ineq_max.double()
    c.mpc.spec = s.spec
    return c


def rti_replan(c, g, pre, dtype, envs=slice(None)):
    """The collector's second replan of the golden run (one RTI iteration
    from the cold plan) through the controller's ``_plan``: (U, consumed
    interval (E, 41, 48))."""
    sims = [FakeSim(g[pre + "params_qpos"][2][e], g[pre + "params_qvel"][2][e])
            for e in range(2)]
    p = c._batched_params(sims, g[pre + "params_ref_xy"][2], g["pb_v_des"],
                          int(g[pre + "params_node"][2]))
    np.testing.assert_array_equal(p.x0.numpy(), g[pre + "plan1_x0"])
    np.testing.assert_array_equal(p.cnt.numpy(), g[pre + "plan1_cnt"])
    p = p.map(lambda t: (t.to(dtype) if t.is_floating_point() else t)[envs])
    T = lambda k: torch.as_tensor(g[pre + "plan1_" + k]).to(dtype)[envs]
    sol, lam, plan = c.mpc._plan(T("X_ws"), T("U_ws"), T("lam_ws"), T("lami_ws"),
                                 int(g[pre + "plan1_shift"]), p, int(g[pre + "plan1_n_iter"]))
    k = c.keep
    cat = torch.cat([plan[0][:, :k], plan[1][:, :k], plan[4][:, :k]], -1)
    return sol.U.double().numpy(), cat.double().numpy()


def test_rti_replan_at_b2_matches_jax(g, spec):
    """The collector's second replan (one RTI iteration at B=2, the batch
    route) from the golden's warm start, duals and states. The step from
    the 4-iteration cold plan is fp32-sensitive: each package's fp32 step
    is ~3e-2 (rel) from the port's float64 one (measured: the JAX vmapped
    plan 3.3e-2, the port's batch route 2.9e-2, the port's B=1 route
    3.0e-2), so the port is held no further from float64 than twice the
    JAX step is; the consumed interval (what the plant sees) within REL of
    the JAX one; in float64 the batch route equals the B=1 route on each
    env (to 1e-8)."""
    pre = "pb_exp_"
    U32, cat32 = rti_replan(collector(spec, g), g, pre, torch.float32)
    U64, cat64 = rti_replan(to_float64(collector(spec, g)), g, pre, torch.float64)
    assert cat32.shape == g[pre + "plan1_cat"].shape == (2, 41, 48)
    d_port, d_jax = rel(U32, U64), rel(g[pre + "plan1_U"], U64)
    assert d_port <= 2 * d_jax, (d_port, d_jax)
    assert rel(cat32, g[pre + "plan1_cat"]) <= REL
    assert rel(cat32, cat64) <= max(REL, 2 * rel(g[pre + "plan1_cat"], cat64))
    U1, _ = rti_replan(to_float64(collector(spec, g)), g, pre, torch.float64, slice(1, 2))
    assert rel(U1, U64[1:]) <= 1e-8


def test_host_loop_in_lockstep_expert_only(g, spec):
    """The JAX run's plans replayed: every row bit-equal to the JAX
    collector's (noise draws, cc goals, PD torques, rows, MuJoCo steps)."""
    res = replay_collect(spec, g, "pb_exp_")
    for k in ROW_KEYS + ("sim_time", "fell"):
        np.testing.assert_array_equal(getattr(res, k), g["pb_exp_" + k], err_msg=k)
    assert res.expert_ratio == float(g["pb_exp_expert_ratio"]) == 1.0
    assert res.monitor.shape == (0, 0) and len(res.replan_ms) == 5


def test_host_loop_in_lockstep_combined(g, spec):
    """Combined mode, the JAX plans replayed, the latch's delay one more
    than the JAX collector's: the same expert labels at every row, the same
    ratio, the rows within LOCKSTEP_TOL; kernel 8's twin serves both envs
    in one call a step."""
    s = settings(g)
    res = replay_collect(spec, g, "pb_comb_", policy=ARTIFACT, delay=s["delay"] + 1)
    np.testing.assert_array_equal(res.is_expert, g["pb_comb_is_expert"])
    np.testing.assert_array_equal(res.env_id, g["pb_comb_env_id"])
    np.testing.assert_array_equal(res.cc_goals, g["pb_comb_cc_goals"])
    assert res.expert_ratio == float(g["pb_comb_expert_ratio"])
    for k in ("state", "action"):
        d = float(np.abs(getattr(res, k) - g["pb_comb_" + k]).max())
        assert d <= LOCKSTEP_TOL, (k, d)
    # the monitor was consulted from step delay_steps on (the JAX count)
    consulted = np.flatnonzero((res.monitor >= 0).any(0))
    assert consulted[0] == s["delay"]


def test_latch_counts_from_one_as_the_controller(g, spec):
    """At the JAX collector's own delay, the port's SwitchLatch consults the
    monitor one step earlier than the JAX collector's inlined copy: env 0
    (0.15 m/s from rest, unsafe by velocity tracking at once) is expert from
    step delay_steps - 1, the JAX run's from step delay_steps."""
    s = settings(g)
    res = replay_collect(spec, g, "pb_comb_", policy=ARTIFACT)
    e0 = res.env_id == 0
    first_port = int(np.flatnonzero(res.is_expert[e0])[0])
    first_jax = int(np.flatnonzero(g["pb_comb_is_expert"][g["pb_comb_env_id"] == 0])[0])
    assert (first_port, first_jax) == (s["delay"] - 1, s["delay"])


def test_rigged_monitor_latch(g, spec, monkeypatch):
    """A rigged monitor, unsafe over steps 50-59 only (delay 20, latch 30):
    each env's latch leaves the policy in control through the delay,
    engages at step 50, holds the expert for mpc_min_steps, releases at
    step 80; the rows' labels and the ratio are the hand count, and the
    monitor was read at the steps the controller's latch reads it."""
    delay, min_steps = 20, 30
    step = {"i": 0}
    update = tpb.SwitchLatch.update

    def counted_update(self, unsafe):
        step["i"] = self.step_counter            # the 0-based step this update decides
        return update(self, unsafe)

    monkeypatch.setattr(tpb.SwitchLatch, "update", counted_update)
    monkeypatch.setattr(tpb, "check_unsafe_state_v2",
                        lambda q, v, v_des, height_bounds: 50 <= step["i"] < 60)
    s = settings(g)
    c = tpb.BatchedPlantCollector(spec, n_envs=2, policy_path=ARTIFACT, delay_steps=delay,
                                  mpc_min_steps=min_steps, device="cpu")
    c.mpc._plan = ReplayPlans(g["pb_comb_plans_cat"])
    res = c.collect(g["pb_v_des"], sim_time=0.1, joint_noise=s["noise"], seed=s["seed"])
    c.close()
    want = np.zeros(100, int)
    want[50:50 + min_steps] = 1
    for e in range(2):
        np.testing.assert_array_equal(res.is_expert[res.env_id == e], want)
        mon = res.monitor[e]
        read = np.flatnonzero(mon >= 0)
        # from step delay - 1 (the latch counts its updates from 1), every
        # step under the policy, under the expert only once it may release
        assert read[0] == delay - 1
        assert (mon[delay - 1:51] >= 0).all() and (mon[51:50 + min_steps] == -1).all()
        assert mon[50] == 1 and mon[50 + min_steps] == 0 and (mon[50 + min_steps:] >= 0).all()
    assert res.expert_ratio == 2 * min_steps / 200


def test_bundle_serves_each_env_its_nearest_member(spec, tmp_path):
    """A two-member bundle: the port's collector serves each env with the
    member nearest its own goal; the JAX collector loads the bundle without
    a goal (its ``make_numpy_apply(policy_path)``) and serves both envs
    with member 0."""
    from iterative_learning_nmpc_tpu.learning.network import make_numpy_apply

    q_stand = spec.q_home[6:].numpy()
    paths = []
    for i in range(2):
        p = str(tmp_path / f"m{i}.pkl")
        with open(p, "wb") as f:
            pickle.dump(random_policy_payload(3, 64, seed=10 + i, q_stand=q_stand), f)
        paths.append(p)
    bundle = save_policy_bundle(str(tmp_path / "bundle.pkl"),
                                [((0.0, 0.0, 0.0), paths[0]), ((0.3, 0.0, 0.0), paths[1])])
    v_des = np.array([[0.05, 0.0, 0.0], [0.25, 0.0, 0.0]])
    c = tpb.BatchedPlantCollector(spec, n_envs=2, policy_path=bundle, device="cpu")
    served, member = c._policies(v_des)
    c.close()
    assert len(served) == 2 and member.tolist() == [0, 1]
    rng = np.random.default_rng(0)
    states = [rng.normal(size=44) for _ in range(2)]
    sims = [SimpleNamespace(data=SimpleNamespace(qpos=np.r_[np.zeros(7), rng.normal(size=12)],
                                                 qvel=rng.normal(size=18))) for _ in range(2)]
    act = c._policy_actions(served, member, states, v_des, sims, np.ones(2, bool))
    for e in range(2):
        own = ServedPolicy(*policy_from_numpy(read_payload(paths[e]), device="cpu"),
                           device="cpu")
        x = torch.as_tensor(np.r_[states[e], v_des[e], sims[e].data.qpos[7:],
                                  sims[e].data.qvel[6:]], dtype=torch.float32)[None]
        a, _ = own(x[:, :44], x[:, 44:47], x[:, 47:59], x[:, 59:], 20.0, 1.5)
        np.testing.assert_allclose(act[e], a[0].numpy().astype(np.float64), rtol=0, atol=1e-6)
    # the JAX collector's load: member 0 for every env
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        japply = make_numpy_apply(bundle)
    m0 = make_numpy_apply(paths[0])
    obs = np.stack([np.r_[states[e], v_des[e]] for e in range(2)])
    np.testing.assert_array_equal(japply(obs), m0(obs))
    assert np.abs(make_numpy_apply(paths[1])(obs)[1] - japply(obs)[1]).max() > 1e-3


@pytest.mark.parametrize("mode", ["exp", "comb"])
def test_collector_matches_the_jax_golden(g, spec, mode):
    """The whole run at E=2 for 0.2 s against the JAX collector: the first
    (cold, max_iter_first) batched plan within REL; the rows over the first
    0.1 s within the closed loops' tolerance (``ROW_TOL``: the q-derived
    state columns 1e-4, the velocity columns 1e-2, the action 5e-3), the
    labels equal (combined mode with the latch's delay one
    more), no env falls."""
    s = settings(g)
    pre = f"pb_{mode}_"
    policy = ARTIFACT if mode == "comb" else None
    c = collector(spec, g, policy, delay=s["delay"] + 1)
    first = {}
    plan = c.mpc._plan

    def keep_first(*a):
        out = plan(*a)
        if not first:
            first["U"] = out[0].U.numpy()
            k = c.keep
            first["cat"] = torch.cat([out[2][0][:, :k], out[2][1][:, :k],
                                      out[2][4][:, :k]], -1).numpy()
        return out

    c.mpc._plan = keep_first
    res = c.collect(g["pb_v_des"], sim_time=s["S"], joint_noise=s["noise"], seed=s["seed"])
    c.close()
    assert rel(first["U"], g[pre + "plan0_U"]) <= REL
    assert rel(first["cat"], g[pre + "plan0_cat"]) <= REL
    assert not res.fell.any() and len(res.state) == len(g[pre + "state"])
    np.testing.assert_array_equal(res.is_expert, g[pre + "is_expert"])
    early = res.time < 0.1
    np.testing.assert_allclose(res.state[early][:, 19:], g[pre + "state"][early][:, 19:],
                               rtol=0, atol=ROW_TOL["q"])
    np.testing.assert_allclose(res.state[early][:, 1:19], g[pre + "state"][early][:, 1:19],
                               rtol=0, atol=ROW_TOL["v"])
    np.testing.assert_allclose(res.action[early], g[pre + "action"][early],
                               rtol=0, atol=ROW_TOL["action"])
