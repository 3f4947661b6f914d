"""The port's on-device SafeDAgger loop (``learning/dagger.py``) against the
JAX package's ``OnDeviceSafeDagger``, on the CPU: both with
``make_batched_mpc_rollout`` stubbed to return one fixed seeded rollout,
driven through a collect, a warm-started training and a second collect
(one JAX ``BehavioralCloning.run``); then the port's whole loop with its
real rollout (B=2, 2 intervals, 2 iterations, a 2 x 32 net) against the
invariants of the JAX package's slow test. ~20 s of worker time, most of
it the real rollout's solves.
"""
import inspect
import os
import pickle

import numpy as np
import pytest

import torch

from iterative_learning_nmpc_tpu.learning import dagger as jdag
from iterative_learning_nmpc_tpu.learning import ondevice as jond
from iterative_learning_nmpc_tpu.learning.database import Database as JDatabase
from iterative_learning_nmpc_tpu_torch.interop import random_policy_payload
from iterative_learning_nmpc_tpu_torch.learning import dagger as tdag
from iterative_learning_nmpc_tpu_torch.learning import network as tnet
from iterative_learning_nmpc_tpu_torch.learning import ondevice as tond
from iterative_learning_nmpc_tpu_torch.learning.database import Database as TDatabase
from iterative_learning_nmpc_tpu_torch.learning.randomize import (
    randomize_payload, randomize_terrain, sample_force_windows)
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec as torch_go2
from iterative_learning_nmpc_tpu_torch.learning.train import trained_gaps
from test_torch_train import PARAM_ATOL

torch.set_num_threads(1)
B, T = 4, 80                     # envs, control steps of 2 intervals
GOAL = (0.3, 0.0, 0.0)
# the noisy leaves (learning.train.noisy_leaves, and the goal's constant x
# column's first-layer row) after 2 epochs of 2 steps at lr 1e-3, measured
# over six seeds of the stub's rows: 9.5e-4 to 2.6e-3, every other leaf
# <= 3.7e-5 (PARAM_ATOL is test_torch_train.py's)
NOISY_ATOL = 1.6e-2
FIELDS = ("states", "actions", "vc_goals", "traj_ids", "traj_times")


def seeded_rows(valid=True):
    """One rollout's rows (B, T, ...): the policy alone for 20 steps, the
    expert on ~80 % of the steps after; env 3 falls at step 50."""
    rng = np.random.default_rng(0)
    rows = {k: rng.normal(0.0, 0.5, (B, T, d)).astype(np.float32)
            for k, d in (("q", 18), ("v", 18), ("state44", 44), ("action", 12), ("tau", 12))}
    rows["state44"][..., 0] = rng.uniform(0.0, 1.0, (B, T))
    rows["valid"] = np.full((B, T), float(valid), np.float32)
    rows["valid"][3, 50:] = 0.0
    rows["is_expert"] = np.zeros((B, T), np.float32)
    rows["is_expert"][:, 20:] = rng.uniform(size=(B, T - 20)) < 0.8
    return rows


class StubRollout:
    """A make_batched_mpc_rollout stand-in: records the factory's keywords
    and each call's x0, v_des, policy_update, plant spec, terrain and force
    windows; returns ``rows`` as the package's RolloutBatch (numpy for JAX,
    tensors for the port)."""

    def __init__(self, rows, port):
        self.rows, self.port, self.factory_kw, self.calls = rows, port, None, []

    def __call__(self, spec, **kw):
        self.factory_kw = kw

        def fn(x0, v_des, plant_spec=None, terrain=None, policy_update=None,
               force_windows=None):
            npy = (lambda t: t.cpu().numpy()) if self.port else np.asarray
            self.calls.append(dict(x0=npy(x0), v_des=npy(v_des), policy_update=policy_update,
                                   plant_spec=plant_spec, terrain=terrain,
                                   force_windows=force_windows))
            if self.port:
                return tond.RolloutBatch(**{k: torch.as_tensor(v) for k, v in self.rows.items()})
            return jond.RolloutBatch(**self.rows)

        return fn


def config(record_dir, **kw):
    return dict(record_dir=str(record_dir), sim_time=0.08, database_size=10_000, n_epochs=2,
                batch_size=64, delay_steps=20, mpc_min_steps=60, goals=(GOAL,),
                n_iterations_per_goal=2, x0_z_noise=0.01, x0_rpy_noise=0.02, x0_vel_noise=0.05,
                **kw)


@pytest.fixture(scope="module")
def stubbed(go2, tmp_path_factory):
    """Both packages' OnDeviceSafeDagger on the stub: collect, train, collect."""
    tmp = tmp_path_factory.mktemp("dagger")
    policy0 = tnet.save_policy(str(tmp / "policy0.pkl"),
                               random_policy_payload(2, 32, seed=4)["variables"], None,
                               dict(input_size=47, output_size=12, num_hidden_layer=2,
                                    hidden_dim=32, batch_norm=True, dropout_rate=0.0))
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, mod, ond, spec in (("jax", jdag, jond, go2),
                                     ("port", tdag, tond, torch_go2(device="cpu"))):
            stub = StubRollout(seeded_rows(), port=name == "port")
            mp.setattr(ond, "make_batched_mpc_rollout", stub)
            cfg = mod.SafeDaggerConfig(**config(tmp / name))
            kw = {} if name == "jax" else {"device": "cpu"}
            pipe = mod.OnDeviceSafeDagger(spec, cfg, policy0, batch=B, **kw)
            agg0 = pipe.collect(policy0, GOAL, None, "goal0_iter0")
            pol1 = pipe.run_training(agg0, "goal0_iter0")
            agg1 = pipe.collect(pol1, GOAL, agg0, "goal0_iter1")
            out[name] = dict(stub=stub, pipe=pipe, aggs=(agg0, agg1), pol1=pol1)
    finally:
        mp.undo()
    return out, policy0


def read_aggregate(path):
    db = (JDatabase if path.endswith(".hdf5") else TDatabase)(limit=10_000)
    if path.endswith(".hdf5"):
        db.load_saved_database(path)
    else:
        db.load(path)
    return db


def test_rollout_arguments_match_jax(stubbed):
    """The rollout is built once with the JAX package's keywords and the
    initial policy's weights, and is called with the same x0 (the settled
    state plus joint, z, roll-pitch and velocity noise drawn in the JAX
    order) and v_des."""
    out, _ = stubbed
    sj, st = out["jax"]["stub"], out["port"]["stub"]
    for k in ("gait_name", "n_intervals", "delay_steps", "mpc_min_steps",
              "unsafe_height_bounds"):
        assert st.factory_kw[k] == sj.factory_kw[k], k
    assert st.factory_kw["n_intervals"] == 2 and st.factory_kw["device"] == torch.device("cpu")
    net_t, norm_t = st.factory_kw["policy"]
    _, vars_j, norm_j = sj.factory_kw["policy"]
    # no statistics in the payload: the port serves None, the JAX package
    # the identity statistics it puts in their place
    assert norm_t is None
    for a, b in zip(norm_j, (np.zeros(44), np.ones(44), np.zeros(3), np.ones(3))):
        np.testing.assert_array_equal(a, b)
    assert trained_gaps(vars_j, net_t.flax_variables()) == (0.0, 0.0)
    assert len(st.calls) == len(sj.calls) == 2
    for ct, cj in zip(st.calls, sj.calls):
        assert ct["x0"].shape == (B, 36)
        np.testing.assert_allclose(ct["x0"], cj["x0"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ct["v_des"], cj["v_des"])


def test_aggregates_and_ratios_match_jax(stubbed):
    """The same expert ratios, and both aggregates equal row for row
    (states, actions, goals, ids, times); the port writes npz, the JAX
    package HDF5; the second aggregate holds the first."""
    out, _ = stubbed
    pj, pt = out["jax"]["pipe"], out["port"]["pipe"]
    assert pt.expert_ratio_history == pj.expert_ratio_history
    assert 0.3 < pt.expert_ratio_history[0] < 1.0
    for aj, at in zip(out["jax"]["aggs"], out["port"]["aggs"]):
        assert aj.endswith("agg_dataset.hdf5") and at.endswith("agg_dataset.npz")
        dj, dt = read_aggregate(aj), read_aggregate(at)
        assert len(dt) == len(dj) > 0
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(dt, f)[dt._order()],
                                          getattr(dj, f)[dj._order()], err_msg=f)
    d0, d1 = (read_aggregate(p) for p in out["port"]["aggs"])
    assert len(d1) == 2 * len(d0)
    np.testing.assert_array_equal(d1.states_array()[: len(d0)], d0.states_array())


def test_retrained_policy_matches_jax(stubbed):
    """The second collect serves the retrained weights through
    policy_update, and they agree with the JAX loop's within the trainer's
    tolerance (test_torch_train.py; 2 epochs of 2 steps at lr 1e-3); the
    payloads carry the same normalisation statistics."""
    out, policy0 = stubbed
    (net_t, norm_t), (vars_j, norm_j) = (out[k]["stub"].calls[1]["policy_update"]
                                         for k in ("port", "jax"))
    assert out["port"]["pol1"] != policy0
    # the goal's x column is constant (one goal): its first-layer row is a
    # second bias before the first BatchNorm
    worst, worst_noisy = trained_gaps(vars_j, net_t.flax_variables(), [44])
    assert worst <= PARAM_ATOL and worst_noisy <= NOISY_ATOL, (worst, worst_noisy)
    for a, b in zip(norm_t, norm_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
    payloads = []
    for k in ("jax", "port"):
        with open(out[k]["pol1"], "rb") as f:
            payloads.append(pickle.load(f))
    worst, worst_noisy = trained_gaps(payloads[0]["variables"], payloads[1]["variables"], [44])
    assert worst <= PARAM_ATOL and worst_noisy <= NOISY_ATOL, (worst, worst_noisy)
    for a, b in zip(*(p["norm_policy_input"] for p in payloads)):
        np.testing.assert_array_equal(a, b)
    assert payloads[1]["net_config"] == payloads[0]["net_config"]


def test_no_expert_rows_and_randomize(tmp_path, monkeypatch):
    """A data step that keeps no row returns the previous dataset, as the
    JAX loop does; the constructor takes the JAX one's arguments plus
    ``device``. With ``randomize`` each data step draws its payloads,
    terrain and pushes from generators seeded as the JAX keys are (cfg.seed
    + 7919 / 104729 / 1299709 times the iteration), the payload and terrain
    kwargs passed on, the first half of the envs push-free; without it the
    rollout gets none."""
    payload = random_policy_payload(2, 32, seed=4)
    policy0 = tnet.save_policy(str(tmp_path / "p.pkl"), payload["variables"], None,
                               payload["net_config"])
    stub = StubRollout(seeded_rows(valid=False), port=True)
    monkeypatch.setattr(tond, "make_batched_mpc_rollout", stub)
    spec = torch_go2(device="cpu")
    pipe = tdag.OnDeviceSafeDagger(spec, tdag.SafeDaggerConfig(**config(tmp_path)), policy0,
                                   batch=B, device="cpu")
    assert pipe.collect(policy0, GOAL, None, "t0") is None
    assert pipe.collect(policy0, GOAL, "prev.npz", "t1") == "prev.npz"
    for c in stub.calls:
        assert c["plant_spec"] is None and c["terrain"] is None and c["force_windows"] is None
    params = [(p.name, p.default) for p in
              inspect.signature(tdag.OnDeviceSafeDagger).parameters.values()]
    want = [(p.name, p.default) for p in
            inspect.signature(jdag.OnDeviceSafeDagger).parameters.values()]
    assert params == want + [("device", None)]

    cfg = tdag.SafeDaggerConfig(**config(tmp_path / "rand", seed=3))
    pk, tk = dict(mass_range=(1.0, 2.0)), dict(friction_range=(0.6, 0.7))
    pipe = tdag.OnDeviceSafeDagger(spec, cfg, policy0, batch=B, randomize=True,
                                   payload_kwargs=pk, terrain_kwargs=tk, device="cpu")
    stub.calls.clear()
    for it in range(2):
        pipe.collect(policy0, GOAL, None, f"r{it}")
    gen = lambda k, it: torch.Generator().manual_seed(3 + k * it)
    for it, c in enumerate(stub.calls):
        ps = randomize_payload(spec, gen(7919, it), B, **pk)
        tr = randomize_terrain(gen(104729, it), B, device="cpu", **tk)
        fw = sample_force_windows(gen(1299709, it), B, 2 * 40, device="cpu")
        assert torch.equal(c["plant_spec"].mass, ps.mass)
        assert torch.equal(c["plant_spec"].com, ps.com)
        assert c["plant_spec"].joint_pos is pipe.spec.joint_pos
        assert torch.equal(c["terrain"].ground_height, tr.ground_height)
        mu = c["terrain"].contact.friction_mu
        assert torch.equal(mu, tr.contact.friction_mu) and (mu >= 0.6).all() and (mu <= 0.7).all()
        assert ((c["plant_spec"].mass[:, 5] - spec.mass[5]) >= 1.0).all()
        assert (c["force_windows"][: B // 2] == 0).all()
        assert torch.equal(c["force_windows"][B // 2:], fw[B // 2:])
        assert (c["force_windows"][B // 2:, 1] > c["force_windows"][B // 2:, 0]).all()
    # the iterations draw anew
    assert not torch.equal(stub.calls[0]["plant_spec"].mass, stub.calls[1]["plant_spec"].mass)


def test_real_rollout_loop_on_cpu(tmp_path):
    """The whole loop with the real rollout: B=2, 2 intervals (0.08 s),
    delay 20 steps, MPC latched >= 60, 2 iterations of (collect -> train)
    at one goal, an untrained 2 x 32 BatchNorm net. The JAX slow test's
    invariants: two data steps; the unsafe policy hands over to the expert
    (ratio > 0.3); the aggregate grows; the retrained payload differs,
    loads, carries normalisation statistics and gives finite outputs."""
    net = tnet.init_network(47, 12, 2, 32, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    policy0 = tnet.save_policy(str(tmp_path / "policy0.pkl"), net)
    cfg = tdag.SafeDaggerConfig(**{**config(tmp_path / "dagger"), "x0_z_noise": 0.0,
                                   "x0_rpy_noise": 0.0, "x0_vel_noise": 0.0})
    pipe = tdag.OnDeviceSafeDagger(torch_go2(device="cpu"), cfg, policy0, batch=2, device="cpu")
    final = pipe.run()
    assert len(pipe.expert_ratio_history) == 2
    assert pipe.expert_ratio_history[0] > 0.3
    d0, d1 = (read_aggregate(os.path.join(cfg.record_dir, f"goal0_iter{i}", "agg_dataset.npz"))
              for i in range(2))
    assert len(d1) > len(d0) > 0
    assert final != policy0 and os.path.exists(final)
    net2, norm2 = tnet.load_policy(final, device="cpu")
    assert norm2 is not None
    with torch.no_grad():
        assert bool(torch.isfinite(net2(torch.zeros(1, 47))).all())
