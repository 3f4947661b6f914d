"""The port's rollout drivers (``learning/rollouts.py``) against the JAX
package, on the CPU.

- ``sample_force_perturbation`` bit-equal to JAX's on the same generators;
  ``early_termination`` as JAX's.
- ``nullspace_perturbation`` at numpy seeds 0-4 from the settled standing
  state (four feet in contact) and from a mid-trot state of the golden's
  MPC rollout (two feet): within 1e-5 of JAX's, with the same accepted
  draw (the generators in the same state after the call). The JAX
  function runs with its dynamics jitted once (``foot_jacobians`` and
  ``foot_positions``), the function itself unchanged.
- ``rollout_mpc`` (Go2 trot, sync, 0.3 m/s) for 0.2 s in MuJoCo against
  ``tests/data/go2_host_loop_golden.npz`` (the JAX run,
  ``scripts/make_torch_host_loop_golden.py``): the boot offset, the first
  plan within rel|dU| <= 1e-3, and the recorder rows of the first 40 steps
  (those the first plan drives) within the tolerances below.

No JAX controller is built; ~12 s of worker time (the port's cold boot and
15-iteration first solve on the CPU take ~7 s of it).
"""
import os
import types

import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.learning import rollouts as jroll
from iterative_learning_nmpc_tpu.models import dynamics as jdyn
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.sim.mujoco_sim import SimResult as JaxSimResult
from iterative_learning_nmpc_tpu_torch.learning import rollouts as troll
from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
from iterative_learning_nmpc_tpu_torch.models.dynamics import settled_state
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.sim.mujoco_sim import SimResult

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_host_loop_golden.npz")
REL_GATE, ROWS = 1e-3, 40
# the first 40 rows: the first plan's feed-forward and PD drive the plant,
# so the rows follow the plan's rel|dU| (1e-4..1e-3) through the torques
ROW_TOL = {"q": 1e-4, "v": 1e-2, "ctrl": 5e-2, "action": 5e-3, "state": 1e-2,
           "feet_pos_w": 1e-4, "base_wrt_feet": 1e-4}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def rel(a, b):
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def test_sample_force_perturbation_bit_equal():
    for seed in range(5):
        a = jroll.sample_force_perturbation(np.random.default_rng(seed), 0.2, 1.5)
        b = troll.sample_force_perturbation(np.random.default_rng(seed), 0.2, 1.5)
        assert (a.start, a.end) == (b.start, b.end)
        np.testing.assert_array_equal(a.force, b.force)


def test_early_termination_as_jax():
    for args in ((2.0, False, False), (1.5, False, False), (2.0, True, False),
                 (2.0, False, True), (1.995, False, False)):
        r_j, r_t = JaxSimResult(args[0], args[1], args[2], 1), SimResult(*args, 1)
        for req in (2.0, 1.5):
            assert jroll.early_termination(r_j, req) == troll.early_termination(r_t, req)


@pytest.fixture(scope="module")
def jitted_jax_rollouts():
    """The JAX rollouts module with its dynamics jitted once (the spec is
    closed over); the module attribute is restored afterwards."""
    js = jax_go2()
    J = jax.jit(lambda q: jdyn.foot_jacobians(js, q))
    P = jax.jit(lambda q: jdyn.foot_positions(js, q))
    orig = jroll.dyn
    jroll.dyn = types.SimpleNamespace(foot_jacobians=lambda spec, q: J(q),
                                      foot_positions=lambda spec, q: P(q))
    yield js
    jroll.dyn = orig


def test_nullspace_perturbation_matches_jax(jitted_jax_rollouts, golden):
    js = jitted_jax_rollouts
    ts = go2_spec(device="cpu")
    x = settled_state(ts).astype(np.float64)
    k = 150                                     # a mid-trot row of the MPC rollout
    q_mid, v_mid = tnp.convert_from_mujoco(golden["mpc_q"][k], golden["mpc_v"][k])
    cases = [(x[:18], x[18:], np.ones(4, int)), (q_mid, v_mid, golden["mpc_contact_vec"][k])]
    assert cases[1][2].sum() == 2
    accepted = 0
    for q, v, contact in cases:
        for seed in range(5):
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            qa, va = jroll.nullspace_perturbation(js, q, v, contact, ra)
            qb, vb = troll.nullspace_perturbation(ts, q, v, contact, rb)
            assert ra.bit_generator.state == rb.bit_generator.state, (seed, contact)
            assert np.abs(qb - qa).max() <= 1e-5 and np.abs(vb - va).max() <= 1e-5, seed
            accepted += int(not np.array_equal(qb, q))
    assert accepted >= 5


def recording_mpc(module):
    """A LocomotionMPC class for ``module`` that keeps its first plan."""
    class Recording(module.LocomotionMPC):
        first = None

        def optimize(self, q, v):
            out = super().optimize(q, v)
            if Recording.first is None:
                Recording.first = dict(U=self._U_prev[0].cpu().numpy(),
                                       boot_offset=self.boot_offsets[0])
            return out

    return Recording


def check_rows(rec, golden, prefix):
    g = {k[len(prefix) + 1:]: v for k, v in golden.items() if k.startswith(prefix + "_")}
    d = {k: np.asarray(v) for k, v in rec.data.items()}
    assert len(d["time"]) == len(g["time"])
    for k in ("time", "vc_goals", "cc_goals", "contact_vec"):
        np.testing.assert_array_equal(d[k][:ROWS], g[k][:ROWS], err_msg=k)
    for k, tol in ROW_TOL.items():
        err = np.abs(d[k][:ROWS] - g[k][:ROWS]).max()
        assert err <= tol, (k, err, tol)
    return d, g


def test_rollout_mpc_matches_golden(golden, tmp_path, monkeypatch):
    monkeypatch.setattr(troll, "LocomotionMPC", recording_mpc(troll))
    res = troll.rollout_mpc(go2_spec(device="cpu"), sim_time=0.2,
                            v_des=np.array([float(golden["roll_v"]), 0.0, 0.0]),
                            record_dir=str(tmp_path), device="cpu")
    first = troll.LocomotionMPC.first
    assert first["boot_offset"] == int(golden["mpc_boot_offset"])
    du = rel(first["U"], golden["mpc_U"])
    assert du <= REL_GATE, du
    assert not res.early_termination and res.sim.n_steps == 200
    assert os.path.basename(res.record_path).startswith("traj_nominal_")
    check_rows(res.recorder, golden, "mpc")
