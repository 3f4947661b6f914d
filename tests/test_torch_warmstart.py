"""The port's policy warm starts against the JAX package's, on the CPU,
through ``tests/data/go2_trot_policy_warmstart_golden.npz``
(``scripts/make_torch_controller_modes_golden.py``: JAX's
``policy_warmstart`` and ``phase_aligned_warmstart`` with the shipped
policy, 4 problems of the flagship instance, N=25).

A full horizon is 1,000 plant steps, ~20 ms each on a CPU worker, so the
rollouts here are cut to the first nodes: a node's rollout does not depend
on the nodes after it, so a solver of 2 nodes runs the golden's first 2.
The phase pick, which reads the whole horizon, is held on the golden's own
node states. The batch is checked bit for bit against its problems
solved one at a time (1 node). ~9 s of worker time.
"""
import os

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, load_policy
from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.sim import device_sim
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver, make_params
from iterative_learning_nmpc_tpu_torch.solver.warmstart import (
    phase_aligned_warmstart, phase_pick, policy_targets, policy_warmstart)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_trot_policy_warmstart_golden.npz")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")


@pytest.fixture(scope="module")
def setup():
    g = np.load(GOLDEN)
    spec = go2_spec(device="cpu")
    apply_fn = policy_targets(ServedPolicy(*load_policy(ARTIFACT, device="cpu"), device="cpu"))
    return g, spec, apply_fn


def short_problem(spec, g, n_nodes, rows):
    """A solver of ``n_nodes`` nodes (0.04 s each) and the golden problems
    ``rows`` as a batch, their windows cut to the horizon."""
    gait, opt, cost = get_quadruped_config("trot", "go2")
    opt.n_nodes, opt.time_horizon = n_nodes, n_nodes * 0.04
    solver = TrajOptSolver(spec, opt, cost, device="cpu")
    p = make_params(solver, g["x0"][0], g["cnt"][:, :n_nodes + 1], base_ref=g["base_ref"],
                    step_height=0.05, ground_height=float(spec.foot_radius))
    B = len(rows)
    p = p.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
    return solver, p.replace(x0=torch.as_tensor(g["x0"][rows])), g["windows"][:, :, :n_nodes + 1]


def test_warm_starts_match_jax_on_the_first_nodes(setup):
    """The rollout's first two nodes (80 control steps) against the golden,
    within the JAX package's own spread: rounding differences grow ~10x
    every ~6 steps through the stiff contact, and the JAX warm start jitted
    per problem differs from the golden (jitted under vmap) by up to 2.9e-2
    in q and 0.56 in v over these nodes (0.50 and 3.3 over the horizon,
    and in 3 of 4 offsets: scripts/make_torch_controller_modes_golden.py's
    problems). Exact: X starts at x0, U's accelerations are the node
    velocities' differences over dt, its forces the contact model's at the
    node states where the plan says stance and 0 elsewhere, and the
    phase-aligned warm start runs the same rollout."""
    g, spec, apply_fn = setup
    solver, p, w = short_problem(spec, g, 2, [0, 1, 2, 3])
    X, U = policy_warmstart(solver, apply_fn, p, g["v_des"])
    assert X.shape == (4, 3, 36) and U.shape == (4, 2, 30)
    ref = g["X_policy"][:, :3]
    dq = float(np.abs(X.numpy()[..., :18] - ref[..., :18]).max())
    dv = float(np.abs(X.numpy()[..., 18:] - ref[..., 18:]).max())
    assert dq <= 3e-2 and dv <= 0.6, (dq, dv)
    assert torch.equal(X[:, 0], p.x0)
    assert torch.equal(U[..., :18], (X[:, 1:, 18:] - X[:, :-1, 18:]) / solver.dt_nodes)
    cp = device_sim.contact_params_for(spec, device="cpu")
    F = device_sim.contact_forces(spec, X[:, 1:, :18], X[:, 1:, 18:], cp)
    mask = p.cnt[:, :, :2].transpose(1, 2)[..., None]
    assert torch.equal(U[..., 18:], (F * mask).reshape(4, 2, 12))
    X2, U2, p2, off = phase_aligned_warmstart(solver, apply_fn, p, g["v_des"], w)
    assert torch.equal(X2, X) and torch.equal(U2[..., :18], U[..., :18])
    cnt = torch.as_tensor(w)[off]
    assert torch.equal(p2.cnt, cnt) and torch.equal(p2.peak, 1.0 - cnt)
    assert torch.equal(off, phase_pick(F, torch.as_tensor(w)))
    assert torch.equal(U2[..., 18:], (F * cnt[:, :, :2].transpose(1, 2)[..., None]).reshape(
        4, 2, 12))


def test_phase_pick_matches_jax(setup):
    """On the golden's node states (the port's contact model), the port picks
    the JAX package's offsets and windows."""
    g, spec, _ = setup
    X = torch.as_tensor(g["X_aligned"])
    cp = device_sim.contact_params_for(spec, device="cpu")
    F = device_sim.contact_forces(spec, X[:, 1:, :18], X[:, 1:, 18:], cp)
    w = torch.as_tensor(g["windows"])
    off = phase_pick(F, w)
    np.testing.assert_array_equal(off.numpy(), g["offset"])
    np.testing.assert_array_equal(w[off].numpy(), g["cnt_aligned"])
    # the golden's masked forces are the contact model's where the picked
    # window says stance
    f_ref = g["U_aligned"][..., 18:].reshape(4, 25, 4, 3)
    stance = g["cnt_aligned"][:, :, :25].transpose(0, 2, 1) == 1
    np.testing.assert_allclose(F.numpy()[stance], f_ref[stance], rtol=0,
                               atol=1e-3 * np.abs(f_ref).max())
    assert np.all(f_ref[~stance] == 0.0)


def test_batch_equals_problems_one_at_a_time(setup):
    """Each problem of a batch is the problem alone, bit for bit. The policy
    is served a row at a time: the CPU's matrix product rounds a batch of
    one differently from a batch of four (4.8e-7 on the targets), which the
    rollout amplifies."""
    g, spec, served = setup
    apply_fn = lambda x: torch.cat([served(x[i:i + 1]) for i in range(x.shape[0])])
    solver, p, w = short_problem(spec, g, 1, [0, 1, 2, 3])
    out = phase_aligned_warmstart(solver, apply_fn, p, g["v_des"], w)
    for b in range(4):
        pb = p.map(lambda t: t[b:b + 1].contiguous())
        one = phase_aligned_warmstart(solver, apply_fn, pb, g["v_des"], w)
        for t_batch, t_one in ((out[0], one[0]), (out[1], one[1]), (out[2].cnt, one[2].cnt),
                               (out[3], one[3])):
            assert torch.equal(t_batch[b:b + 1], t_one), b
