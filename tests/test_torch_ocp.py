"""PyTorch port vs the JAX package: the OCP residual stack, row for row.

The fixture activates every row group: restricted mode with small patch
radii and patch targets off the feet, non-zero equality multipliers and
inequality shifts, mixed contacts, forces that straddle the cone.
"""
import dataclasses

import numpy as np
import pytest

import jax
import torch

from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu.ocp import problem as jprob
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.solver import sqp as jsqp
from iterative_learning_nmpc_tpu_torch.interop import (
    params_from_numpy, spec_from_numpy, weights_from_numpy)
from iterative_learning_nmpc_tpu_torch.ocp import problem as tprob
from iterative_learning_nmpc_tpu_torch.solver.linearize import node_view

N, B = 6, 2
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)


def make_case(seed: int = 3):
    """(JAX solver, X (B,N+1,36), U (B,N,30), batched numpy OCPParams) with
    every residual row group active."""
    _, opt, cost = get_quadruped_config("trot", "go2")
    opt.n_nodes, opt.time_horizon = N, N * 0.04
    solver = jsqp.TrajOptSolver(jax_go2(), opt, cost)
    rng = np.random.RandomState(seed)
    q0 = np.asarray(solver.spec.q_home, np.float32)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None, None],
                (B, N + 1, 1))
    X += 0.05 * rng.randn(B, N + 1, 36).astype(np.float32)
    U = 0.3 * rng.randn(B, N, 30).astype(np.float32)
    U[:, :, 20::3] += 30.0          # normal forces: cone hinges mix on/off
    ps = []
    for b in range(B):
        cnt = (rng.rand(4, N + 1) > 0.4).astype(np.float32)
        ps.append(jsqp.make_params(
            solver, X[b, 0], cnt,
            cnt_loc=0.3 * rng.randn(4, N + 1, 3).astype(np.float32),
            patch_radius=np.full((4, N + 1), 0.05, np.float32),
            restrict=1.0,
            lam_eq=0.1 * rng.randn(N, 18).astype(np.float32),
            lam_ineq=0.5 * np.abs(rng.randn(N, 36)).astype(np.float32)
            * (rng.rand(N, 36) > 0.5),
        ))
    pb = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *ps)
    return solver, X, U, pb


@pytest.fixture(scope="module")
def case():
    solver, X, U, pb = make_case()
    spec = spec_from_numpy(solver.spec, device="cpu")
    w = weights_from_numpy(solver.weights, device="cpu")
    return solver, X, U, pb, spec, w, params_from_numpy(pb, device="cpu")


def _jax_nodes(p):
    """Per-node JAX arguments with leading (B, N)."""
    return dict(
        cnt=np.swapaxes(p.cnt[:, :, :N], 1, 2), peak=np.swapaxes(p.peak[:, :, :N], 1, 2),
        plane=np.moveaxis(p.plane_point[:, :, :N], 2, 1),
        loc=np.moveaxis(p.cnt_loc[:, :, :N], 2, 1),
        patch=np.swapaxes(p.patch_radius[:, :, :N], 1, 2))


def _close(out, ref, what):
    ref = np.asarray(ref)
    assert out.shape == ref.shape, what
    # fp32 rows built from the same FK/RNEA values; 2e-6 of the stack's scale
    # (~30 ulps) covers the reassociated sums, 1e-5 relative the large rows
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=2e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("with_multipliers", [True, False])
@pytest.mark.parametrize("include_torque", [True, False])
def test_stage_residual_matches_jax(case, include_torque, with_multipliers):
    solver, X, U, pb, spec, w, tp = case
    jn = _jax_nodes(pb)

    def one(x, u, cnt, peak, plane, loc, patch, lam, lami, rstr, bref, jref, sh):
        return jprob.stage_residual(
            solver.spec, solver.weights, x, u, cnt, peak, plane, loc, patch, rstr,
            bref, jref, sh, lam_k=lam if with_multipliers else None,
            lam_ineq_k=lami if with_multipliers else None,
            include_torque=include_torque)

    node = jax.vmap(one, in_axes=(0,) * 9 + (None,) * 4)
    ref = jax.jit(jax.vmap(node))(
        X[:, :-1], U, jn["cnt"], jn["peak"], jn["plane"], jn["loc"], jn["patch"],
        pb.lam_eq, pb.lam_ineq, pb.restrict, pb.base_ref, pb.joint_ref,
        pb.step_height)
    nv = node_view(tp, N)
    if not with_multipliers:
        nv.update(lam_k=None, lam_ineq_k=None)
    out = tprob.stage_residual(spec, w, torch.as_tensor(X[:, :-1]),
                               torch.as_tensor(U), include_torque=include_torque,
                               **nv)
    assert out.shape[-1] == (tprob.N_RES_TORQUE if include_torque else tprob.N_RES)
    _close(out, ref, f"stage rows torque={include_torque} mult={with_multipliers}")


def test_terminal_equality_ineq_match_jax(case):
    solver, X, U, pb, spec, w, tp = case
    js, jw = solver.spec, solver.weights
    jn = _jax_nodes(pb)
    ref_T = jax.jit(jax.vmap(lambda x, pk, br, jr, sh: jprob.terminal_residual(
        js, jw, x, pk, br, jr, sh)))(X[:, -1], pb.peak[:, :, -1], pb.base_ref_e,
                                    pb.joint_ref, pb.step_height)
    out_T = tprob.terminal_residual(spec, w, torch.as_tensor(X[:, -1]),
                                    tp.peak[:, :, -1], tp.base_ref_e,
                                    tp.joint_ref, tp.step_height)
    _close(out_T, ref_T, "terminal rows")

    eq = jax.jit(jax.vmap(jax.vmap(lambda x, u, c, pl: jprob.equality_residuals(
        js, jw, x, u, c, pl))))(X[:, :-1], U, jn["cnt"], jn["plane"])
    ineq = jax.jit(jax.vmap(jax.vmap(
        lambda x, u, c, lo, pa, r: jprob.ineq_values(js, jw, x, u, c, lo, pa, r),
        in_axes=(0, 0, 0, 0, 0, None))))(X[:, :-1], U, jn["cnt"], jn["loc"],
                                        jn["patch"], pb.restrict)
    nv = node_view(tp, N)
    x, u = torch.as_tensor(X[:, :-1]), torch.as_tensor(U)
    _close(tprob.equality_residuals(spec, w, x, u, nv["cnt_k"], nv["plane_k"]),
           eq, "equality rows")
    _close(tprob.ineq_values(spec, w, x, u, nv["cnt_k"], nv["cnt_loc_k"],
                             nv["patch_k"], nv["restrict"]), ineq, "inequality values")


def test_weights_and_dynamics_step_match_jax(case):
    solver, X, U, pb, spec, w, tp = case
    ref = tprob.make_weights(solver.opt, solver.cost, spec, device="cpu")
    for f in dataclasses.fields(tprob.Weights):
        # both packages compute the weights in float32 numpy: bit-equal
        np.testing.assert_array_equal(getattr(ref, f.name).numpy(),
                                      np.asarray(getattr(solver.weights, f.name)),
                                      err_msg=f.name)
    A, B_ = tprob.dynamics_matrices(solver.dt_nodes, device="cpu")
    A0, B0 = jprob.dynamics_matrices(solver.dt_nodes)
    np.testing.assert_array_equal(A.numpy(), A0)
    np.testing.assert_array_equal(B_.numpy(), B0)
    nxt = jax.jit(jax.vmap(jax.vmap(jprob.dynamics_step)))(X[:, :-1], U, pb.dt)
    _close(tprob.dynamics_step(torch.as_tensor(X[:, :-1]), torch.as_tensor(U),
                               tp.dt), nxt, "shooting step")


def test_hinges_and_cone_match_jax():
    """The AL-shifted hinge, its activity mask and the pyramid cone values
    on both sides of the boundary, with and without a shift."""
    rng = np.random.RandomState(5)
    g = rng.randn(64).astype(np.float32)
    g[:8] = 0.0                                     # exactly on the boundary
    s = (np.abs(rng.randn(64)) * (rng.rand(64) > 0.5)).astype(np.float32)
    f = (10.0 * rng.randn(16, 4, 3)).astype(np.float32)
    for name in ("hinge_shifted", "hinge_shifted_act"):
        # elementwise selects and one add: bit-equal
        np.testing.assert_array_equal(
            getattr(tprob, name)(torch.as_tensor(g), torch.as_tensor(s)).numpy(),
            np.asarray(getattr(jprob, name)(g, s)), err_msg=name)
    # fx - mu fz: a fused multiply-add on one side may round once less
    np.testing.assert_allclose(tprob.cone_values(torch.as_tensor(f), 0.5).numpy(),
                               np.asarray(jprob.cone_values(f, 0.5)), rtol=0, atol=1e-5)


def test_contact_planner_matches_jax():
    """Contact and swing-peak windows of every catalog gait (numpy on both
    sides: identical integers)."""
    from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner as JPlanner
    from iterative_learning_nmpc_tpu.mpc.config import GAITS
    from iterative_learning_nmpc_tpu_torch.gait.planner import ContactPlanner

    names = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")
    for gait in GAITS.values():
        jp, tp = JPlanner(names, 0.04, gait), ContactPlanner(names, 0.04, gait)
        for i_node in (0, 3, 17):
            np.testing.assert_array_equal(tp.get_contacts(i_node, 26),
                                          jp.get_contacts(i_node, 26))
            np.testing.assert_array_equal(tp.get_peaks(i_node, 26),
                                          jp.get_peaks(i_node, 26))
