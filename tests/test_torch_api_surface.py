"""The JAX package's last public names, each held to its JAX twin on the
same numpy inputs, on the CPU:

- the kernel-1 evaluators ``solver/linearize.{total_cost,eq_residuals,
  ineq_g,dual_g,cost_dual}_dyncore`` and the solver's ``_total_cost`` /
  ``_dual_g`` / ``_ineq_g`` against the JAX solver's XLA paths
  (``_total_cost_xla``, ``_dual_g_xla``) on ``tests/test_dynjac_kernel.py``'s
  two-leading-dims case (seed 11, alphas x problems = 2 x 3),
- ``Solution.q/.v/.a/.f``; the setters ``set_max_iter``, ``set_nlp_tol``,
  ``set_qp_tol`` (the config fields the JAX package's write, and the port's
  next solve's iteration counts),
- ``ocp.problem.stage_residual_from_params``, ``GaitPlanner.window_device``,
- ``learning.network.make_policy_apply`` on a shipped payload and on a
  goal-scheduled bundle,
- ``RobotSpec.n_foot`` / ``ancestor_mask`` / ``total_mass`` (per
  environment on a payload spec), ``models.math3d.rot_x/y/z`` and
  ``models.transforms.v_global_to_local``.

Every JAX value comes from one ``jax.jit`` (the file's one JAX compile).
~16 s of worker time, 12 s of it the JAX compile.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.gait.planner import ContactPlanner as JContactPlanner
from iterative_learning_nmpc_tpu.learning import network as jnetwork
from iterative_learning_nmpc_tpu.models import math3d as jmath3d
from iterative_learning_nmpc_tpu.models import transforms as jtransforms
from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config as jax_configs
from iterative_learning_nmpc_tpu.ocp.problem import (
    stage_residual_from_params as j_stage_residual_from_params,
)
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.solver import sqp as JS
from iterative_learning_nmpc_tpu_torch import flagship as F
from iterative_learning_nmpc_tpu_torch.gait.planner import ContactPlanner
from iterative_learning_nmpc_tpu_torch.learning.network import make_policy_apply, read_payload
from iterative_learning_nmpc_tpu_torch.learning.randomize import randomize_payload
from iterative_learning_nmpc_tpu_torch.models import math3d, transforms
from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu_torch.ocp.problem import OCPParams, stage_residual_from_params
from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore_plain
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.solver import linearize as lin
from iterative_learning_nmpc_tpu_torch.solver.sqp import Solution, TrajOptSolver, make_params
from test_torch_ineq_al import _stress_problem

torch.set_num_threads(1)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
POLICY = os.path.join(ASSETS, "policy_go2_trot_host_bc.pkl")
BUNDLE = os.path.join(ASSETS, "policy_go2_trot_envelope.pkl")
V_DES = np.array([0.25, 0.0, 0.0], np.float32)
NODES = (0, 7, 24)              # stage_residual_from_params' nodes
STARTS = (0, 7, 19, 33)         # window_device's start nodes
N_POLICY = 16


def _cost_case(N, q0):
    """tests/test_dynjac_kernel.py::test_total_cost_dyncore_matches_oracle's
    draws: X (2, 3, N+1, 36), U (2, 3, N, 30), each problem's contacts and
    multipliers."""
    rng = np.random.RandomState(11)
    A_, B_ = 2, 3
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None, None, None],
                (A_, B_, N + 1, 1))
    X += 0.05 * rng.randn(A_, B_, N + 1, 36).astype(np.float32)
    U = 0.3 * rng.randn(A_, B_, N, 30).astype(np.float32)
    U[..., 20::3] += 30.0
    per = [dict(cnt=(rng.rand(4, N + 1) > 0.4).astype(np.float32),
                lam_eq=0.1 * rng.randn(N, 18).astype(np.float32),
                lam_ineq=0.5 * np.abs(rng.randn(N, 36)).astype(np.float32))
           for _ in range(B_)]
    return X, U, per


def _policy_inputs(path, v_des, seed):
    """(N_POLICY, 47) inputs drawn around the payload's statistics."""
    mu_s, sd_s, mu_g, sd_g = (np.asarray(a, np.float32)
                              for a in read_payload(path, v_des)["norm_policy_input"])
    rng = np.random.default_rng(seed)
    s = mu_s + sd_s * rng.standard_normal((N_POLICY, 44)).astype(np.float32)
    g = mu_g + sd_g * rng.standard_normal((N_POLICY, 3)).astype(np.float32)
    return np.concatenate([s, g], 1).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    gait, opt, cost = get_quadruped_config("trot", "go2")
    spec = go2_spec(device="cpu")
    solver = TrajOptSolver(spec, opt, cost, device="cpu")
    N = solver.N
    X, U, per = _cost_case(N, spec.q_home.numpy().astype(np.float32))
    plist = [make_params(solver, X[0, b, 0], **kw) for b, kw in enumerate(per)]
    pb = OCPParams(**{f: torch.cat([getattr(p, f) for p in plist])
                      for f in OCPParams.__dataclass_fields__})

    jgait, jopt, jcost = jax_configs("trot", "go2")
    jspec = jax_go2()
    jsolver = JS.TrajOptSolver(jspec, jopt, jcost)
    jpl = [JS.make_params(jsolver, X[0, b, 0], **kw) for b, kw in enumerate(per)]
    jpb = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *jpl)
    jpab = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), jpb)
    jplanner = JContactPlanner(jspec.feet_frame_names, jsolver.dt_nodes, jgait)
    apply_plain = jnetwork.make_policy_apply(POLICY)
    apply_bundle = jnetwork.make_policy_apply(BUNDLE, v_des=V_DES)

    rng = np.random.default_rng(5)
    angles = rng.uniform(-np.pi, np.pi, (7,)).astype(np.float32)
    qs = np.tile(spec.q_home.numpy(), (9, 1)).astype(np.float32)
    qs[:, 3:6] = rng.uniform(-1.4, 1.4, (9, 3))
    vs = rng.standard_normal((9, 18)).astype(np.float32)
    payload = randomize_payload(spec, torch.Generator().manual_seed(0), 4)
    inputs = dict(
        X=X, U=U, pab=jpab, angles=angles, q=qs, v=vs, starts=np.array(STARTS, np.int32),
        x_plain=_policy_inputs(POLICY, None, 1), x_bundle=_policy_inputs(BUNDLE, V_DES, 2),
        masses=payload.mass.numpy())

    def jax_values(d):
        def xla(X_, U_, p_):
            return (jsolver._total_cost_xla(X_, U_, p_),) + tuple(jsolver._dual_g_xla(X_, U_, p_))

        flat = lambda t: t.reshape((6,) + t.shape[2:])
        cost, r_eq, g = jax.vmap(xla)(flat(d["X"]), flat(d["U"]), jax.tree.map(flat, d["pab"]))
        out = dict(cost=cost.reshape(2, 3), r_eq=r_eq.reshape((2, 3) + r_eq.shape[1:]),
                   g=g.reshape((2, 3) + g.shape[1:]))
        # the node index traced, so that every node shares one compile
        out["res"] = jax.vmap(lambda x, u, p: jax.vmap(
            lambda k: j_stage_residual_from_params(jspec, jsolver.weights, x[k], u[k], p, k))(
                jnp.asarray(NODES)))(d["X"][0], d["U"][0], jax.tree.map(lambda x: x[0], d["pab"]))
        out["cnt_win"], out["peak_win"] = jax.vmap(
            lambda i: jplanner.window_device(i, N + 1))(d["starts"])
        out["pol_plain"] = jax.vmap(apply_plain)(d["x_plain"])
        out["pol_bundle"] = jax.vmap(apply_bundle)(d["x_bundle"])
        for ax in "xyz":
            out["rot_" + ax] = getattr(jmath3d, "rot_" + ax)(d["angles"])
        out["v_local"] = jtransforms.v_global_to_local(d["q"], d["v"])
        out["mass"] = jax.vmap(lambda m: dataclasses.replace(jspec, mass=m).total_mass())(
            d["masses"])
        out["mass_nominal"] = jspec.total_mass()
        return out

    ref = {k: np.asarray(v) for k, v in jax.jit(jax_values)(inputs).items()}
    return dict(solver=solver, pb=pb, X=torch.as_tensor(X), U=torch.as_tensor(U), ref=ref,
                inputs=inputs, jspec=jspec, jsolver=jsolver, gait=gait, payload=payload)


def _counted(log):
    def fn(spec, X, A, Fe):
        log.append(X.shape[0])
        return dyncore_plain(spec, X, A, Fe)
    return fn


def _close(a, b, scale=1e-4):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, b, rtol=0, atol=scale * max(1.0, float(np.abs(b).max())))


def test_dyncore_evaluators_match_jax_xla(case):
    """Each evaluator over (alphas, problems) in one kernel-1 call; the cost
    at the JAX test's rtol 2e-5, the rows at 1e-4 of their largest entry."""
    solver, X, U, ref = case["solver"], case["X"], case["U"], case["ref"]
    pab = case["pb"].map(lambda t: t[None].expand((2,) + t.shape))
    spec, w = solver.spec, solver.weights
    n_eval = 2 * 3 * (solver.N + 1)
    for name, fn in (("cost_dual", lin.cost_dual_dyncore), ("cost", lin.total_cost_dyncore),
                     ("dual", lin.dual_g_dyncore), ("r_eq", lin.eq_residuals_dyncore),
                     ("g", lin.ineq_g_dyncore)):
        log = []
        out = fn(spec, w, X, U, pab, core_fn=_counted(log))
        assert log == [n_eval], name
        if name == "cost_dual":
            cost, r_eq, g = out
        elif name == "dual":
            r_eq, g = out
        else:
            cost = r_eq = g = out
        if name in ("cost_dual", "cost"):
            assert cost.shape == (2, 3)
            np.testing.assert_allclose(cost.numpy(), ref["cost"], rtol=2e-5)
        if name in ("cost_dual", "dual", "r_eq"):
            _close(r_eq, ref["r_eq"])
        if name in ("cost_dual", "dual", "g"):
            _close(g, ref["g"])


def test_solver_evaluators_over_a_batch(case):
    solver, X, U, pb, ref = case["solver"], case["X"][1], case["U"][1], case["pb"], case["ref"]
    np.testing.assert_allclose(solver._total_cost(X, U, pb).numpy(), ref["cost"][1], rtol=2e-5)
    r_eq, g = solver._dual_g(X, U, pb)
    _close(r_eq, ref["r_eq"][1])
    _close(g, ref["g"][1])
    assert torch.equal(solver._ineq_g(X, U, pb), g)


def test_solution_properties(case):
    X, U = case["X"][0], case["U"][0]
    sol = Solution(X, U, None, None, None)
    for b in range(X.shape[0]):
        jsol = JS.Solution(X[b].numpy(), U[b].numpy(), None, None, None)
        for name in ("q", "v", "a", "f"):
            np.testing.assert_array_equal(getattr(sol, name)[b].numpy(), getattr(jsol, name))
    assert sol.f.shape == (X.shape[0], U.shape[1], 4, 3)


def test_setters_take_effect_at_the_next_solve(case):
    """The setters write the JAX package's config fields; the port's next
    solve reads them: set_max_iter the iterations of a solve without
    n_iter, set_nlp_tol its early exit, set_qp_tol the inner loop's (a cold
    step of tests/test_ineq_al.py's stress trot, whose cone hinges are
    active: three passes at qp_tol 0, one at 1e9)."""
    solver, X, U, p = F.flagship(device="cpu", n_nodes=4)
    jsolver = case["jsolver"]
    for s in (solver, jsolver):
        s.set_max_iter(3)
        s.set_nlp_tol(0.0)
        s.set_qp_tol(1.0e-3)
    for f in ("max_iter", "nlp_tol", "qp_tol"):
        assert getattr(solver.opt, f) == getattr(jsolver.opt, f), f
    assert int(solver.solve(X, U, p).stats.sqp_iters) == 3
    solver.set_nlp_tol(1.0e9)
    assert int(solver.solve(X, U, p).stats.sqp_iters) == 1

    stress, ps = _stress_problem()
    Xs, Us = stress.cold_start(ps)
    stress.set_qp_tol(0.0)
    assert int(stress.solve(Xs, Us, ps, 1).stats.qp_iters) > 1
    stress.set_qp_tol(1.0e9)
    assert int(stress.solve(Xs, Us, ps, 1).stats.qp_iters) == 1


@pytest.mark.parametrize("k", NODES)
def test_stage_residual_from_params(case, k):
    solver, X, U, pb, ref = case["solver"], case["X"][0], case["U"][0], case["pb"], case["ref"]
    r = stage_residual_from_params(solver.spec, solver.weights, X[:, k], U[:, k], pb, k)
    res = ref["res"][:, NODES.index(k)]
    assert r.shape == res.shape
    _close(r, res)


def test_window_device(case):
    jgait = case["gait"]
    spec = case["solver"].spec
    planner = ContactPlanner(spec.feet_frame_names, case["solver"].dt_nodes, jgait)
    n = case["solver"].N + 1
    for j, i in enumerate(STARTS):
        for start in (torch.tensor(i), i):
            cnt, peak = planner.window_device(start, n, device="cpu")
            assert cnt.device.type == "cpu" and cnt.dtype == torch.int32
            np.testing.assert_array_equal(cnt.numpy(), case["ref"]["cnt_win"][j])
            np.testing.assert_array_equal(peak.numpy(), case["ref"]["peak_win"][j])
            np.testing.assert_array_equal(cnt.numpy(), planner.get_contacts(i, n))
            np.testing.assert_array_equal(peak.numpy(), planner.get_peaks(i, n))


@pytest.mark.parametrize("which", ["plain", "bundle"])
def test_make_policy_apply(case, which):
    """The targets within 5e-5 of the JAX apply (tests/test_torch_policy.py's
    bound), over one and two leading dims."""
    path, v_des = (POLICY, None) if which == "plain" else (BUNDLE, V_DES)
    apply_fn = make_policy_apply(path, v_des=v_des, device="cpu")
    x = torch.as_tensor(case["inputs"]["x_" + which])
    ref = case["ref"]["pol_" + which]
    np.testing.assert_allclose(apply_fn(x).numpy(), ref, rtol=0, atol=5e-5)
    two = apply_fn(x.reshape(4, N_POLICY // 4, 47))
    assert two.shape == (4, N_POLICY // 4, 12)
    np.testing.assert_array_equal(two.reshape(-1, 12).numpy(), apply_fn(x).numpy())


def test_spec_properties(case):
    spec, jspec, ref = case["solver"].spec, case["jspec"], case["ref"]
    assert spec.n_foot == jspec.n_foot == 4
    np.testing.assert_array_equal(spec.ancestor_mask, jspec.ancestor_mask)
    np.testing.assert_allclose(float(spec.total_mass()), ref["mass_nominal"], rtol=1e-6)
    payload = case["payload"]
    assert payload.total_mass().shape == (4,)
    np.testing.assert_allclose(payload.total_mass().numpy(), ref["mass"], rtol=1e-6)


def test_rotations_and_local_velocity(case):
    ref, d = case["ref"], case["inputs"]
    for ax in "xyz":
        _close(getattr(math3d, "rot_" + ax)(torch.as_tensor(d["angles"])), ref["rot_" + ax], 1e-6)
    v_loc = transforms.v_global_to_local(torch.as_tensor(d["q"]), torch.as_tensor(d["v"]))
    _close(v_loc, ref["v_local"], 1e-5)
