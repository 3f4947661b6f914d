"""The identities the lingram kernel (``csrc/lingram.cu``) is built on,
checked in plain PyTorch on the CPU. Imports torch and numpy only: no JAX,
nothing compiled.

- d tau / d f_eff = -(d v_foot / d v)^T: the kernel seeds no force
  direction and reads the f columns of the dynamics rows off its
  v-direction tangents.
- d tau / d a = M(q) from values-only RNEA passes at unit acceleration
  with v = 0, f = 0 and gravity off: the kernel seeds no acceleration
  direction either.
- The Gram summed row group by row group, with the derivatives taken along
  that route (x tangents, unit-acceleration passes, duality), equals the
  Gram of the dense jacfwd stage Jacobian (``lingram_plain``, the kernel's
  plain twin) at B=1, N=100 (the long-horizon node count), for both
  ``include_torque`` values.
- ``lingram_plain`` equals the JAX package's jacfwd Gram at the stress
  case, with every row group on and with each row group alone, per part of
  each block (``ops.lingram.gram_gate``'s bound), read from
  ``tests/data/go2_trot_lingram_stress_golden.npz``
  (``scripts/make_torch_lingram_golden.py``).
- ``gram_gate``, the yardstick the kernel is held to on the card, rejects
  blocks from which any one row group is missing: a friction cone or the
  swing clearance is small beside the dynamics rows in the same block.

Inputs: seeded numpy states around the Go2 home pose with mixed contact
patterns (``stress_case``), in which every row group is active and the
hinges sit at their ties: stance feet with exactly zero force and no cone
shift, s > 0 and s = 0 AL shifts, swing feet below the plane, torque
hinges past their limits. ``tests/test_torch_cuda_kernels.py`` holds the
kernel to its twin on the same cases on the card.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.models import dynamics as dyn
from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu_torch.ocp.problem import OCPParams
from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore_plain
from iterative_learning_nmpc_tpu_torch.ops.lingram import (
    ROW_GROUPS, block_parts, gate_failures, gram_gate, isolate_group, lingram_plain)
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.solver.linearize import lingram_structured
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver, make_params

# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them
torch.set_num_threads(1)


def go2_solver(n_nodes: int, device="cpu") -> TrajOptSolver:
    """The Go2 trot solver at ``n_nodes`` nodes of 40 ms."""
    _, opt, cost = get_quadruped_config("trot", "go2")
    opt.n_nodes, opt.time_horizon = n_nodes, n_nodes * 0.04
    return TrajOptSolver(go2_spec(device=device), opt, cost, device=device)


def stress_case(solver: TrajOptSolver, B: int, seed: int):
    """(X (B, N+1, 36), U (B, N, 30), OCPParams) on the solver's device, from
    numpy's RandomState(seed), with every row group of the stage residual
    active: home pose + 0.05 noise, normal forces around 30 N (large ones on
    every fifth node, so torque hinges pass their limits), contacts on with
    probability 0.6, the plane within 2 cm of each foot (swing feet below
    it and above it), restricted foot placement with 5 cm patches, random
    equality duals and AL shifts of which half are 0; on every third node
    the stance feet carry exactly zero force with no cone shift."""
    N = solver.N
    rng = np.random.RandomState(seed)
    q0 = solver.spec.q_home.detach().cpu().numpy().astype(np.float32)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None, None], (B, N + 1, 1))
    X += (0.05 * rng.randn(B, N + 1, 36)).astype(np.float32)
    U = (0.3 * rng.randn(B, N, 30)).astype(np.float32)
    U[:, :, 20::3] += 30.0
    U[:, 1::5, 18:] = (150.0 * rng.randn(B, len(range(1, N, 5)), 12)).astype(np.float32)
    p_z = dyn.foot_positions(solver.spec.to("cpu"),
                             torch.as_tensor(X[..., :18])).numpy()[..., 2]
    ps = []
    for b in range(B):
        cnt = (rng.rand(4, N + 1) > 0.4).astype(np.float32)
        plane = np.zeros((4, N + 1, 3), np.float32)
        plane[..., 2] = p_z[b].T + 0.02 * rng.randn(4, N + 1)
        lam_ineq = 0.5 * np.abs(rng.randn(N, 36)) * (rng.rand(N, 36) > 0.5)
        for n in range(0, N, 3):
            for i in range(4):
                if cnt[i, n] > 0:
                    U[b, n, 18 + 3 * i:21 + 3 * i] = 0.0
                    lam_ineq[n, 5 * i:5 * i + 5] = 0.0
        ps.append(make_params(solver, X[b, 0], cnt, plane_point=plane,
                              cnt_loc=0.3 * rng.randn(4, N + 1, 3),
                              patch_radius=np.full((4, N + 1), 0.05), restrict=1.0,
                              lam_eq=0.1 * rng.randn(N, 18), lam_ineq=lam_ineq))
    p = OCPParams(**{f.name: torch.cat([getattr(q, f.name) for q in ps])
                     for f in dataclasses.fields(OCPParams)})
    dev = solver.device
    return torch.as_tensor(X, device=dev), torch.as_tensor(U, device=dev), p


def unit_acceleration_columns(spec, q: torch.Tensor) -> torch.Tensor:
    """(..., 18, 18): column j is tau at a = e_j with v = 0, no foot force
    and gravity off, the kernel's values-only passes (not symmetrised)."""
    eye = torch.eye(18, dtype=q.dtype)
    qe = q.unsqueeze(-2).expand(q.shape[:-1] + (18, 18))
    return dyn.rnea(spec, qe, torch.zeros_like(qe), eye.expand_as(qe),
                    gravity=0.0).transpose(-1, -2)


def kernel_route_dynjac(spec, X: torch.Tensor, A: torch.Tensor, Fe: torch.Tensor):
    """``dynjac_plain``'s (prim (M, 42), J (M, 42, 54)) with the derivatives
    taken along the kernel's route: forward tangents along the 36 x
    directions only, d tau / d a from the unit-acceleration passes (the foot
    positions and velocities do not depend on a)."""
    def one(x, a, fe):
        out = dyncore_plain(spec, x[None], a[None], fe[None])[0]
        return out, out

    Jx, prim = torch.func.vmap(torch.func.jacfwd(one, has_aux=True))(X, A, Fe)
    Ja = torch.zeros(X.shape[0], 42, 18, dtype=X.dtype)
    Ja[:, 24:] = unit_acceleration_columns(spec, X[:, :18])
    return prim, torch.cat([Jx, Ja], dim=2)


@pytest.fixture(scope="module")
def long_case():
    solver = go2_solver(100)
    return (solver, *stress_case(solver, 1, seed=7))


def _states(long_case, nodes):
    """(q, v, a, f_eff) of the case's first ``nodes`` nodes, flat."""
    solver, X, U, p = long_case
    cnt = p.cnt[0, :, :nodes].T
    fe = (cnt[:, :, None] * U[0, :nodes, 18:].reshape(nodes, 4, 3)).reshape(nodes, 12)
    return X[0, :nodes, :18], X[0, :nodes, 18:], U[0, :nodes, :18], fe


@pytest.mark.parametrize("first", [0, 1, 2])
def test_force_columns_by_duality(long_case, first):
    """d tau / d f_eff = -(d v_foot / d v)^T, on nodes with zero-force
    stance feet (first = 0), large forces (1) and the rest (2)."""
    spec = long_case[0].spec
    q, v, a, fe = (t[first::5][:8] for t in _states(long_case, 100))
    J_f = torch.func.vmap(torch.func.jacfwd(
        lambda f, q_, v_, a_: dyn.rnea(spec, q_, v_, a_, f_ext_feet=f.reshape(4, 3))))(
        fe, q, v, a)                                           # (M, 18, 12)
    J_vf = torch.func.vmap(torch.func.jacfwd(
        lambda v_, q_: dyn.foot_velocities(spec, q_, v_).reshape(12)))(v, q)  # (M, 12, 18)
    scale = float(J_vf.abs().max())
    assert float((J_f + J_vf.transpose(1, 2)).abs().max()) <= 1e-6 * max(1.0, scale)


def test_mass_matrix_from_unit_accelerations(long_case):
    """The values-only passes give d tau / d a (jacfwd) and models.dynamics
    .mass_matrix(q), at the case's first 20 nodes."""
    spec = long_case[0].spec
    q, v, a, fe = _states(long_case, 20)
    cols = unit_acceleration_columns(spec, q)
    J_a = torch.func.vmap(torch.func.jacfwd(
        lambda a_, q_, v_, f_: dyn.rnea(spec, q_, v_, a_, f_ext_feet=f_.reshape(4, 3))))(
        a, q, v, fe)
    scale = max(1.0, float(J_a.abs().max()))
    assert float((cols - J_a).abs().max()) <= 1e-5 * scale
    assert float((cols - dyn.mass_matrix(spec, q)).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("include_torque", [True, False])
def test_row_group_gram_equals_dense_gram(long_case, include_torque):
    """The Gram by row groups along the kernel's derivative route against
    the dense jacfwd Gram, per block within the bound of
    tests/test_torch_dynjac.py's N=25 comparison (one package, two fp32
    orders of the same sums), at B=1, N=100."""
    solver, X, U, p = long_case
    a_blocks = lingram_structured(solver.spec, solver.weights, X, U, p,
                                  include_torque=include_torque,
                                  dynjac_fn=kernel_route_dynjac)
    b_blocks = lingram_plain(solver.spec, solver.weights, X, U, p, include_torque)
    for name, a, b in zip(("Q", "R", "M", "qx", "ru"), a_blocks, b_blocks):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=3e-5 * max(float(b.abs().max()), 1.0), err_msg=name)


STRESS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "go2_trot_lingram_stress_golden.npz")


@pytest.fixture(scope="module")
def stress_golden():
    """(solver, X, U, p, golden) at the golden's inputs (B=1, N=25)."""
    g = np.load(STRESS_GOLDEN)
    p = OCPParams(**{f.name: torch.as_tensor(g[f"p_{f.name}"])
                     for f in dataclasses.fields(OCPParams)})
    solver = go2_solver(g["U"].shape[1])
    return solver, torch.as_tensor(g["X"]), torch.as_tensor(g["U"]), p, g


def test_stress_golden_inputs_are_stress_case(stress_golden):
    """The golden was made from this file's stress_case (B=1, N=25, seed 8)."""
    solver, X, U, p, _ = stress_golden
    X2, U2, p2 = stress_case(solver, 1, seed=8)
    assert torch.equal(X, X2) and torch.equal(U, U2)
    for f in dataclasses.fields(OCPParams):
        assert torch.equal(getattr(p, f.name), getattr(p2, f.name)), f.name


@pytest.mark.parametrize("label", ["all", *ROW_GROUPS])
def test_lingram_plain_matches_jax_at_stress_case(stress_golden, label):
    """The port's plain twin against the JAX package's Gram, with every row
    group on ("all") or one row group alone, per part of each block within
    3e-4 * max(1, |part|)."""
    solver, X, U, p, g = stress_golden
    w = solver.weights if label == "all" else isolate_group(solver.weights, label)
    got = block_parts(lingram_plain(solver.spec, w, X, U, p, True))
    ref = block_parts([torch.as_tensor(g[f"{label}_{n}"]) for n in ("Q", "R", "M", "qx", "ru")])
    assert max(float(b.abs().max()) for _, b in ref[:5]) > 0.0    # the group is active
    bad = [f"{n} {float((a - b).abs().max()):.2e}" for (n, a), (_, b) in zip(got, ref)
           if not float((a - b).abs().max()) <= 3e-4 * max(1.0, float(b.abs().max()))]
    assert not bad, bad


@pytest.fixture(scope="module")
def short_case():
    solver = go2_solver(6)
    return (solver, *stress_case(solver, 1, seed=8))


@pytest.mark.parametrize("group", list(ROW_GROUPS))
def test_gram_gate_rejects_a_missing_row_group(short_case, group):
    """Blocks with one row group left out (its weights at 0: for the cone,
    the output of a kernel whose closed-form cone blocks are zero) fail the
    gate's check of that group alone, at the stress case's first 6 nodes,
    though several pass the check with every group on."""
    solver, X, U, p = short_case

    def without(spec, w, X_, U_, p_, inc):
        fs = ROW_GROUPS[group]
        return lingram_plain(spec, dataclasses.replace(
            w, **{f: torch.zeros_like(getattr(w, f)) for f in fs}), X_, U_, p_, inc)

    assert gate_failures(gram_gate(without, solver.spec, solver.weights, X, U, p, True,
                                   labels=(group,)))
