"""The port's batched RTI solve against the JAX package's (vmapped,
XLA-CPU sequential/jacfwd) solve: one steady-state step, a 5-step warm
chain with dual carry-over, and the per-problem freeze of the inner AL loop.

Go2 trot, N=6, B=3 problems near the converged flagship trajectory:
problems 0 and 1 carry small state perturbations and finish the inner loop
after one pass; problem 2 also has contact-patch targets 4 mm beyond a 2 mm
patch radius, so it keeps running inner passes after the others stopped.
One JAX compile (the RTI step) serves every test here.
"""
import dataclasses

import numpy as np
import pytest

import jax
import torch

from __graft_entry__ import _flagship
from iterative_learning_nmpc_tpu_torch import flagship as tflag
from iterative_learning_nmpc_tpu_torch.interop import params_from_numpy
from iterative_learning_nmpc_tpu_torch.models import dynamics as tdyn

N, B = 6, 3
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them (measured 4x slower without)
torch.set_num_threads(1)
# rel |dU| / (1 + |U|): the bench's gate. Problem 2's patch-hinge step is
# fp32-sensitive: either package moves 5e-3 against an fp64 solve of the
# same step (measured with the port in float64), so it is held to 2e-2.
GATE = (1e-3, 1e-3, 2e-2)


def rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / (1.0 + np.abs(np.asarray(b)))))


def near_converged_batch(n_nodes: int, batch: int, seed: int):
    """The port's converged flagship solution replicated over ``batch``
    problems (numpy), plus the JAX solver and a batched numpy OCPParams."""
    jsol, _, _, jp = _flagship(n_nodes=n_nodes)
    tsol, tX, tU, tp = tflag.flagship(n_nodes=n_nodes, device="cpu")
    conv = tsol.solve(tX, tU, tp, 15)
    rep = lambda a: np.repeat(np.asarray(a)[None], batch, 0)
    X, U = rep(conv.X[0].numpy()), rep(conv.U[0].numpy())
    pb = jax.tree.map(rep, jp)
    pb = dataclasses.replace(pb, lam_ineq=rep(conv.lam_ineq[0].numpy()))
    return jsol, tsol, X, U, pb, np.random.default_rng(seed)


@pytest.fixture(scope="module")
def case():
    jsol, tsol, X, U, pb, rng = near_converged_batch(N, B, seed=1)
    X[:, 1:] += (5e-4 * rng.standard_normal(X[:, 1:].shape)).astype(np.float32)
    # problem 2: patch targets 4 mm ahead of its feet (nodes >= 1) with 2 mm
    # patches in restricted mode -> violations the AL loop works off
    pf = tdyn.foot_positions(tsol.spec, torch.as_tensor(X[2, :, :18])).numpy()
    loc = np.transpose(pf, (1, 0, 2)).copy()
    loc[:, 1:, 0] += 0.004
    pb.cnt_loc[2] = loc
    pb.patch_radius[2] = 0.002
    pb.patch_radius[2, :, 0] = 0.01
    pb.restrict[2] = 1.0

    solve = jax.jit(jax.vmap(lambda x, u, pp: jsol.solve(x, u, pp, 1)))

    def jax_rti(X, U, p):
        """One RTI step and the equality-dual update clip(lam + r_eq, +-30)
        (TrajOptSolver.update_multipliers with r_eq=, done in numpy)."""
        s = solve(X, U, p)
        return s, np.clip(p.lam_eq + np.asarray(s.r_eq), -30.0, 30.0)

    return jsol, tsol, X, U, pb, jax_rti


def torch_rti(tsol, X, U, tp):
    s = tsol.solve(X, U, tp, 1)
    return s, tsol.update_multipliers(s.X, s.U, tp, r_eq=s.r_eq)


def test_rti_step_matches_jax(case):
    jsol, tsol, X, U, pb, jax_rti = case
    js, jlam = jax_rti(X, U, pb)
    ts, tlam = torch_rti(tsol, torch.as_tensor(X), torch.as_tensor(U),
                         params_from_numpy(pb, device="cpu"))
    for b in range(B):
        assert rel(ts.U[b], js.U[b]) <= GATE[b], b
        assert rel(ts.X[b], js.X[b]) <= GATE[b], b
    np.testing.assert_array_equal(ts.stats.qp_iters.numpy(), np.asarray(js.stats.qp_iters))
    np.testing.assert_array_equal(ts.stats.sqp_iters.numpy(), np.asarray(js.stats.sqp_iters))
    np.testing.assert_array_equal(ts.stats.alpha.numpy(), np.asarray(js.stats.alpha))
    # AL shifts are updated from constraint values in metres/newtons: fp32
    # agreement to 1e-5 absolute (the patch shifts are ~1e-3 m)
    np.testing.assert_allclose(ts.lam_ineq.numpy(), np.asarray(js.lam_ineq), rtol=0, atol=1e-5)
    # r_eq rows are w_dyn (~31.6) times base forces of ~150 N: one fp32 ulp
    # of the force is ~4e-4 here, so 5e-3 absolute (and the lam_eq update)
    np.testing.assert_allclose(ts.r_eq.numpy(), np.asarray(js.r_eq), rtol=0, atol=5e-3)
    np.testing.assert_allclose(tlam.numpy(), np.asarray(jlam), rtol=0, atol=5e-3)
    np.testing.assert_allclose(ts.stats.cost.numpy(), np.asarray(js.stats.cost), rtol=1e-4)
    # without r_eq= the update recomputes the rows at (X, U): the same FK/RNEA
    # values in a batch of another size, so within fp32 reassociation
    tp = params_from_numpy(pb, device="cpu")
    np.testing.assert_allclose(tsol.update_multipliers(ts.X, ts.U, tp).numpy(),
                               tlam.numpy(), rtol=0, atol=1e-5)


def test_inner_loop_freezes_finished_problems(case):
    """Problems 0/1 leave the inner AL loop after one pass while problem 2
    runs on; their results must be those of a solve that stopped there."""
    jsol, tsol, X, U, pb, jax_rti = case
    js, _ = jax_rti(X, U, pb)
    ts, _ = torch_rti(tsol, torch.as_tensor(X), torch.as_tensor(U),
                      params_from_numpy(pb, device="cpu"))
    qp = ts.stats.qp_iters.numpy()
    assert qp[0] == 1 and qp[1] == 1 and qp[2] > 1, qp
    np.testing.assert_array_equal(qp, np.asarray(js.stats.qp_iters))
    # the same batch with problem 2's patch restriction lifted: every
    # problem stops after one pass. Same shapes, same kernels, so a frozen
    # problem's result must be bit-identical between the two batches.
    calm = dataclasses.replace(pb, restrict=np.zeros_like(pb.restrict))
    tc, _ = torch_rti(tsol, torch.as_tensor(X), torch.as_tensor(U),
                      params_from_numpy(calm, device="cpu"))
    assert tc.stats.qp_iters.tolist() == [1, 1, 1]
    for b in (0, 1):
        for a, c in ((ts.X, tc.X), (ts.U, tc.U), (ts.lam_ineq, tc.lam_ineq),
                     (ts.r_eq, tc.r_eq), (ts.stats.cost, tc.stats.cost)):
            assert torch.equal(a[b], c[b]), b
    # problem 2's extra passes moved its AL shifts off their start values
    assert float(np.abs(ts.lam_ineq[2].numpy() - pb.lam_ineq[2]).max()) > 1e-4


def test_rti_chain_matches_jax(case):
    jsol, tsol, X, U, pb, jax_rti = case
    jX, jU, jl, jli = X, U, np.zeros_like(pb.lam_eq), pb.lam_ineq
    tX, tU = torch.as_tensor(X), torch.as_tensor(U)
    tl, tli = torch.as_tensor(jl), torch.as_tensor(jli)
    tp = params_from_numpy(pb, device="cpu")
    for step in range(5):
        jp = dataclasses.replace(pb, lam_eq=jl, lam_ineq=jli)
        js, jl = jax_rti(jX, jU, jp)
        jX, jU, jli = np.asarray(js.X), np.asarray(js.U), np.asarray(js.lam_ineq)
        jl = np.asarray(jl)
        ts, tl = torch_rti(tsol, tX, tU, tp.replace(lam_eq=tl, lam_ineq=tli))
        tX, tU, tli = ts.X, ts.U, ts.lam_ineq
        assert all(bool(torch.isfinite(t).all()) for t in (tX, tU, tl, tli))
        for b in range(B):
            # step 1 follows the first equality-dual jump (lam_eq from 0 to
            # r_eq): measured 3-4e-3 between the port in fp32 and in fp64 on
            # every problem, so 1e-2 per step; the chain re-contracts, and
            # its last step is held to the gate
            assert rel(tU[b], jU[b]) <= (GATE[b] if step == 4 else 1e-2), (step, b)
        np.testing.assert_allclose(tli.numpy(), jli, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=5e-3)
