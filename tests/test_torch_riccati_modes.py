"""The solver's Riccati routes: the sweep and rollout twins against the JAX
package's structured scan, the split chain against the fused one, the
route each (linearize_mode, riccati_mode, N) takes, and the N=100 route's
RTI step against the JAX golden (tests/data/go2_trot_n100_golden.npz,
``scripts/make_torch_long_horizon_golden.py``).

No JAX solver is compiled here and no Pallas kernel runs: one jitted JAX
function (terminal Gram, structured sweep, structured rollout) is the
reference of the twins. The CUDA kernels against the twins on a GPU:
tests/test_torch_cuda_kernels.py.
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.solver import sqp as jsqp
from iterative_learning_nmpc_tpu_torch import flagship as F
from iterative_learning_nmpc_tpu_torch.interop import (
    params_from_numpy, spec_from_numpy, warm_start_from_numpy, weights_from_numpy)
from iterative_learning_nmpc_tpu_torch.ops import dynjac as dj
from iterative_learning_nmpc_tpu_torch.ops import lingram as lg
from iterative_learning_nmpc_tpu_torch.ops import riccati as ric
from iterative_learning_nmpc_tpu_torch.solver import linearize as lin
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver

from test_torch_kernels_plain import riccati_case  # noqa: F401 (fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# small CPU tensors: one intra-op thread, so that the test workers, which
# share the cores, do not oversubscribe them
torch.set_num_threads(1)
REL_GATE = 1e-3                    # the bench's rel |dU| / (1 + |U|) gate


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.fixture(scope="module")
def sweep_case(riccati_case):  # noqa: F811
    """riccati_case's B=3, N=25 problems: the port's GN blocks, and the JAX
    reference's terminal Gram, defects, gains and alpha=1 rollout on them."""
    solver, X, U, pb = riccati_case
    js, jw = solver.spec, solver.weights
    h, lm, reg = solver.dt_nodes, float(solver.opt.lm_reg), float(solver.cost.reg_eps_e)
    spec, w = spec_from_numpy(js, device="cpu"), weights_from_numpy(jw, device="cpu")
    tp = params_from_numpy(pb, device="cpu")
    blocks = lg.lingram_plain(spec, w, torch.as_tensor(X), torch.as_tensor(U), tp)

    @jax.jit
    def jax_ref(X, U, p, Q, R, M, qx, ru):
        def one(X_, U_, p_, Q_, R_, M_, qx_, ru_):
            rT, JT = jsqp._linearize_terminal(js, jw, X_[-1], p_)
            P_N = JT.T @ JT + reg * jnp.eye(36)
            p_N = JT.T @ rT
            d = solver._defects(X_, U_, p_)
            K, kff = jsqp._riccati_solve_structured(h, Q_, R_, M_, qx_, ru_, P_N, p_N,
                                                   d, jnp.float32(lm))
            dX, dU = jsqp._forward_delta_structured(h, K, kff, d, p_.x0 - X_[0],
                                                    jnp.float32(1.0))
            return P_N, p_N, d, K, kff, dX, dU

        return jax.vmap(one)(X, U, p, Q, R, M, qx, ru)

    ref = [torch.as_tensor(np.asarray(a)) for a in
           jax_ref(X, U, pb, *(b.numpy() for b in blocks))]
    term = (torch.as_tensor(X[:, -1]), tp.peak[:, :, -1], tp.base_ref_e,
            tp.joint_ref, tp.step_height)
    dx0 = tp.x0 - torch.as_tensor(X[:, 0])
    return dict(spec=spec, w=w, h=h, lm=lm, reg=reg, blocks=blocks, term=term,
                dx0=dx0, ref=dict(zip(("P_N", "p_N", "d", "K", "kff", "dX", "dU"), ref)))


def _scaled_err(a, b):
    """max |a - b| over the scale max(1, max |b|), for K and for kff."""
    return [float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
            for x, y in ((a[..., :36], b[..., :36]), (a[..., 36], b[..., 36]))]


def _assert_gains(c, gains):
    """The gains against the JAX reference's. fp32 gains are ill-conditioned
    at this point: noise of one ulp on the GN blocks moves the port's K by
    3.5e-3..4.0e-3 and kff by 2.0e-3..2.6e-3 of their scales, and either
    package's fp32 sweep is 1.2e-3 (K) and 5e-4..6e-4 (kff) of scale from
    the float64 sweep (scripts/measure_riccati_conditioning.py). So: within
    1e-2 of scale of JAX, and no further from the float64 sweep (the twin in
    float64 from JAX's P_N) than twice JAX's own distance from it."""
    r = c["ref"]
    assert gains.shape == r["K"].shape[:-1] + (37,)
    jax_gains = torch.cat([r["K"], r["kff"][..., None]], dim=-1)
    assert max(_scaled_err(gains, jax_gains)) <= 1e-2
    gains64 = ric.riccati_sweep_plain(c["h"], c["lm"], *(b.double() for b in c["blocks"]),
                                      r["P_N"].double(), r["p_N"].double(), r["d"].double())
    for e_port, e_jax in zip(_scaled_err(gains.double(), gains64),
                             _scaled_err(jax_gains.double(), gains64)):
        assert e_port <= 2.0 * e_jax


def test_sweep_terminal_twin_matches_jax(sweep_case):
    """Kernel 4's twin: terminal Gram + sweep against _linearize_terminal +
    _riccati_solve_structured."""
    c, r = sweep_case, sweep_case["ref"]
    gains = ric.riccati_sweep_terminal(c["spec"], c["w"], c["h"], c["lm"], c["reg"],
                                       *c["blocks"], r["d"], *c["term"])
    assert torch.equal(gains, ric.riccati_sweep_terminal_plain(
        c["spec"], c["w"], c["h"], c["lm"], c["reg"], *c["blocks"], r["d"], *c["term"]))
    _assert_gains(c, gains)


def test_sweep_twin_matches_jax(sweep_case):
    """Kernel 6's twin: the sweep from the JAX reference's own P_N, p_N."""
    c, r = sweep_case, sweep_case["ref"]
    _assert_gains(c, ric.riccati_sweep(c["h"], c["lm"], *c["blocks"], r["P_N"], r["p_N"],
                                       r["d"]))


def test_forward_rollout_twin_matches_jax(sweep_case):
    """Kernel 5's twin over the JAX reference's gains."""
    c, r = sweep_case, sweep_case["ref"]
    gains = torch.cat([r["K"], r["kff"][..., None]], dim=-1)
    dX, dU = ric.forward_rollout(c["h"], gains, r["d"], c["dx0"])
    for name, a, b in (("dX", dX, r["dX"]), ("dU", dU, r["dU"])):
        assert a.shape == b.shape
        assert rel(a, b) <= REL_GATE, name


def test_split_chain_equals_fused(sweep_case):
    """Kernel 4's twin then kernel 5's against kernel 3's, bit for bit."""
    c, r = sweep_case, sweep_case["ref"]
    args = (c["spec"], c["w"], c["h"], c["lm"], c["reg"], *c["blocks"], r["d"])
    gains = ric.riccati_sweep_terminal(*args, *c["term"])
    split = ric.forward_rollout(c["h"], gains, r["d"], c["dx0"])
    fused = ric.riccati_rollout_plain(*args, c["dx0"], *c["term"])
    for a, b in zip(split, fused):
        assert torch.equal(a, b)


def _spied(opt, cost, spec, log):
    """A TrajOptSolver whose step kernels append their names to ``log``."""
    def spy(name, fn):
        def call(*a, **k):
            log.append(name)
            return fn(*a, **k)
        return staticmethod(call)

    class Spied(TrajOptSolver):
        lingram = spy("lingram", lg.lingram)
        dynjac = spy("dynjac", dj.dynjac)
        gn_blocks_jacfwd = spy("gn_blocks_jacfwd", lin.gn_blocks_jacfwd)
        riccati_rollout = spy("riccati_rollout", ric.riccati_rollout)
        riccati_sweep_terminal = spy("riccati_sweep_terminal", ric.riccati_sweep_terminal)
        riccati_sweep = spy("riccati_sweep", ric.riccati_sweep)
        forward_rollout = spy("forward_rollout", ric.forward_rollout)

    return Spied(spec, opt, cost, device="cpu")


ROUTES = {
    # (n_nodes, batch, linearize_mode, riccati_mode) -> kernels in order
    "auto_n6_batch": ((6, 2, "auto", "auto"), ["lingram", "riccati_rollout"]),
    "auto_n89_single": ((89, 1, "auto", "auto"),
                        ["dynjac", "riccati_sweep_terminal", "forward_rollout"]),
    "pallas_jacfwd": ((6, 2, "jacfwd", "pallas"),
                      ["gn_blocks_jacfwd", "riccati_sweep", "forward_rollout"]),
    "pallas_jacrev_single": ((6, 1, "jacrev", "pallas"),
                             ["gn_blocks_jacfwd", "riccati_sweep", "forward_rollout"]),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_gn_step_route(route):
    (n, B, lin_mode, ric_mode), expect = ROUTES[route]
    base, X, U, p = F.flagship(device="cpu", n_nodes=n)
    opt = dataclasses.replace(base.opt, linearize_mode=lin_mode, riccati_mode=ric_mode)
    log = []
    solver = _spied(opt, base.cost, base.spec, log)
    Xb, Ub, pb = F.perturbed_batch(X, U, p, B, seed=3)
    dX, dU, _ = solver.gn_step(Xb, Ub, pb)
    assert log == expect
    assert dX.shape == (B, n + 1, 36) and dU.shape == (B, n, 30)
    assert bool(torch.isfinite(dU).all())


@pytest.mark.parametrize("change", [dict(riccati_mode="sequential"),
                                    dict(riccati_mode="associative"),
                                    dict(enable_time_opt=True)])
def test_unported_modes_raise(change):
    base, _, _, _ = F.flagship(device="cpu", n_nodes=6)
    with pytest.raises(NotImplementedError):
        TrajOptSolver(base.spec, dataclasses.replace(base.opt, **change), base.cost,
                      device="cpu")


def test_n100_rti_step_matches_jax_golden():
    """The long-horizon route (N=100 > 88) at B=2: one RTI step from the
    golden's converged state against the JAX package's step."""
    g = np.load(os.path.join(DATA, "go2_trot_n100_golden.npz"))
    base, _, _, p = F.flagship(device="cpu", n_nodes=100)
    assert float(np.abs(p.x0[0].numpy() - g["x0"]).max()) <= 1e-6
    assert np.array_equal(p.cnt[0].numpy(), g["cnt"])
    log = []
    solver = _spied(base.opt, base.cost, base.spec, log)
    B = g["x0_rti"].shape[0]
    rep = lambda a: torch.as_tensor(np.repeat(a[None], B, 0))
    pb = p.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
    pb = pb.replace(x0=torch.as_tensor(g["x0_rti"]), lam_ineq=rep(g["lam_ineq_conv"]))
    s = solver.solve(rep(g["X_conv"]), rep(g["U_conv"]), pb, 1)
    assert "riccati_rollout" not in log
    assert log[:3] == ["lingram", "riccati_sweep_terminal", "forward_rollout"]
    assert rel(s.U, g["U_rti"]) <= REL_GATE
    assert rel(s.X, g["X_rti"]) <= REL_GATE


def test_jacfwd_rti_step_matches_jax_golden():
    """The pallas + jacfwd route (B=1, N=25): one RTI step from the N=25
    golden's converged point against the JAX package's sequential/jacfwd
    step, the same math."""
    g = np.load(os.path.join(DATA, "go2_trot_n25_golden.npz"))
    base, _, _, p = F.flagship(device="cpu")
    opt = dataclasses.replace(base.opt, linearize_mode="jacfwd", riccati_mode="pallas")
    log = []
    solver = _spied(opt, base.cost, base.spec, log)
    X, U, _, lam_ineq = warm_start_from_numpy(g["X_conv"], g["U_conv"], g["U_conv"][:, :18],
                                              g["lam_ineq_conv"], device="cpu")
    s = solver.solve(X, U, p.replace(lam_ineq=lam_ineq), 1)
    assert set(log) == {"gn_blocks_jacfwd", "riccati_sweep", "forward_rollout"}
    assert rel(s.U[0], g["U_rti"]) <= REL_GATE
