"""Kernel 7's batched full-Jacobian route on the CPU
(``solver/linearize.linearize_stages_dynjac`` / ``lingram_stages_dynjac``,
the plain kernel-7 twin under them).

- (r, Jx, Ju) against the JAX package's jacfwd oracle
  (``vmap(sqp._linearize_stages)``, under one ``jax.jit``) on
  ``tests/test_dynjac_kernel.py``'s inputs: seed 3, B = 3, random contacts,
  ``restrict = 1``, nonzero ``lam_eq`` and ``lam_ineq``; at that test's
  bounds, rtol 1e-4 / atol 1e-3 on r and 1e-4 max|J| on Jx and Ju. The JAX
  package's own route runs kernel 7 in Pallas interpret mode and is not
  called here.
- The route's Gram blocks against the port's ``lingram_structured`` on the
  same inputs, at 1e-4 of each block's largest entry, with and without the
  torque rows.
- The route's dynamics core goes through its ``dynjac_fn`` once, at
  M = B * N.

~16 s of worker time, 12 s of it the one JAX compile (the oracle).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iterative_learning_nmpc_tpu.mpc.config import get_quadruped_config as jax_configs
from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
from iterative_learning_nmpc_tpu.solver import sqp as JS
from iterative_learning_nmpc_tpu_torch.mpc.config import get_quadruped_config
from iterative_learning_nmpc_tpu_torch.ocp.problem import OCPParams
from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac_plain
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
from iterative_learning_nmpc_tpu_torch.solver import linearize as lin
from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver, make_params

torch.set_num_threads(1)


def _inputs(B: int, N: int, q0: np.ndarray):
    """tests/test_dynjac_kernel.py::test_linearize_stages_dynjac_matches_oracle's
    draws, in its order: X, U, then each problem's contacts, footholds and
    multipliers."""
    rng = np.random.RandomState(3)
    X = np.tile(np.concatenate([q0, np.zeros(18, np.float32)])[None, None], (B, N + 1, 1))
    X += 0.05 * rng.randn(B, N + 1, 36).astype(np.float32)
    U = 0.3 * rng.randn(B, N, 30).astype(np.float32)
    U[:, :, 20::3] += 30.0
    per = []
    for b in range(B):
        per.append(dict(
            cnt=(rng.rand(4, N + 1) > 0.4).astype(np.float32),
            cnt_loc=0.3 * rng.randn(4, N + 1, 3).astype(np.float32),
            patch_radius=np.full((4, N + 1), 0.05, np.float32), restrict=1.0,
            lam_eq=0.1 * rng.randn(N, 18).astype(np.float32),
            lam_ineq=0.5 * np.abs(rng.randn(N, 36)).astype(np.float32)))
    return X, U, per


@pytest.fixture(scope="module")
def case():
    _, opt, cost = get_quadruped_config("trot", "go2")
    solver = TrajOptSolver(go2_spec(device="cpu"), opt, cost, device="cpu")
    B, N = 3, solver.N
    X, U, per = _inputs(B, N, solver.spec.q_home.numpy().astype(np.float32))
    plist = [make_params(solver, X[b, 0], **kw) for b, kw in enumerate(per)]
    pb = OCPParams(**{f: torch.cat([getattr(p, f) for p in plist])
                      for f in OCPParams.__dataclass_fields__})

    _, jopt, jcost = jax_configs("trot", "go2")
    jspec = jax_go2()
    jsolver = JS.TrajOptSolver(jspec, jopt, jcost)
    jp = [JS.make_params(jsolver, X[b, 0], kw.pop("cnt"), **kw) for b, kw in enumerate(per)]
    jpb = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *jp)
    oracle = jax.jit(jax.vmap(lambda X_, U_, p_: JS._linearize_stages(
        jspec, jsolver.weights, X_, U_, p_, include_torque=True)))
    ref = [np.asarray(a) for a in oracle(jnp.asarray(X), jnp.asarray(U), jpb)]
    return solver, torch.as_tensor(X), torch.as_tensor(U), pb, ref


def _counted(log):
    def fn(spec, X, A, Fe):
        log.append(X.shape[0])
        return dynjac_plain(spec, X, A, Fe)
    return fn


def test_route_matches_jax_jacfwd_oracle(case):
    solver, X, U, pb, (r0, Jx0, Ju0) = case
    log = []
    r1, Jx1, Ju1 = lin.linearize_stages_dynjac(
        solver.spec, solver.weights, X, U, pb, *solver._jac_const, include_torque=True,
        dynjac_fn=_counted(log))
    assert log == [X.shape[0] * solver.N]
    assert r1.shape == r0.shape and Jx1.shape == Jx0.shape and Ju1.shape == Ju0.shape
    np.testing.assert_allclose(r1.numpy(), r0, rtol=1e-4, atol=1e-3)
    for name, a1, a0 in (("Jx", Jx1, Jx0), ("Ju", Ju1, Ju0)):
        np.testing.assert_allclose(a1.numpy(), a0, rtol=0,
                                   atol=1e-4 * float(np.abs(a0).max()), err_msg=name)


@pytest.mark.parametrize("include_torque", [False, True])
def test_route_gram_matches_lingram_structured(case, include_torque):
    solver, X, U, pb, _ = case
    spec, w = solver.spec, solver.weights
    log = []
    route = lin.lingram_stages_dynjac(spec, w, X, U, pb, *solver._jac_const,
                                      include_torque=include_torque, dynjac_fn=_counted(log))
    assert log == [X.shape[0] * solver.N]
    ref = lin.lingram_structured(spec, w, X, U, pb, include_torque=include_torque)
    for name, a, b in zip(("Q", "R", "M", "qx", "ru"), route, ref):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, err)


def test_route_default_is_kernel_7():
    """The route's default ``dynjac_fn`` is the kernel dispatcher, whose CPU
    tensors take the plain twin."""
    import inspect

    from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac

    for fn in (lin.linearize_stages_dynjac, lin.lingram_stages_dynjac):
        assert inspect.signature(fn).parameters["dynjac_fn"].default is dynjac
