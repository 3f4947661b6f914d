"""Batched GN-SQP / RTI trajectory optimizer.

Counterpart of ``iterative_learning_nmpc_tpu/solver/sqp.py``. One SQP
iteration of a batch of B problems:

  1. shooting defects (exactly linear double-integrator dynamics),
  2. Gauss-Newton blocks of every (problem, node)      -> ops.lingram, or for
     a single problem (B = 1, the controller's replan) the JAX package's
     unbatched route: linearize.lingram_structured    -> ops.dynjac,
  3. terminal Gram, Riccati sweep, alpha=1 rollout     -> ops.riccati_rollout
     (N <= 88), or ops.riccati_sweep_terminal -> ops.forward_rollout
     (N > 88, the JAX package's long-horizon split),
  4. merit of every line-search alpha + the AL dual inputs from one
     FK/RNEA pass over all candidates                  -> ops.dyncore,
  5. damped inequality-dual update.

The other routes are the JAX package's, each named by the configuration
(``resolve_routes``); none stands in for a kernel:

- ``linearize_mode="jacfwd"`` (or ``"jacrev"``) forms the blocks of step 2
  with linearize.gn_blocks_jacfwd as torch ops, or with
  linearize.gn_blocks_fast under ``solve(use_fast_linearize=True)``; under
  ``riccati_mode="pallas"`` step 3 is then ops.terminal_gram,
  ops.riccati_sweep from the given P_N and ops.forward_rollout,
- ``riccati_mode="sequential"`` sweeps and rolls out node by node in torch
  (ops.riccati.riccati_sweep_structured / forward_delta_structured, the JAX
  package's structured scans) after the blocks of step 2,
- ``riccati_mode="associative"`` sweeps by parallel_riccati (a scan of
  depth ceil(log2(N+1)) over the nodes) and rolls out by forward_delta,
- ``enable_time_opt`` appends each node's duration as a 31st input: the
  shooting dynamics become bilinear, the blocks come from
  gn_blocks_jacfwd over 31 input columns, the per-node A_k/B_k from
  ocp.problem.dynamics_jacobians, the sweep is riccati_solve and the
  rollout forward_delta; the merit of each line-search candidate reads its
  true defects.

Step 4 runs on ops.dyncore in every route (the time-optimal mode's three
dt rows of a node are added in torch). The B = 1 route keeps steps 3 and 4
on the same kernels as a batch: the riccati kernels build in-kernel the
terminal Gram that the JAX package builds with ``_linearize_terminal`` +
``_riccati_solve_structured``, and dyncore evaluates the line search where
the JAX package uses its XLA residual stack.

The loops keep the semantics of ``jax.vmap`` over the JAX package's
``while_loop``s: the outer loop stops a problem at step_norm <= nlp_tol, the
inner AL loop at viol <= qp_tol (at most max_qp_iter passes), and a
problem that has stopped is frozen (``torch.where``) while the others run.
Each loop test is one device -> host read of the problems still running.
The solve counts its passes, the problems they compute and advance, and
those reads (``utils.profiling.counters``); while the profiler runs, its
layers are spans (``sqp.solve``, ``sqp.pass``, ``sqp.linearize``, ...).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.dynamics import GRAVITY
from ..mpc.config import MPCCostConfig, MPCOptConfig
from ..ocp.problem import (
    NC_CONE,
    NC_INEQ,
    NC_PATCH,
    NC_TORQUE,
    NU,
    OCPParams,
    dynamics_jacobians,
    dynamics_matrices,
    dynamics_step,
    make_weights,
)
from ..ops.dyncore import dyncore
from ..ops.dynjac import dynjac
from ..ops.lingram import lingram
from ..ops.riccati import (
    FUSED_ROLLOUT_MAX_N,
    _cholesky_nan,
    forward_delta_structured,
    forward_rollout,
    riccati_rollout,
    riccati_sweep,
    riccati_sweep_structured,
    riccati_sweep_terminal,
    terminal_gram,
)
from ..robots.spec import RobotSpec
from ..utils.profiling import count, solve_record, span
from .linearize import (cost_dual, gn_blocks_fast, gn_blocks_jacfwd, lingram_structured,
                        make_const_blocks)
from .parallel_riccati import parallel_riccati


class SolveStats(NamedTuple):
    cost: torch.Tensor       # (B,) merit of the last accepted step
    defect: torch.Tensor     # (B,) max |defect| at the returned iterate
    step_norm: torch.Tensor  # (B,) alpha * max |dU| of the last step
    alpha: torch.Tensor      # (B,) last accepted step size
    viol: torch.Tensor       # (B,) max scale-normalized inequality violation
    qp_iters: torch.Tensor   # (B,) inner AL passes of the last SQP iteration
    sqp_iters: torch.Tensor  # (B,) outer SQP iterations executed


class Solution(NamedTuple):
    X: torch.Tensor          # (B, N+1, 36)
    U: torch.Tensor          # (B, N, 30), (B, N, 31) in the time-optimal mode
    stats: SolveStats
    lam_ineq: torch.Tensor   # (B, N, NC_INEQ) annealed AL hinge shifts
    r_eq: torch.Tensor       # (B, N, 18) bare equality rows at the solution

    @property
    def q(self):
        """Configurations (B, N+1, 18)."""
        return self.X[..., :18]

    @property
    def v(self):
        """Velocities (B, N+1, 18)."""
        return self.X[..., 18:]

    @property
    def a(self):
        """Accelerations (B, N, 18)."""
        return self.U[..., :18]

    @property
    def f(self):
        """Foot forces (B, N, 4, 3)."""
        return self.U[..., 18:NU].reshape(self.U.shape[:-1] + (4, 3))

    def dt_sol(self, dt_nominal):
        """The node durations: the optimized 31st input (B, N) in the
        time-optimal mode, else ``dt_nominal``."""
        if self.U.shape[-1] > NU:
            return self.U[..., NU]
        return dt_nominal


def _bcast_nodes(A: torch.Tensor, lead) -> torch.Tensor:
    """Constant (r, c), per-node (N, r, c) or per-(problem, node)
    (B, N, r, c) dynamics blocks -> (B, N, r, c) views."""
    while A.dim() < 4:
        A = A.unsqueeze(0)
    return A.expand(tuple(lead) + A.shape[-2:])


def riccati_solve(A, B, Q, R, M, qx, ru, P_N, p_N, defects, lm):
    """The generic backward sweep (sqp._riccati_solve, the oracle of the
    structured one) over a leading problem batch: A (36, 36), (N, 36, 36)
    or (B, N, 36, 36), B likewise with nu columns; Q (B, N, 36, 36),
    R (B, N, nu, nu), M (B, N, 36, nu), qx (B, N, 36), ru (B, N, nu),
    P_N (B, 36, 36), p_N (B, 36), defects (B, N, 36) with
    dx' = A dx + B du + d -> K (B, N, nu, 36), kff (B, N, nu). A failed
    factor gives NaNs, as jnp.linalg.cholesky does."""
    lead = Q.shape[:2]
    A, B = _bcast_nodes(A, lead), _bcast_nodes(B, lead)
    eyeu = torch.eye(R.shape[-1], dtype=Q.dtype, device=Q.device)
    P, pvec = P_N, p_N
    Ks, ks = [None] * lead[1], [None] * lead[1]
    for n in reversed(range(lead[1])):
        Ak, Bk = A[:, n], B[:, n]
        AkT, BkT = Ak.transpose(1, 2), Bk.transpose(1, 2)
        PA, PB = P @ Ak, P @ Bk
        Qxx = Q[:, n] + AkT @ PA
        Quu = R[:, n] + BkT @ PB + lm * eyeu
        Qux = M[:, n].transpose(1, 2) + BkT @ PA
        Pd = (P @ defects[:, n, :, None]) + pvec[..., None]
        qxn = qx[:, n] + (AkT @ Pd)[..., 0]
        qu = ru[:, n] + (BkT @ Pd)[..., 0]
        L = _cholesky_nan(Quu)
        sol = torch.cholesky_solve(torch.cat([Qux, qu[..., None]], dim=2), L)
        K, kff = -sol[..., :-1], -sol[..., -1]
        P = Qxx + Qux.transpose(1, 2) @ K
        P = 0.5 * (P + P.transpose(1, 2))
        pvec = qxn + (Qux.transpose(1, 2) @ kff[..., None])[..., 0]
        Ks[n], ks[n] = K, kff
    return torch.stack(Ks, 1), torch.stack(ks, 1)


def forward_delta(A, B, K, kff, defects, dx0):
    """The generic alpha=1 rollout (sqp._forward_delta) with constant or
    per-node A/B (as riccati_solve takes them) -> dX (B, N+1, 36),
    dU (B, N, nu)."""
    lead = K.shape[:2]
    A, B = _bcast_nodes(A, lead), _bcast_nodes(B, lead)
    dx = dx0
    dXs, dUs = [], []
    for n in range(lead[1]):
        du = kff[:, n] + (K[:, n] @ dx[..., None])[..., 0]
        dXs.append(dx)
        dUs.append(du)
        dx = (A[:, n] @ dx[..., None] + B[:, n] @ du[..., None])[..., 0] + defects[:, n]
    dXs.append(dx)
    return torch.stack(dXs, 1), torch.stack(dUs, 1)


RICCATI_MODES = ("pallas", "sequential", "associative")


def resolve_routes(opt: MPCOptConfig):
    """(linearize route, Riccati route) from the config's
    ``linearize_mode`` and ``riccati_mode`` as the JAX package's solver
    resolves them (its ``solver/sqp.py:305-314``): the linearization
    "dynjac" (kernel 2 for a batch, 7 at B = 1) or "jacfwd"
    (linearize.gn_blocks_jacfwd, or gn_blocks_fast under
    ``solve(use_fast_linearize=True)``; "jacrev" is the same route), the
    sweep "pallas" (the CUDA Riccati kernels), "sequential" or
    "associative". "auto" resolves to "dynjac" / "pallas" on every device:
    the JAX package's "auto" picks by whether Pallas is available, which the
    port does not depend on (CPU tensors take the kernels' plain twins).
    The time-optimal mode linearizes by jacfwd and sweeps by riccati_solve
    whatever the modes say, as the JAX package does, but for
    "associative", whose scan takes constant A/B only: that pair raises
    ValueError."""
    lin, ric = opt.linearize_mode, opt.riccati_mode
    if ric not in ("auto",) + RICCATI_MODES:
        raise ValueError(f"unknown riccati_mode {ric!r}")
    if lin not in ("auto", "dynjac", "jacfwd", "jacrev"):
        raise ValueError(f"unknown linearize_mode {lin!r}")
    if ric == "associative" and opt.enable_time_opt:
        raise ValueError("riccati_mode='associative' takes constant A/B only; the "
                         "time-optimal mode's dynamics are per node")
    return ("jacfwd" if lin in ("jacfwd", "jacrev") else "dynjac",
            "pallas" if ric == "auto" else ric)


def _n_active(mask) -> int:
    """The problems still running, of an int64 0/1 mask: one device -> host
    read, counted in ``solver.host_syncs``."""
    with span("sqp.sync"):
        n = int(mask.sum())
    count("solver.host_syncs")
    return n


def _select(mask, new, old):
    """Per-problem select: mask (B,) against tensors with leading B."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


class TrajOptSolver:
    """Batched solver bound to (robot, configs, device); the device is the
    CUDA card unless one is named.

    The step's kernels are the ops dispatchers below: CPU tensors take
    their plain PyTorch twins, CUDA tensors the CUDA kernels. A subclass may
    bind the plain twins by name to compose the plain path on any device.
    """

    lingram = staticmethod(lingram)
    dynjac = staticmethod(dynjac)
    gn_blocks_jacfwd = staticmethod(gn_blocks_jacfwd)
    gn_blocks_fast = staticmethod(gn_blocks_fast)
    riccati_rollout = staticmethod(riccati_rollout)
    riccati_sweep_terminal = staticmethod(riccati_sweep_terminal)
    riccati_sweep = staticmethod(riccati_sweep)
    forward_rollout = staticmethod(forward_rollout)
    riccati_sweep_structured = staticmethod(riccati_sweep_structured)
    forward_delta_structured = staticmethod(forward_delta_structured)
    parallel_riccati = staticmethod(parallel_riccati)
    riccati_solve = staticmethod(riccati_solve)
    forward_delta = staticmethod(forward_delta)
    dyncore = staticmethod(dyncore)

    def __init__(self, spec: RobotSpec, opt: MPCOptConfig, cost: MPCCostConfig,
                 device=None):
        self.linearize_mode, self.riccati_mode = resolve_routes(opt)
        # the time-optimal mode appends each node's duration as a 31st input
        self.time_opt = bool(opt.enable_time_opt)
        self.routes = dict(linearize=self.linearize_mode, riccati=self.riccati_mode,
                           time_opt=self.time_opt)
        self.nu = NU + int(self.time_opt)
        self.device = resolve_device(device)
        self.spec = spec.to(self.device)
        self.opt = opt
        self.cost = cost
        self.N = opt.n_nodes
        self.dt_nodes = opt.get_dt_nodes()
        self.weights = make_weights(opt, cost, self.spec, device=self.device)
        self.A, self.B = dynamics_matrices(self.dt_nodes, device=self.device)
        self._jac_const = make_const_blocks(self.weights)
        f32 = dict(dtype=torch.float32, device=self.device)
        # qp_tol normalization (cone per-foot gravity share, torque limit,
        # 10 cm patch) and the AL shift caps, as in the JAX solver
        total_w = max(float(self.weights.total_weight), 1.0)
        tlim = self.spec.torque_limit.detach().cpu().numpy().astype(np.float64)
        self._ineq_scales = torch.as_tensor(np.concatenate(
            [np.full(NC_CONE, 0.25 * total_w), tlim, np.full(NC_PATCH, 0.1)]
        ).astype(np.float32), **f32)
        self._lam_ineq_max = torch.as_tensor(np.concatenate(
            [np.full(NC_CONE, 0.5 * total_w), tlim, np.full(NC_PATCH, 0.2)]
        ).astype(np.float32), **f32)

    # ---------------- pieces of one iteration ----------------
    def _defects(self, X, U, p: OCPParams):
        return dynamics_step(X[:, :-1], U, p.dt) - X[:, 1:]

    def gn_step(self, X, U, p: OCPParams, use_fast_linearize: bool = False):
        """The raw alpha=1 GN step (dX1, dU1) and the defects at (X, U)."""
        defects = self._defects(X, U, p)
        dx0 = p.x0 - X[:, 0]
        inc = self.opt.torque_limit_in_qp
        spec, w, h = self.spec, self.weights, self.dt_nodes
        lm, reg_e = float(self.opt.lm_reg), float(self.cost.reg_eps_e)
        term = (X[:, -1], p.peak[:, :, -1], p.base_ref_e, p.joint_ref,
                p.step_height)
        with span("sqp.linearize"):
            if self.time_opt:
                blocks = self.gn_blocks_jacfwd(spec, w, X, U, p, include_torque=inc)
                A, B = dynamics_jacobians(X[:, :-1], U)
            elif self.linearize_mode == "jacfwd":
                if use_fast_linearize:
                    blocks = self.gn_blocks_fast(spec, w, X, U, p, *self._jac_const,
                                                 include_torque=inc)
                else:
                    blocks = self.gn_blocks_jacfwd(spec, w, X, U, p, include_torque=inc)
            elif X.shape[0] == 1:
                blocks = lingram_structured(spec, w, X, U, p, include_torque=inc,
                                            dynjac_fn=self.dynjac)
            else:
                blocks = self.lingram(spec, w, X, U, p, include_torque=inc)
        with span("sqp.riccati"):
            if self.time_opt:
                P_N, p_N = terminal_gram(spec, w, reg_e, *term)
                K, kff = self.riccati_solve(A, B, *blocks, P_N, p_N, defects, lm)
                dX1, dU1 = self.forward_delta(A, B, K, kff, defects, dx0)
            elif self.riccati_mode == "pallas" and self.linearize_mode == "jacfwd":
                P_N, p_N = terminal_gram(spec, w, reg_e, *term)
                gains = self.riccati_sweep(h, lm, *blocks, P_N, p_N, defects)
                dX1, dU1 = self.forward_rollout(h, gains, defects, dx0)
            elif self.riccati_mode == "pallas" and self.N <= FUSED_ROLLOUT_MAX_N:
                dX1, dU1 = self.riccati_rollout(spec, w, h, lm, reg_e, *blocks,
                                                defects, dx0, *term)
            elif self.riccati_mode == "pallas":
                gains = self.riccati_sweep_terminal(spec, w, h, lm, reg_e, *blocks,
                                                    defects, *term)
                dX1, dU1 = self.forward_rollout(h, gains, defects, dx0)
            else:
                P_N, p_N = terminal_gram(spec, w, reg_e, *term)
                if self.riccati_mode == "sequential":
                    K, kff = self.riccati_sweep_structured(h, *blocks, P_N, p_N, defects, lm)
                    dX1, dU1 = self.forward_delta_structured(h, K, kff, defects, dx0)
                else:
                    K, kff = self.parallel_riccati(self.A, self.B, *blocks, P_N, p_N,
                                                   defects, lm)
                    dX1, dU1 = self.forward_delta(self.A, self.B, K, kff, defects, dx0)
        return dX1, dU1, defects

    def _cost_dual(self, X, U, p: OCPParams):
        """(merit cost, r_eq, g) of each trajectory from one kernel-1 pass
        over [a, f]; the time-optimal mode's dt rows join the cost in torch
        (ocp.problem.stage_residual reads the 31st input)."""
        return cost_dual(self.spec, self.weights, X, U, p, core_fn=self.dyncore)

    def _total_cost(self, X, U, p: OCPParams):
        """The merit cost (B,) of each trajectory (kernel 1)."""
        return self._cost_dual(X, U, p)[0]

    def _dual_g(self, X, U, p: OCPParams):
        """(r_eq (B, N, 18), g_ineq (B, N, NC_INEQ)) from one kernel-1 pass."""
        return self._cost_dual(X, U, p)[1:]

    def _ineq_g(self, X, U, p: OCPParams):
        """Raw inequality values (B, N, NC_INEQ), physical units."""
        return self._dual_g(X, U, p)[1]

    def _ineq_update_from_g(self, g, params: OCPParams, lam_ineq):
        """Damped, clipped AL shift update + scale-normalized violation:
        s <- mask * clip(s + g_+ + 0.25 g_-, 0, s_max)."""
        B, N = g.shape[0], g.shape[1]
        cnt_n = params.cnt[:, :, :N].transpose(1, 2)
        mask = torch.cat([
            torch.repeat_interleave(cnt_n, 5, dim=2),
            torch.ones(B, N, NC_TORQUE, dtype=g.dtype, device=g.device),
            params.restrict[:, None, None] * cnt_n,
        ], dim=2)
        step = torch.clamp_min(g, 0.0) + 0.25 * torch.clamp_max(g, 0.0)
        lam_new = mask * torch.minimum(torch.clamp_min(lam_ineq + step, 0.0),
                                       self._lam_ineq_max)
        viol = (torch.clamp_min(g, 0.0) / self._ineq_scales).amax((1, 2))
        return lam_new, viol

    def _qp_pass(self, X, U, lam, params: OCPParams, alphas, merit_rho,
                 use_fast_linearize: bool = False):
        """One inner AL pass for every problem: GN step with the current
        shifts, merit of every alpha and the dual inputs from one shared
        evaluation, deterministic tie-break toward the largest alpha. The
        merit's defect term is (1 - alpha) |d| where the dynamics are
        linear; the time-optimal mode's bilinear dynamics read each
        candidate's true defects, and its cost takes the current shifts (the
        JAX package's ``_merit_select``)."""
        p_lam = params.replace(lam_ineq=lam)
        dX1, dU1, defects = self.gn_step(X, U, p_lam, use_fast_linearize)
        nA, B = alphas.shape[0], X.shape[0]
        with span("sqp.merit"):
            a4 = alphas[:, None, None, None]
            Xc = (X[None] + a4 * dX1[None]).reshape((nA * B,) + X.shape[1:])
            Uc = (U[None] + a4 * dU1[None]).reshape((nA * B,) + U.shape[1:])
            pc = (p_lam if self.time_opt else params).map(
                lambda t: t.repeat((nA,) + (1,) * (t.dim() - 1)))
            cost_c, r_eq_c, g_c = self._cost_dual(Xc, Uc, pc)
            if self.time_opt:
                d_c = self._defects(Xc, Uc, pc).abs().sum((1, 2)).reshape(nA, B)
                merits = cost_c.reshape(nA, B) + merit_rho * d_c
            else:
                merits = (cost_c.reshape(nA, B) + merit_rho * (1.0 - alphas)[:, None]
                          * defects.abs().sum((1, 2))[None])
        with span("sqp.select"):
            m_min = merits.min(0).values
            tol = 4e-6 * m_min.abs()
            cand = torch.where(merits <= m_min + tol, alphas[:, None],
                               torch.full_like(merits, -float("inf")))
            best = cand.argmax(0)                                   # (B,)
            flat = best * B + torch.arange(B, device=X.device)
            alpha = alphas[best]
            lam_new, viol = self._ineq_update_from_g(g_c[flat], params, lam)
            return dict(X=Xc[flat], U=Uc[flat], lam=lam_new, r_eq=r_eq_c[flat],
                        cost=merits.gather(0, best[None])[0], viol=viol,
                        step_norm=alpha * dU1.abs().amax((1, 2)), alpha=alpha)

    # ---------------- public API ----------------
    def solve(self, X, U, params: OCPParams, n_iter: int | None = None,
              merit_rho: float = 1.0e2, use_fast_linearize: bool = False) -> Solution:
        """Up to n_iter (by default ``opt.max_iter``) SQP iterations from the
        warm start (X, U, params), each wrapping up to max_qp_iter
        augmented-Lagrangian passes over the inequality hinges; n_iter <= 1
        uses the steady-state alpha set.
        ``use_fast_linearize`` forms the blocks of the "jacfwd" route by
        linearize.gn_blocks_fast (the JAX package's linearize_stages_fast);
        the other routes and the time-optimal mode ignore it, as there."""
        if n_iter is None:
            n_iter = int(self.opt.max_iter)
        alphas = torch.tensor(
            self.opt.ls_alphas_steady if n_iter <= 1 else self.opt.ls_alphas,
            dtype=X.dtype, device=X.device)
        B = X.shape[0]
        max_qp = max(1, int(self.opt.max_qp_iter))
        with solve_record(B, self.N, self.routes):
            zero = torch.zeros(B, dtype=X.dtype, device=X.device)
            izero = torch.zeros(B, dtype=torch.int64, device=X.device)
            keys = ("X", "U", "lam", "r_eq", "cost", "viol", "step_norm", "alpha")
            st = dict(X=X, U=U, lam=params.lam_ineq,
                      r_eq=torch.zeros(B, self.N, 18, dtype=X.dtype, device=X.device),
                      cost=zero, viol=zero, step_norm=zero, alpha=zero)
            qp_iters, n_sqp = izero, izero
            # the masks are int64 0/1, so that a loop test sums them with no cast
            run = torch.ones(B, dtype=torch.int64, device=X.device)
            for i in range(n_iter):
                if i > 0:
                    run = run & (st["step_norm"] > self.opt.nlp_tol)
                if not _n_active(run):
                    break
                inner = dict(st, cost=zero, viol=zero, step_norm=zero, alpha=zero)
                j = izero
                run_in = run
                for jj in range(max_qp):
                    if jj > 0:
                        run_in = run_in & (inner["viol"] > self.opt.qp_tol)
                    n_in = _n_active(run_in)
                    if not n_in:
                        break
                    with span("sqp.pass"):
                        new = self._qp_pass(inner["X"], inner["U"], inner["lam"], params,
                                            alphas, merit_rho, use_fast_linearize)
                        with span("sqp.freeze"):
                            keep = run_in.bool()
                            inner = {k: _select(keep, new[k], inner[k]) for k in keys}
                            j = j + run_in
                    count("solver.al_passes")
                    count("solver.problem_passes", B)
                    count("solver.active_problem_passes", n_in)
                with span("sqp.freeze"):
                    ran = run.bool()
                    st = {k: _select(ran, inner[k], st[k]) for k in keys}
                    qp_iters = torch.where(ran, j, qp_iters)
                    n_sqp = n_sqp + run
            with span("sqp.defect"):
                defect = self._defects(st["X"], st["U"], params).abs().amax((1, 2))
        stats = SolveStats(st["cost"], defect, st["step_norm"], st["alpha"],
                           st["viol"], qp_iters, n_sqp)
        return Solution(st["X"], st["U"], stats, st["lam"], st["r_eq"])

    def update_multipliers(self, X, U, params: OCPParams, lam_max: float = 30.0,
                           r_eq=None):
        """Equality AL update lam <- clip(lam + r_eq(X, U), -lam_max, lam_max);
        pass ``r_eq=sol.r_eq`` to reuse the rows the solve computed."""
        with span("sqp.update_multipliers"):
            if r_eq is None:
                r_eq = self._dual_g(X, U, params)[0]
            return torch.clamp(params.lam_eq + r_eq, -lam_max, lam_max)

    def update_ineq_multipliers(self, X, U, params: OCPParams, lam_ineq):
        """The damped, clipped AL shift update at (X, U) and the
        scale-normalized violation (B,) of the qp_tol exit:
        s <- mask * clip(s + g_+ + 0.25 g_-, 0, s_max), cone rows reset
        where a foot is in swing, patch rows where unrestricted."""
        return self._ineq_update_from_g(self._ineq_g(X, U, params), params, lam_ineq)

    # ---------------- the reference API's setters ----------------
    # They write the config that ``solve`` reads at each call, so they take
    # effect at the next call (the JAX package's affect only the jit
    # specializations traced after them; the port has no trace).
    def set_max_iter(self, n: int) -> None:
        """SQP iterations of a ``solve`` called without ``n_iter`` (and of
        the controller's RTI replans, which read ``opt.max_iter``)."""
        self.opt.max_iter = int(n)

    def set_nlp_tol(self, tol: float) -> None:
        self.opt.nlp_tol = float(tol)

    def set_qp_tol(self, tol: float) -> None:
        self.opt.qp_tol = float(tol)

    # ---------------- warm starts ----------------
    def cold_start(self, params: OCPParams):
        """Stationary guess: hold x0, gravity-balancing forces on the
        active feet, and in the time-optimal mode the nominal durations ->
        X (B, N+1, 36), U (B, N, nu)."""
        B, N = params.x0.shape[0], self.N
        X = params.x0[:, None].expand(B, N + 1, params.x0.shape[1]).clone()
        cnt = params.cnt[:, :, :-1]                              # (B, 4, N)
        n_active = torch.clamp_min(cnt.sum(1), 1.0)             # (B, N)
        fz = GRAVITY * self.spec.mass.sum() / n_active
        f = torch.zeros(B, N, 4, 3, dtype=X.dtype, device=X.device)
        f[..., 2] = cnt.transpose(1, 2) * fz[..., None]
        cols = [torch.zeros(B, N, 18, dtype=X.dtype, device=X.device), f.reshape(B, N, 12)]
        if self.time_opt:
            cols.append(torch.full((B, N, 1), self.dt_nodes, dtype=X.dtype, device=X.device))
        return X, torch.cat(cols, dim=2)

    def shift_warmstart(self, X, U, shift: int):
        """Shift by ``shift`` nodes, repeating the tail (every input column,
        the time-optimal mode's durations included)."""
        idx_x = torch.clamp(torch.arange(self.N + 1, device=X.device) + shift, 0, self.N)
        idx_u = torch.clamp(torch.arange(self.N, device=X.device) + shift, 0, self.N - 1)
        return X[:, idx_x], U[:, idx_u]

    def shift_multipliers(self, lam, shift: int):
        idx = torch.clamp(torch.arange(self.N, device=lam.device) + shift, 0, self.N - 1)
        return lam[:, idx]


def make_params(solver: TrajOptSolver, x0, cnt, peak=None, plane_point=None,
                cnt_loc=None, patch_radius=None, restrict=0.0, base_ref=None,
                base_ref_e=None, joint_ref=None, step_height=0.05, dt=None,
                ground_height=0.0, lam_eq=None, lam_ineq=None) -> OCPParams:
    """OCPParams for ONE problem (a batch of one) from numpy-like inputs,
    with the JAX package's defaults. Replicate with
    ``p.map(lambda t: t.expand(B, *t.shape[1:]).contiguous())``."""
    N = solver.N
    f32 = np.float32
    asnp = lambda x: np.asarray(x, dtype=f32)
    cnt = asnp(cnt)
    if peak is None:
        peak = 1.0 - cnt
    if plane_point is None:
        plane_point = np.zeros((4, N + 1, 3), f32)
        plane_point[:, :, 2] = ground_height
    if cnt_loc is None:
        cnt_loc = np.zeros((4, N + 1, 3), f32)
    if patch_radius is None:
        patch_radius = np.full((4, N + 1), 1.0e3, f32)
    if base_ref is None:
        base_ref = np.zeros(12, f32)
    if base_ref_e is None:
        base_ref_e = base_ref
    if joint_ref is None:
        joint_ref = solver.spec.q_home.detach().cpu().numpy()[6:]
    if dt is None:
        dt = np.full((N,), solver.dt_nodes, f32)
    if lam_eq is None:
        lam_eq = np.zeros((N, 18), f32)
    if lam_ineq is None:
        lam_ineq = np.zeros((N, NC_INEQ), f32)
    t = lambda x: torch.as_tensor(asnp(x), device=solver.device)[None]
    return OCPParams(
        x0=t(x0), cnt=t(cnt), peak=t(peak), plane_point=t(plane_point),
        cnt_loc=t(cnt_loc), patch_radius=t(patch_radius), restrict=t(restrict),
        base_ref=t(base_ref), base_ref_e=t(base_ref_e), joint_ref=t(joint_ref),
        step_height=t(step_height), dt=t(dt), lam_eq=t(lam_eq),
        lam_ineq=t(lam_ineq))
