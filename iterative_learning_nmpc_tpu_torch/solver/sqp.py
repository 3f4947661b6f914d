"""Batched GN-SQP / RTI trajectory optimizer.

Counterpart of ``iterative_learning_nmpc_tpu/solver/sqp.py`` for the
non-time-optimal path. One SQP iteration of a batch of B problems:

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

``linearize_mode="jacfwd"`` (or ``"jacrev"``) replaces steps 2-3 with the
JAX package's route of that name under ``riccati_mode="pallas"``:
linearize.gn_blocks_jacfwd + ops.terminal_gram, ops.riccati_sweep from the
given P_N, then ops.forward_rollout.

The B = 1 route keeps steps 3 and 4 on the same kernels as a batch: the
riccati kernels build in-kernel the terminal Gram that the JAX package builds
with ``_linearize_terminal`` + ``_riccati_solve_structured``, and dyncore
evaluates the line search where the JAX package uses its XLA residual stack.

The loops keep the semantics of ``jax.vmap`` over the JAX package's
``while_loop``s: the outer loop stops a problem at step_norm <= nlp_tol, the
inner AL loop at viol <= qp_tol (at most max_qp_iter passes), and a
problem that has stopped is frozen (``torch.where``) while the others run.
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
    OCPParams,
    dynamics_step,
    make_weights,
)
from ..ops.dyncore import dyncore
from ..ops.dynjac import dynjac
from ..ops.lingram import lingram
from ..ops.riccati import (
    FUSED_ROLLOUT_MAX_N,
    forward_rollout,
    riccati_rollout,
    riccati_sweep,
    riccati_sweep_terminal,
    terminal_gram,
)
from ..robots.spec import RobotSpec
from .linearize import cost_dual, gn_blocks_jacfwd, lingram_structured


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
    U: torch.Tensor          # (B, N, 30)
    stats: SolveStats
    lam_ineq: torch.Tensor   # (B, N, NC_INEQ) annealed AL hinge shifts
    r_eq: torch.Tensor       # (B, N, 18) bare equality rows at the solution


def resolve_linearize(opt: MPCOptConfig) -> str:
    """The solver's linearization route, "dynjac" or "jacfwd", from the
    config's ``linearize_mode`` and ``riccati_mode`` as the JAX package's
    solver resolves them (its ``solver/sqp.py:305-314``); raises for the
    modes the port does not have. The Riccati route is always "pallas".

    "auto" resolves to "dynjac" / "pallas" on every device: the JAX
    package's "auto" picks by whether Pallas is available, which the port
    does not depend on (CPU tensors take the kernels' plain twins).
    "dynjac" linearizes with kernel 2 (a batch) or 7 (B = 1) only.
    "jacfwd" is the JAX package's XLA route, chosen by name, and runs
    linearize.gn_blocks_jacfwd as torch ops on every device: it is not a
    fallback of the kernels. "jacrev" is jacfwd there too unless
    ``solve(use_fast_linearize=True)``, which the port does not have.
    """
    lin, ric = opt.linearize_mode, opt.riccati_mode
    if ric in ("sequential", "associative"):
        raise NotImplementedError(
            f"riccati_mode={ric!r} is not ported yet (ROADMAP Queue 1 item "
            "12); the port has 'auto' and 'pallas'")
    if ric not in ("auto", "pallas"):
        raise ValueError(f"unknown riccati_mode {ric!r}")
    if lin not in ("auto", "dynjac", "jacfwd", "jacrev"):
        raise ValueError(f"unknown linearize_mode {lin!r}")
    return "jacfwd" if lin in ("jacfwd", "jacrev") else "dynjac"


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
    riccati_rollout = staticmethod(riccati_rollout)
    riccati_sweep_terminal = staticmethod(riccati_sweep_terminal)
    riccati_sweep = staticmethod(riccati_sweep)
    forward_rollout = staticmethod(forward_rollout)
    dyncore = staticmethod(dyncore)

    def __init__(self, spec: RobotSpec, opt: MPCOptConfig, cost: MPCCostConfig,
                 device=None):
        if opt.enable_time_opt:
            raise NotImplementedError("the per-node time-optimal mode is not "
                                      "ported yet")
        self.linearize_mode = resolve_linearize(opt)
        self.device = resolve_device(device)
        self.spec = spec.to(self.device)
        self.opt = opt
        self.cost = cost
        self.N = opt.n_nodes
        self.dt_nodes = opt.get_dt_nodes()
        self.weights = make_weights(opt, cost, self.spec, device=self.device)
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

    def gn_step(self, X, U, p: OCPParams):
        """The raw alpha=1 GN step (dX1, dU1) and the defects at (X, U)."""
        defects = self._defects(X, U, p)
        dx0 = p.x0 - X[:, 0]
        inc = self.opt.torque_limit_in_qp
        spec, w, h = self.spec, self.weights, self.dt_nodes
        lm, reg_e = float(self.opt.lm_reg), float(self.cost.reg_eps_e)
        term = (X[:, -1], p.peak[:, :, -1], p.base_ref_e, p.joint_ref,
                p.step_height)
        if self.linearize_mode == "jacfwd":
            blocks = self.gn_blocks_jacfwd(spec, w, X, U, p, include_torque=inc)
            P_N, p_N = terminal_gram(spec, w, reg_e, *term)
            gains = self.riccati_sweep(h, lm, *blocks, P_N, p_N, defects)
            dX1, dU1 = self.forward_rollout(h, gains, defects, dx0)
            return dX1, dU1, defects
        if X.shape[0] == 1:
            blocks = lingram_structured(spec, w, X, U, p, include_torque=inc,
                                        dynjac_fn=self.dynjac)
        else:
            blocks = self.lingram(spec, w, X, U, p, include_torque=inc)
        if self.N <= FUSED_ROLLOUT_MAX_N:
            dX1, dU1 = self.riccati_rollout(spec, w, h, lm, reg_e, *blocks,
                                            defects, dx0, *term)
        else:
            gains = self.riccati_sweep_terminal(spec, w, h, lm, reg_e, *blocks,
                                                defects, *term)
            dX1, dU1 = self.forward_rollout(h, gains, defects, dx0)
        return dX1, dU1, defects

    def _cost_dual(self, X, U, p: OCPParams):
        return cost_dual(self.spec, self.weights, X, U, p, core_fn=self.dyncore)

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

    def _qp_pass(self, X, U, lam, params: OCPParams, alphas, merit_rho):
        """One inner AL pass for every problem: GN step with the current
        shifts, merit of every alpha and the dual inputs from one shared
        evaluation, deterministic tie-break toward the largest alpha."""
        dX1, dU1, defects = self.gn_step(X, U, params.replace(lam_ineq=lam))
        nA, B = alphas.shape[0], X.shape[0]
        a4 = alphas[:, None, None, None]
        Xc = (X[None] + a4 * dX1[None]).reshape((nA * B,) + X.shape[1:])
        Uc = (U[None] + a4 * dU1[None]).reshape((nA * B,) + U.shape[1:])
        pc = params.map(lambda t: t.repeat((nA,) + (1,) * (t.dim() - 1)))
        cost_c, r_eq_c, g_c = self._cost_dual(Xc, Uc, pc)
        merits = (cost_c.reshape(nA, B) + merit_rho * (1.0 - alphas)[:, None]
                  * defects.abs().sum((1, 2))[None])
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
    def solve(self, X, U, params: OCPParams, n_iter: int,
              merit_rho: float = 1.0e2) -> Solution:
        """Up to n_iter SQP iterations from the warm start (X, U, params),
        each wrapping up to max_qp_iter augmented-Lagrangian passes over the
        inequality hinges; n_iter <= 1 uses the steady-state alpha set."""
        alphas = torch.tensor(
            self.opt.ls_alphas_steady if n_iter <= 1 else self.opt.ls_alphas,
            dtype=X.dtype, device=X.device)
        B = X.shape[0]
        max_qp = max(1, int(self.opt.max_qp_iter))
        zero = torch.zeros(B, dtype=X.dtype, device=X.device)
        izero = torch.zeros(B, dtype=torch.int64, device=X.device)
        keys = ("X", "U", "lam", "r_eq", "cost", "viol", "step_norm", "alpha")
        st = dict(X=X, U=U, lam=params.lam_ineq,
                  r_eq=torch.zeros(B, self.N, 18, dtype=X.dtype, device=X.device),
                  cost=zero, viol=zero, step_norm=zero, alpha=zero)
        qp_iters, n_sqp = izero, izero
        run = torch.ones(B, dtype=torch.bool, device=X.device)
        for i in range(n_iter):
            if i > 0:
                run = run & (st["step_norm"] > self.opt.nlp_tol)
            if not bool(run.any()):
                break
            inner = dict(st, cost=zero, viol=zero, step_norm=zero, alpha=zero)
            j = izero
            run_in = run
            for jj in range(max_qp):
                if jj > 0:
                    run_in = run_in & (inner["viol"] > self.opt.qp_tol)
                if not bool(run_in.any()):
                    break
                new = self._qp_pass(inner["X"], inner["U"], inner["lam"],
                                    params, alphas, merit_rho)
                inner = {k: _select(run_in, new[k], inner[k]) for k in keys}
                j = j + run_in.long()
            st = {k: _select(run, inner[k], st[k]) for k in keys}
            qp_iters = torch.where(run, j, qp_iters)
            n_sqp = n_sqp + run.long()
        defect = self._defects(st["X"], st["U"], params).abs().amax((1, 2))
        stats = SolveStats(st["cost"], defect, st["step_norm"], st["alpha"],
                           st["viol"], qp_iters, n_sqp)
        return Solution(st["X"], st["U"], stats, st["lam"], st["r_eq"])

    def update_multipliers(self, X, U, params: OCPParams, lam_max: float = 30.0,
                           r_eq=None):
        """Equality AL update lam <- clip(lam + r_eq(X, U), -lam_max, lam_max);
        pass ``r_eq=sol.r_eq`` to reuse the rows the solve computed."""
        if r_eq is None:
            r_eq = self._cost_dual(X, U, params)[1]
        return torch.clamp(params.lam_eq + r_eq, -lam_max, lam_max)

    # ---------------- warm starts ----------------
    def cold_start(self, params: OCPParams):
        """Stationary guess: hold x0, gravity-balancing forces on the
        active feet -> X (B, N+1, 36), U (B, N, 30)."""
        B, N = params.x0.shape[0], self.N
        X = params.x0[:, None].expand(B, N + 1, params.x0.shape[1]).clone()
        cnt = params.cnt[:, :, :-1]                              # (B, 4, N)
        n_active = torch.clamp_min(cnt.sum(1), 1.0)             # (B, N)
        fz = GRAVITY * self.spec.mass.sum() / n_active
        f = torch.zeros(B, N, 4, 3, dtype=X.dtype, device=X.device)
        f[..., 2] = cnt.transpose(1, 2) * fz[..., None]
        a0 = torch.zeros(B, N, 18, dtype=X.dtype, device=X.device)
        return X, torch.cat([a0, f.reshape(B, N, 12)], dim=2)

    def shift_warmstart(self, X, U, shift: int):
        """Shift by ``shift`` nodes, repeating the tail."""
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
