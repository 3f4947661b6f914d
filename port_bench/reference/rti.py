"""One warm real-time-iteration step of a batch of problems, written plainly.

A step is one Gauss-Newton SQP iteration wrapping up to ``max_qp_iter``
augmented-Lagrangian passes, then the equality multiplier update:

  pass:  defects d_k = f(x_k, u_k) - x_{k+1};
         Gauss-Newton blocks of every node as the Gram of [Jx | Ju | r],
         J by forward-mode differentiation of the stage rows;
         terminal Gram J^T J + reg_e I, J^T r;
         backward Riccati sweep with the constant double-integrator (A, B)
         and Levenberg regularisation lm on the input block;
         the alpha = 1 rollout (dX, dU);
         merit of every steady line-search alpha: cost + rho (1 - alpha) |d|_1,
         the largest alpha within 4e-6 relative of the best merit;
         shift update s <- mask clip(s + g_+ + 0.25 g_-, 0, s_max) and the
         scale-normalised violation;
  loop:  a problem stops its passes once its violation is <= qp_tol;
  after: lam_eq <- clip(lam_eq + r_eq, -30, 30).

Everything is dense and generic: no kernel, no structure of the blocks.
"""
from __future__ import annotations

import torch

from . import ocp
from .ocp import NU, NX
from .robot import Robot


def node_view(p: dict, N: int) -> dict:
    """Node parameters with leading (B, N)."""
    B = p["x0"].shape[0]
    node = lambda t: t[:, :, :N].transpose(1, 2)
    node3 = lambda t: t[:, :, :N].permute(0, 2, 1, 3)
    prob = lambda t: t.reshape((B, 1) + t.shape[1:]).expand((B, N) + t.shape[1:])
    return dict(cnt=node(p["cnt"]), peak=node(p["peak"]), plane=node3(p["plane"]),
                loc=node3(p["loc"]), patch=node(p["patch"]), restrict=prob(p["restrict"]),
                base_ref=prob(p["base_ref"]), joint_ref=prob(p["joint_ref"]),
                step_height=prob(p["step_height"]), lam=p["lam_eq"], lam_ineq=p["lam_ineq"])


# nodes linearised at once: bounds the forward-mode tangents' memory
CHUNK_NODES = 32768
# Where float32 rounding may turn a decision of the step, the check takes
# either outcome: the AL loop's stop where the reference's violation lies
# within PASS_BAND (relative) of qp_tol, and the line search's choice where
# the merits lie within ALPHA_BAND (relative to the least merit) of the
# rule's threshold. Each is about three times the widest that a program's
# flipped decision has needed (PERF.md, "How correct is decided"). A
# line-search choice is followed both ways only where the two choices move
# U by more than ALT_MIN of 1 + max |U|, and a problem keeps at most
# MAX_ROWS such branches.
PASS_BAND = 0.15
ALPHA_BAND = 5e-6
ALT_MIN = 5e-3
MAX_ROWS = 8


class RTI:
    """The step of one configuration, in ``dtype`` on ``device``."""

    def __init__(self, robot: Robot, opt: dict, cost: dict, dtype, device):
        self.robot, self.opt = robot, opt
        self.kw = dict(dtype=dtype, device=device)
        self.w = ocp.make_weights(opt, cost, robot, dtype, device)
        self.N = int(opt["n_nodes"])
        self.h = round(opt["time_horizon"] / opt["n_nodes"], 4)
        self.lm, self.reg_e = float(opt["lm_reg"]), float(cost["reg_eps_e"])
        h, I = self.h, torch.eye(18, **self.kw)
        Z = torch.zeros(18, 18, **self.kw)
        self.A = torch.cat([torch.cat([I, h * I], 1), torch.cat([Z, I], 1)], 0)
        self.B = torch.cat([torch.cat([0.5 * h * h * I, h * I], 0), torch.zeros(NX, 12, **self.kw)], 1)
        tw = max(self.w.total_weight, 1.0)
        tl = robot.torque_limit.to(**self.kw)
        full = lambda n, v: torch.full((n,), v, **self.kw)
        self.scales = torch.cat([full(20, 0.25 * tw), tl, full(4, 0.1)])
        self.lam_max = torch.cat([full(20, 0.5 * tw), tl, full(4, 0.2)])
        self.alphas = torch.tensor(opt["ls_alphas_steady"], **self.kw)

    # ---- linearisation ----
    def blocks(self, X, U, p):
        """Q (B,N,36,36), R (B,N,30,30), M (B,N,36,30), qx (B,N,36), ru (B,N,30)."""
        B, N = U.shape[0], U.shape[1]
        nd = {k: t.reshape((B * N,) + t.shape[2:]) for k, t in node_view(p, N).items()}
        Z = torch.cat([X[:, :-1], U], 2).reshape(B * N, NX + NU)
        inc = bool(self.opt["torque_limit_in_qp"])

        def res(z, kw):
            return ocp.stage_residual(self.robot, self.w, z[..., :NX], z[..., NX:], kw, inc)

        G = []
        for s in range(0, B * N, CHUNK_NODES):
            sl = {k: t[s:s + CHUNK_NODES] for k, t in nd.items()}
            z = Z[s:s + CHUNK_NODES]
            J = torch.func.vmap(torch.func.jacfwd(res, argnums=0))(z, sl)
            Ja = torch.cat([J, res(z, sl)[..., None]], dim=2)
            G.append(Ja.transpose(1, 2) @ Ja)
        G = torch.cat(G).reshape(B, N, NX + NU + 1, NX + NU + 1)
        return (G[..., :NX, :NX], G[..., NX:NX + NU, NX:NX + NU], G[..., :NX, NX:NX + NU],
                G[..., :NX, -1], G[..., NX:NX + NU, -1])

    def terminal(self, xN, p):
        def res(x, pk, br, jr, sh):
            return ocp.terminal_residual(self.robot, self.w, x, pk, br, jr, sh)

        args = (xN, p["peak"][:, :, -1], p["base_ref_e"], p["joint_ref"], p["step_height"])
        J = torch.func.vmap(torch.func.jacfwd(res, argnums=0))(*args)
        r = res(*args)
        Jt = J.transpose(1, 2)
        return Jt @ J + self.reg_e * torch.eye(NX, **self.kw), (Jt @ r[..., None])[..., 0]

    # ---- the Gauss-Newton step ----
    def gn_step(self, X, U, p):
        defects = ocp.dynamics_step(X[:, :-1], U, p["dt"]) - X[:, 1:]
        Q, R, M, qx, ru = self.blocks(X, U, p)
        P, pv = self.terminal(X[:, -1], p)
        A, Bm = self.A, self.B
        AT, BT = A.T, Bm.T
        eye = torch.eye(NU, **self.kw)
        Ks, ks = [None] * self.N, [None] * self.N
        for n in reversed(range(self.N)):
            PA, PB = P @ A, P @ Bm
            Qxx = Q[:, n] + AT @ PA
            Quu = R[:, n] + BT @ PB + self.lm * eye
            Qux = M[:, n].transpose(1, 2) + BT @ PA
            Pd = (P @ defects[:, n, :, None])[..., 0] + pv
            qxn = qx[:, n] + Pd @ A
            qu = ru[:, n] + Pd @ Bm
            L, info = torch.linalg.cholesky_ex(Quu)
            L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
            sol = torch.cholesky_solve(torch.cat([Qux, qu[..., None]], 2), L)
            K, kff = -sol[..., :-1], -sol[..., -1]
            P = Qxx + Qux.transpose(1, 2) @ K
            P = 0.5 * (P + P.transpose(1, 2))
            pv = qxn + (Qux.transpose(1, 2) @ kff[..., None])[..., 0]
            Ks[n], ks[n] = K, kff
        dx = p["x0"] - X[:, 0]
        dXs, dUs = [dx], []
        for n in range(self.N):
            du = ks[n] + (Ks[n] @ dx[..., None])[..., 0]
            dx = dx @ A.T + du @ Bm.T + defects[:, n]
            dUs.append(du)
            dXs.append(dx)
        return torch.stack(dXs, 1), torch.stack(dUs, 1), defects

    # ---- merit and duals ----
    def cost_dual(self, X, U, p):
        """(cost (L,), r_eq (L, N, 18), g (L, N, 36)) of L trajectories."""
        nd = node_view(p, self.N)
        x = X[:, :-1]
        r = ocp.stage_residual(self.robot, self.w, x, U, nd, True)
        rT = ocp.terminal_residual(self.robot, self.w, X[:, -1], p["peak"][:, :, -1],
                                   p["base_ref_e"], p["joint_ref"], p["step_height"])
        cost = 0.5 * (r * r).sum((1, 2)) + 0.5 * (rT * rT).sum(1)
        return (cost, ocp.equality_rows(self.robot, self.w, x, U, nd),
                ocp.ineq_values(self.robot, self.w, x, U, nd))

    def ineq_update(self, g, p, lam):
        B, N = g.shape[0], g.shape[1]
        cnt = p["cnt"][:, :, :N].transpose(1, 2)
        mask = torch.cat([torch.repeat_interleave(cnt, 5, dim=2),
                          torch.ones(B, N, 12, **self.kw),
                          p["restrict"][:, None, None] * cnt], dim=2)
        step = torch.clamp_min(g, 0.0) + 0.25 * torch.clamp_max(g, 0.0)
        lam_new = mask * torch.minimum(torch.clamp_min(lam + step, 0.0), self.lam_max)
        return lam_new, (torch.clamp_min(g, 0.0) / self.scales).amax((1, 2))

    def qp_pass(self, X, U, lam, p, rho, alpha_band: float = 0.0):
        """One AL pass of every row -> (the pass's result, and with
        ``alpha_band`` > 0 an alternative result, the band each row's
        alternative needed, the rows that have one; else three None). The line search keeps the largest alpha whose merit
        is within 4e-6 |m_min| of the least. With ``alpha_band`` > 0 a row
        also gets the largest other alpha that the rule would have kept had
        every merit moved by at most alpha_band |m_min|: float32 rounding
        could have taken it."""
        dX, dU, defects = self.gn_step(X, U, dict(p, lam_ineq=lam))
        nA, B = self.alphas.shape[0], X.shape[0]
        a4 = self.alphas[:, None, None, None]
        Xc = (X[None] + a4 * dX[None]).reshape((nA * B,) + X.shape[1:])
        Uc = (U[None] + a4 * dU[None]).reshape((nA * B,) + U.shape[1:])
        pc = {k: t.repeat((nA,) + (1,) * (t.dim() - 1)) for k, t in p.items()}
        cost, r_eq, g = self.cost_dual(Xc, Uc, pc)
        merits = (cost.reshape(nA, B) + rho * (1.0 - self.alphas)[:, None]
                  * defects.abs().sum((1, 2))[None])
        m_min = merits.min(0).values
        thr = m_min + 4e-6 * m_min.abs()
        av = self.alphas[:, None].expand_as(merits)
        ninf = torch.full_like(merits, -float("inf"))
        best = torch.where(merits <= thr, av, ninf).argmax(0)

        def result(idx):
            flat = idx * B + torch.arange(B, device=X.device)
            lam_new, viol = self.ineq_update(g[flat], p, lam)
            return dict(X=Xc[flat], U=Uc[flat], lam=lam_new, r_eq=r_eq[flat],
                        cost=merits.gather(0, idx[None])[0], viol=viol)

        own = result(best)
        if alpha_band <= 0:
            return own, None, None, None
        # the band an alpha needs to be the rule's choice: its merit at most
        # the threshold, every larger alpha's above it
        over = (merits - thr) / m_min.abs()
        larger = (self.alphas[:, None] > self.alphas[None, :])[..., None]   # [a, a']
        need = torch.maximum(over, torch.where(larger, -over[:, None], ninf[:, None]).amax(0))
        need = need.clamp_min(0.0)
        alt_a = torch.where((need <= alpha_band) & (av != self.alphas[best][None]), av, ninf)
        alt = alt_a.argmax(0)
        return own, result(alt), need.gather(0, alt[None])[0], torch.isfinite(alt_a.amax(0))

    def step(self, X, U, lam_eq, lam_ineq, p, rho: float = 1.0e2, reported=None, judge=None):
        """One RTI step from (X, U, lam_eq, lam_ineq) -> dict of X, U,
        lam_eq, lam_ineq, cost (B,), qp_iters (B,), pass_need (B,),
        alpha_need (B,).

        A problem stops its passes at the first whose violation is <= qp_tol.
        With ``reported`` (B,), the pass counts a program reports, a
        reported count is taken wherever stopping there is legitimate within
        ``PASS_BAND``: that pass's violation within (1 + PASS_BAND) qp_tol
        (or the last pass), every earlier one above (1 - PASS_BAND) qp_tol.
        The passes run on while some problem may still legitimately go on.
        ``pass_need`` is the band the reported count needed (0 where it is
        the reference's own). With ``judge`` (B, N, nu), the U a program
        returned, a line-search choice that rounding within ``ALPHA_BAND``
        could turn (``qp_pass``) and that moves U by more than ``ALT_MIN``
        of 1 + max |U| is followed both ways, up to ``MAX_ROWS`` rows a
        problem, and each problem returns the row whose U lies closest to
        judge; ``alpha_need`` is the largest band a choice on its way
        needed."""
        B, dev = X.shape[0], X.device
        tol, kmax = self.opt["qp_tol"], max(1, int(self.opt["max_qp_iter"]))
        band = PASS_BAND if reported is not None else 0.0
        origin = torch.arange(B, device=dev)                   # row -> problem
        p_all = dict(p, lam_eq=lam_eq, lam_ineq=lam_ineq)
        st, hist = dict(X=X, U=U, lam=lam_ineq), []
        a_need = torch.zeros(B, dtype=X.dtype, device=dev)
        for _ in range(kmax):
            pr = {key: t[origin] for key, t in p_all.items()}
            new, alt, alt_need, has = self.qp_pass(st["X"], st["U"], st["lam"], pr, rho,
                                                   ALPHA_BAND if judge is not None else 0.0)
            if alt is not None:
                scale = 1.0 + new["U"].abs().flatten(1).amax(1)
                moved = (alt["U"] - new["U"]).abs().flatten(1).amax(1) / scale > ALT_MIN
                counts = torch.bincount(origin, minlength=B)
                fork = torch.nonzero(has & moved & (counts[origin] < MAX_ROWS))[:, 0]
                if fork.numel():
                    grow = lambda t: torch.cat([t, t[fork]])
                    hist = [{key: grow(t) for key, t in h.items()} for h in hist]
                    a_need = torch.cat([a_need, torch.maximum(a_need[fork], alt_need[fork])])
                    new = {key: torch.cat([t, alt[key][fork]]) for key, t in new.items()}
                    origin = grow(origin)
            st = new
            hist.append(new)
            V = torch.stack([h["viol"] for h in hist], 1) / tol    # (rows, passes)
            if not bool((V > 1.0 - band).all(1).any()):       # none may go on
                break
        K = V.shape[1]
        below = V <= 1.0
        own = torch.where(below.any(1), below.to(torch.int64).argmax(1) + 1,
                          torch.full_like(origin, K))
        use, p_need = own, torch.zeros_like(a_need)
        if reported is not None:
            # the band a count c needed, c = 0 .. K + 1: every earlier pass
            # above qp_tol, pass c at or under it (but the last)
            rows = V.shape[0]
            inf = torch.full((rows, 1), float("inf"), dtype=V.dtype, device=dev)
            early = torch.cat([inf, torch.zeros_like(inf), torch.cummax(1.0 - V, 1).values], 1)
            late = torch.cat([inf, V - 1.0, -inf], 1)
            late[:, kmax:] = -float("inf")
            need = torch.maximum(early, late).clamp_min(0.0)
            rep = reported.to(device=dev, dtype=torch.int64).clamp(0, K + 1)[origin]
            p_need = need.gather(1, rep[:, None])[:, 0]
            use = torch.where((p_need <= band) & (rep <= K), rep, own)
        pick = lambda key: torch.stack([h[key] for h in hist]).gather(
            0, (use - 1).reshape((1, -1) + (1,) * (hist[0][key].dim() - 1))
            .expand((1,) + hist[0][key].shape))[0]
        out = dict(X=pick("X"), U=pick("U"), lam_ineq=pick("lam"),
                   lam_eq=torch.clamp(lam_eq[origin] + pick("r_eq"), -30.0, 30.0),
                   cost=pick("cost"), qp_iters=use, pass_need=p_need, alpha_need=a_need)
        if origin.numel() > B:
            j = judge.to(device=dev, dtype=out["U"].dtype)[origin]
            d = (out["U"] - j).abs().flatten(1).amax(1)
            best = torch.full((B,), float("inf"), dtype=d.dtype, device=dev).scatter_reduce(
                0, origin, d, "amin")
            rows = torch.stack([torch.nonzero((origin == b) & (d == best[b]))[0, 0]
                                for b in range(B)])
            out = {key: t[rows] for key, t in out.items()}
        return out
