"""Associative-scan (parallel-in-time) Riccati sweep:
``riccati_mode="associative"``.

Counterpart of ``iterative_learning_nmpc_tpu/solver/parallel_riccati.py``.
The LQR value recursion composes affine-quadratic conditional value
functions, an associative operation (Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Dynamic Programming"), so the backward sweep becomes a
suffix scan of logarithmic depth over the nodes, and the gains come out
of one factorization batched over (problem, node).

An element of the segment i -> j is (A, b, C, eta, J) with

  V(x_i, x_j) = 1/2 (x_j - A x_i - b)^T C^+ (x_j - A x_i - b)
                + 1/2 x_i^T J x_i - eta^T x_i   (+ const),

composed without C^{-1} (``_compose``), after the cross terms are
eliminated by u = w - R^{-1} M^T x. In float64 it agrees with the
sequential sweep to rounding; in fp32 the composed (I + C J)^{-1} solves
lose digits at the OCP's conditioning (the JAX package's envelope: 2e-2 of
the gains' scale at N = 25 on its random blocks).

PyTorch has no ``lax.associative_scan``: ``suffix_scan`` runs its tree,
each level one ``_compose`` batched over (problem, pair).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.riccati import _cholesky_nan


def _compose(e1, e2):
    """Compose element e1 (the earlier segment) with e2 (the later one);
    every part carries the same leading batch dims."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    I = torch.eye(nx, dtype=A1.dtype, device=A1.device).expand(A1.shape)
    mv = lambda M, x: (M @ x[..., None])[..., 0]
    # D = (I + C1 J2)^{-1}
    A2D = A2 @ torch.linalg.solve(I + C1 @ J2, I)
    A12 = A2D @ A1
    b12 = mv(A2D, b1 + mv(C1, eta2)) + b2
    C12 = A2D @ C1 @ A2.transpose(-1, -2) + C2
    # (I + J2 C1)^{-1}
    S = torch.linalg.solve(I + J2 @ C1, torch.cat(
        [(eta2 - mv(J2, b1))[..., None], J2 @ A1], dim=-1))
    A1T = A1.transpose(-1, -2)
    eta12 = mv(A1T, S[..., 0]) + eta1
    J12 = A1T @ S[..., 1:] + J1
    J12 = 0.5 * (J12 + J12.transpose(-1, -2))
    return A12, b12, C12, eta12, J12


def _scan(el, axis: int, fn):
    """Inclusive forward scan of ``lax.associative_scan``'s tree: combine
    adjacent pairs, scan the pairs recursively, then combine each even
    element with the prefix before it."""
    n = el[0].shape[axis]
    if n < 2:
        return el
    take = lambda t, s: t[(slice(None),) * axis + (s,)]
    odd = _scan(list(fn([take(e, slice(0, n - 1, 2)) for e in el],
                        [take(e, slice(1, None, 2)) for e in el])), axis, fn)
    prev = odd if n % 2 else [take(o, slice(0, -1)) for o in odd]
    even = fn(prev, [take(e, slice(2, None, 2)) for e in el])
    out = []
    for e, ev, od in zip(el, even, odd):
        z = torch.empty_like(e)
        z[(slice(None),) * axis + (slice(0, 1),)] = take(e, slice(0, 1))
        z[(slice(None),) * axis + (slice(2, None, 2),)] = ev
        z[(slice(None),) * axis + (slice(1, None, 2),)] = od
        out.append(z)
    return out


def suffix_scan(elems, axis: int = 1):
    """Inclusive reverse scan along ``axis``: out[k] = e_k * e_{k+1} * ...
    * e_last, with ``_compose(earlier, later)`` as the product (not
    commutative). The tree is ``lax.associative_scan``'s with
    ``reverse=True``, as the JAX package runs it: the elements reversed,
    each pair combined as (later suffix, earlier element) -> compose
    (earlier, later), 2 ceil(log2 n) - 1 levels, each one ``_compose``
    batched over (problem, pair). (A Hillis-Steele scan has ceil(log2 n)
    levels but composes other segments: in fp32 its kff moved 2-6x further
    from the float64 sweep than this tree's at the trot's blocks.)"""
    rev = [t.flip(axis) for t in elems]
    out = _scan(rev, axis, lambda a, b: _compose(b, a))
    return tuple(t.flip(axis) for t in out)


def parallel_riccati(A, B, Q, R, M, qx, ru, P_N, p_N, defects, lm
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep of sqp.riccati_solve by suffix_scan: constant A (nx, nx),
    B (nx, nu); Q (b, N, nx, nx), R (b, N, nu, nu), M (b, N, nx, nu),
    qx (b, N, nx), ru (b, N, nu), P_N (b, nx, nx), p_N (b, nx),
    defects (b, N, nx) -> K (b, N, nu, nx), kff (b, N, nu)."""
    if A.dim() != 2 or B.dim() != 2:
        raise ValueError("parallel_riccati takes constant 2-D A/B only")
    b, N, nx = Q.shape[0], Q.shape[1], Q.shape[-1]
    nu = R.shape[-1]
    dtype, dev = Q.dtype, Q.device
    R_reg = R + lm * torch.eye(nu, dtype=dtype, device=dev)
    Mt = M.transpose(-1, -2)
    # eliminate the cross terms: u = w - R^{-1} M^T x
    RinvMt = torch.linalg.solve(R_reg, Mt)                         # (b, N, nu, nx)
    Rinvr = torch.linalg.solve(R_reg, ru[..., None])[..., 0]       # (b, N, nu)
    A_t = A - torch.einsum("ij,bnjk->bnik", B, RinvMt)            # (b, N, nx, nx)
    Q_t = Q - M @ RinvMt
    Q_t = 0.5 * (Q_t + Q_t.transpose(-1, -2))
    q_t = qx - torch.einsum("bnij,bnj->bni", M, Rinvr)

    # per-node elements: C_k = B R_k^{-1} B^T
    RinvBt = torch.linalg.solve(R_reg, B.T.expand(b, N, nu, nx))
    C_el = torch.einsum("ij,bnjk->bnik", B, RinvBt)
    b_el = defects - torch.einsum("ij,bnj->bni", B, Rinvr)
    zm = torch.zeros(b, 1, nx, nx, dtype=dtype, device=dev)
    zv = torch.zeros(b, 1, nx, dtype=dtype, device=dev)
    elems = (torch.cat([A_t, zm], 1), torch.cat([b_el, zv], 1), torch.cat([C_el, zm], 1),
             torch.cat([-q_t, -p_N[:, None]], 1), torch.cat([Q_t, P_N[:, None]], 1))
    _, _, _, eta_all, J_all = suffix_scan(elems, axis=1)
    # the value at node k+1 is the suffix that starts at k+1
    P_next = J_all[:, 1:]
    p_next = -eta_all[:, 1:]

    # the gains: one factorization batched over (problem, node)
    BtP = torch.einsum("ji,bnjk->bnik", B, P_next)                 # (b, N, nu, nx)
    Quu = R_reg + BtP @ B
    Qux = BtP @ A_t
    # with the tilde substitution the linear cost of w is unchanged (= r)
    qu = (ru + torch.einsum("bnij,bnj->bni", BtP, defects)
          + torch.einsum("ji,bnj->bni", B, p_next))
    sol = torch.cholesky_solve(torch.cat([Qux, qu[..., None]], dim=-1), _cholesky_nan(Quu))
    K_w, kff = -sol[..., :nx], -sol[..., nx]
    return K_w - RinvMt, kff
