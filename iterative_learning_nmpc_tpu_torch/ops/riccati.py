"""Terminal Gram + Riccati backward sweep + alpha=1 affine rollout: CUDA
kernel ``csrc/riccati.cu`` and its plain PyTorch twin.

Replaces the JAX package's ``ops/riccati_kernel.py:riccati_rollout_lane_major``
(``_riccati_kernel`` with ``rollout=True``). The double-integrator dynamics
A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]] are constant, so every
product with A/B is a block scale-add. CPU tensors take
``riccati_rollout_plain``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from ..ocp.problem import NU, NX, Weights, terminal_residual
from ..robots.spec import RobotSpec
from . import _build
from .layout import robot_consts, terminal_consts


def terminal_gram(spec: RobotSpec, w: Weights, reg_e: float, xN, peak_N,
                  base_ref_e, joint_ref, step_h):
    """(P_N (B,36,36), p_N (B,36)) = (J^T J + reg_e I, J^T r) of the
    terminal residual, J from torch.func.jacfwd (sqp._linearize_terminal)."""
    def res(x, pk, br, jr, sh):
        return terminal_residual(spec, w, x, pk, br, jr, sh)

    args = (xN, peak_N, base_ref_e, joint_ref, step_h)
    J = torch.func.vmap(torch.func.jacfwd(res, argnums=0))(*args)
    r = res(*args)
    eye = torch.eye(NX, dtype=xN.dtype, device=xN.device)
    P_N = J.transpose(1, 2) @ J + reg_e * eye
    p_N = (J.transpose(1, 2) @ r[..., None])[..., 0]
    return P_N, p_N


def _cholesky_nan(A):
    """Cholesky factor that turns a failed factorization into NaNs (as
    jnp.linalg.cholesky does) instead of raising: cholesky_ex + mask."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def riccati_sweep_structured(h: float, Q, R, M, qx, ru, P_N, p_N, defects, lm):
    """Batched counterpart of sqp._riccati_solve_structured:
    Q (B,N,36,36), R (B,N,30,30), M (B,N,36,30), qx (B,N,36), ru (B,N,30),
    defects (B,N,36) -> K (B,N,30,36), kff (B,N,30)."""
    B, N = Q.shape[0], Q.shape[1]
    hh = 0.5 * h * h
    eyeu = torch.eye(NU, dtype=Q.dtype, device=Q.device)
    P, pvec = P_N, p_N
    Ks, ks = [None] * N, [None] * N
    for n in reversed(range(N)):
        Pq, Pv = P[:, :, :18], P[:, :, 18:]
        PA = torch.cat([Pq, h * Pq + Pv], dim=2)
        AtPA = torch.cat([PA[:, :18], h * PA[:, :18] + PA[:, 18:]], dim=1)
        PB_a = hh * Pq + h * Pv
        BtPA_a = hh * PA[:, :18] + h * PA[:, 18:]
        BtPB_aa = hh * PB_a[:, :18] + h * PB_a[:, 18:]
        Qxx = Q[:, n] + AtPA
        Quu = R[:, n] + lm * eyeu
        Quu = torch.cat([
            torch.cat([Quu[:, :18, :18] + BtPB_aa, Quu[:, :18, 18:]], dim=2),
            Quu[:, 18:]], dim=1)
        Qux = M[:, n].transpose(1, 2)
        Qux = torch.cat([Qux[:, :18] + BtPA_a, Qux[:, 18:]], dim=1)
        Pd = (P @ defects[:, n, :, None])[..., 0] + pvec
        qxn = qx[:, n] + torch.cat([Pd[:, :18], h * Pd[:, :18] + Pd[:, 18:]], 1)
        qu = ru[:, n] + torch.cat(
            [hh * Pd[:, :18] + h * Pd[:, 18:],
             torch.zeros(B, NU - 18, dtype=Q.dtype, device=Q.device)], 1)
        L = _cholesky_nan(Quu)
        sol = torch.cholesky_solve(torch.cat([Qux, qu[..., None]], dim=2), L)
        K, kff = -sol[..., :-1], -sol[..., -1]
        P = Qxx + Qux.transpose(1, 2) @ K
        P = 0.5 * (P + P.transpose(1, 2))
        pvec = qxn + (Qux.transpose(1, 2) @ kff[..., None])[..., 0]
        Ks[n], ks[n] = K, kff
    return torch.stack(Ks, 1), torch.stack(ks, 1)


def forward_delta_structured(h: float, K, kff, defects, dx0):
    """Batched counterpart of sqp._forward_delta_structured at alpha=1 ->
    dX (B, N+1, 36), dU (B, N, 30)."""
    hh = 0.5 * h * h
    dx = dx0
    dXs, dUs = [], []
    for n in range(K.shape[1]):
        du = kff[:, n] + (K[:, n] @ dx[..., None])[..., 0]
        du_a = du[:, :18]
        dXs.append(dx)
        dUs.append(du)
        dx = torch.cat([dx[:, :18] + h * dx[:, 18:] + hh * du_a,
                        dx[:, 18:] + h * du_a], 1) + defects[:, n]
    dXs.append(dx)
    return torch.stack(dXs, 1), torch.stack(dUs, 1)


def riccati_rollout_plain(spec: RobotSpec, w: Weights, h: float, lm: float,
                          reg_e: float, Q, R, M, qx, ru, defects, dx0, xN,
                          peak_N, base_ref_e, joint_ref, step_h):
    """Terminal Gram, structured sweep and alpha=1 rollout, node by node."""
    P_N, p_N = terminal_gram(spec, w, reg_e, xN, peak_N, base_ref_e,
                             joint_ref, step_h)
    K, kff = riccati_sweep_structured(h, Q, R, M, qx, ru, P_N, p_N, defects, lm)
    return forward_delta_structured(h, K, kff, defects, dx0)


def riccati_rollout(spec: RobotSpec, w: Weights, h: float, lm: float,
                    reg_e: float, Q, R, M, qx, ru, defects, dx0, xN, peak_N,
                    base_ref_e, joint_ref, step_h):
    """GN blocks (B, N, ...) + defects (B, N, 36) + dx0 (B, 36) + the terminal
    inputs xN (B, 36), peak_N (B, 4), base_ref_e (B, 12), joint_ref (B, 12),
    step_h (B,) -> the alpha=1 step dX (B, N+1, 36), dU (B, N, 30)."""
    if Q.device.type == "cpu":
        return riccati_rollout_plain(spec, w, h, lm, reg_e, Q, R, M, qx, ru,
                                     defects, dx0, xN, peak_N, base_ref_e,
                                     joint_ref, step_h)
    if Q.device.type != "cuda":
        raise ValueError(f"riccati_rollout: unsupported device {Q.device}")
    B, N = Q.shape[0], Q.shape[1]
    dev = Q.device
    shapes = dict(Q=(B, N, NX, NX), R=(B, N, NU, NU), M=(B, N, NX, NU),
                  qx=(B, N, NX), ru=(B, N, NU), defects=(B, N, NX),
                  dx0=(B, NX), xN=(B, NX), peak_N=(B, 4), step_h=(B,))
    ts = dict(Q=Q, R=R, M=M, qx=qx, ru=ru, defects=defects, dx0=dx0, xN=xN,
              peak_N=peak_N, step_h=step_h)
    for k, shape in shapes.items():
        t = ts[k]
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"riccati_rollout: {k} must be float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} {t.device}")
        ts[k] = t.contiguous()
    zero = torch.zeros(B, 12, dtype=torch.float32, device=dev)
    xref_e = torch.cat([base_ref_e[:, :6], joint_ref, base_ref_e[:, 6:], zero],
                       1).to(torch.float32).contiguous()
    spec = spec.to(dev)
    consts, tw = robot_consts(spec), terminal_consts(w.to(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    gains = torch.empty(B, N, NU, NX + 1, **f32)      # [K | kff] scratch
    dX = torch.empty(B, N + 1, NX, **f32)
    dU = torch.empty(B, N, NU, **f32)
    if B == 0:
        return dX, dU
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().riccati_rollout_launch(
        ts["Q"].data_ptr(), ts["R"].data_ptr(), ts["M"].data_ptr(),
        ts["qx"].data_ptr(), ts["ru"].data_ptr(), ts["defects"].data_ptr(),
        ts["dx0"].data_ptr(), ts["xN"].data_ptr(), xref_e.data_ptr(),
        ts["peak_N"].data_ptr(), ts["step_h"].data_ptr(), consts.data_ptr(),
        tw.data_ptr(), gains.data_ptr(), dX.data_ptr(), dU.data_ptr(),
        B, N, float(h), float(lm), float(reg_e), stream)
    _build.check(err, "riccati_rollout_launch")
    riccati_rollout.launches += 1
    return dX, dU


riccati_rollout.launches = 0
