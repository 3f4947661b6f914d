"""The structured Riccati solve of the batched GN step: the CUDA kernels of
``csrc/riccati.cu`` and their plain PyTorch twins.

Four dispatchers, each replacing a kernel of the JAX package's
``ops/riccati_kernel.py``:

- ``riccati_rollout``: terminal Gram + backward sweep + alpha=1 rollout
  (``riccati_rollout_lane_major``, ``_riccati_kernel`` with rollout=True),
- ``riccati_sweep_terminal``: terminal Gram + sweep -> gains
  (``riccati_pallas_lane_major`` with ``terminal=`` and ``raw_out=True``),
- ``riccati_sweep``: the sweep from a given (P_N, p_N) -> gains
  (``riccati_pallas_batched``, the batched rule of ``make_riccati_pallas``),
- ``forward_rollout``: the alpha=1 rollout over gains
  (``forward_rollout_lane_major``, ``_forward_kernel``).

The gains are one (B, N, 30, 37) tensor ``[K | kff]``, the port's
counterpart of the TPU kernels' lane-major (K, kff) pair and the one
interface between the sweeps and the rollout. The double-integrator
dynamics A = [[I, hI], [0, I]], B = [[h^2/2 I_a], [h I_a]] are constant, so
every product with A/B is a block scale-add. CPU tensors take the
``*_plain`` twins; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from ..ocp.problem import NU, NX, Weights, terminal_residual
from ..robots.spec import RobotSpec
from . import _build
from .layout import cached_robot_consts, terminal_consts

# Horizons up to this many nodes take the fused riccati_rollout, longer
# ones riccati_sweep_terminal -> forward_rollout. The JAX package's route
# rule (ops/riccati_kernel.py:61-82, fused_rollout_max_n), kept so that
# both packages run the same kernels at every N; it is a VMEM budget on
# the TPU and no memory limit here.
FUSED_ROLLOUT_MAX_N = 88


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


def riccati_sweep_plain(h: float, lm: float, Q, R, M, qx, ru, P_N, p_N, defects):
    """riccati_sweep_structured with the gains packed as [K | kff]."""
    K, kff = riccati_sweep_structured(h, Q, R, M, qx, ru, P_N, p_N, defects, lm)
    return torch.cat([K, kff[..., None]], dim=-1)


def riccati_sweep_terminal_plain(spec: RobotSpec, w: Weights, h: float, lm: float,
                                 reg_e: float, Q, R, M, qx, ru, defects, xN, peak_N,
                                 base_ref_e, joint_ref, step_h):
    """Terminal Gram, then riccati_sweep_plain."""
    P_N, p_N = terminal_gram(spec, w, reg_e, xN, peak_N, base_ref_e, joint_ref,
                             step_h)
    return riccati_sweep_plain(h, lm, Q, R, M, qx, ru, P_N, p_N, defects)


def forward_rollout_plain(h: float, gains, defects, dx0):
    """forward_delta_structured over packed gains [K | kff]."""
    return forward_delta_structured(h, gains[..., :NX], gains[..., NX], defects, dx0)


def _takes_twin(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain twin runs), False for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _checked(name: str, dev, shapes: dict, tensors: dict) -> dict:
    """The tensors, contiguous and 16-byte aligned (the sweeps copy the GN
    blocks by 16-byte cp.async; a view that starts inside its storage is
    copied), after checking each is float32 of its shape on ``dev``."""
    out = {}
    for k, shape in shapes.items():
        t = tensors[k]
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: {k} must be float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} {t.device}")
        t = t.contiguous()
        out[k] = t if t.data_ptr() % 16 == 0 else t.clone()
    return out


def _block_shapes(B: int, N: int) -> dict:
    return dict(Q=(B, N, NX, NX), R=(B, N, NU, NU), M=(B, N, NX, NU),
                qx=(B, N, NX), ru=(B, N, NU), defects=(B, N, NX))


def _terminal_buffers(spec: RobotSpec, w: Weights, base_ref_e, joint_ref, dev):
    """(x-ordered terminal reference (B, 36), robot constants, terminal
    weights) as the kernels read them."""
    B = base_ref_e.shape[0]
    zero = torch.zeros(B, 12, dtype=torch.float32, device=dev)
    xref_e = torch.cat([base_ref_e[:, :6], joint_ref, base_ref_e[:, 6:], zero],
                       1).to(torch.float32).contiguous()
    return xref_e, cached_robot_consts(spec, dev), terminal_consts(w.to(dev))


def riccati_rollout(spec: RobotSpec, w: Weights, h: float, lm: float,
                    reg_e: float, Q, R, M, qx, ru, defects, dx0, xN, peak_N,
                    base_ref_e, joint_ref, step_h):
    """GN blocks (B, N, ...) + defects (B, N, 36) + dx0 (B, 36) + the terminal
    inputs xN (B, 36), peak_N (B, 4), base_ref_e (B, 12), joint_ref (B, 12),
    step_h (B,) -> the alpha=1 step dX (B, N+1, 36), dU (B, N, 30)."""
    if _takes_twin("riccati_rollout", Q):
        return riccati_rollout_plain(spec, w, h, lm, reg_e, Q, R, M, qx, ru,
                                     defects, dx0, xN, peak_N, base_ref_e,
                                     joint_ref, step_h)
    B, N = Q.shape[0], Q.shape[1]
    dev = Q.device
    ts = _checked("riccati_rollout", dev,
                  dict(_block_shapes(B, N), dx0=(B, NX), xN=(B, NX),
                       peak_N=(B, 4), step_h=(B,)),
                  dict(Q=Q, R=R, M=M, qx=qx, ru=ru, defects=defects, dx0=dx0,
                       xN=xN, peak_N=peak_N, step_h=step_h))
    xref_e, consts, tw = _terminal_buffers(spec, w, base_ref_e, joint_ref, dev)
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


def riccati_sweep_terminal(spec: RobotSpec, w: Weights, h: float, lm: float,
                           reg_e: float, Q, R, M, qx, ru, defects, xN, peak_N,
                           base_ref_e, joint_ref, step_h):
    """GN blocks (B, N, ...) + defects (B, N, 36) + the terminal inputs of
    riccati_rollout -> gains [K | kff] (B, N, 30, 37)."""
    if _takes_twin("riccati_sweep_terminal", Q):
        return riccati_sweep_terminal_plain(spec, w, h, lm, reg_e, Q, R, M, qx,
                                            ru, defects, xN, peak_N, base_ref_e,
                                            joint_ref, step_h)
    B, N = Q.shape[0], Q.shape[1]
    dev = Q.device
    ts = _checked("riccati_sweep_terminal", dev,
                  dict(_block_shapes(B, N), xN=(B, NX), peak_N=(B, 4), step_h=(B,)),
                  dict(Q=Q, R=R, M=M, qx=qx, ru=ru, defects=defects, xN=xN,
                       peak_N=peak_N, step_h=step_h))
    xref_e, consts, tw = _terminal_buffers(spec, w, base_ref_e, joint_ref, dev)
    gains = torch.empty(B, N, NU, NX + 1, dtype=torch.float32, device=dev)
    if B == 0:
        return gains
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().riccati_sweep_terminal_launch(
        ts["Q"].data_ptr(), ts["R"].data_ptr(), ts["M"].data_ptr(),
        ts["qx"].data_ptr(), ts["ru"].data_ptr(), ts["defects"].data_ptr(),
        ts["xN"].data_ptr(), xref_e.data_ptr(), ts["peak_N"].data_ptr(),
        ts["step_h"].data_ptr(), consts.data_ptr(), tw.data_ptr(),
        gains.data_ptr(), B, N, float(h), float(lm), float(reg_e), stream)
    _build.check(err, "riccati_sweep_terminal_launch")
    riccati_sweep_terminal.launches += 1
    return gains


riccati_sweep_terminal.launches = 0


def riccati_sweep(h: float, lm: float, Q, R, M, qx, ru, P_N, p_N, defects):
    """GN blocks (B, N, ...) + P_N (B, 36, 36), p_N (B, 36) + defects
    (B, N, 36) -> gains [K | kff] (B, N, 30, 37)."""
    if _takes_twin("riccati_sweep", Q):
        return riccati_sweep_plain(h, lm, Q, R, M, qx, ru, P_N, p_N, defects)
    B, N = Q.shape[0], Q.shape[1]
    dev = Q.device
    ts = _checked("riccati_sweep", dev,
                  dict(_block_shapes(B, N), P_N=(B, NX, NX), p_N=(B, NX)),
                  dict(Q=Q, R=R, M=M, qx=qx, ru=ru, defects=defects, P_N=P_N,
                       p_N=p_N))
    gains = torch.empty(B, N, NU, NX + 1, dtype=torch.float32, device=dev)
    if B == 0:
        return gains
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().riccati_sweep_launch(
        ts["Q"].data_ptr(), ts["R"].data_ptr(), ts["M"].data_ptr(),
        ts["qx"].data_ptr(), ts["ru"].data_ptr(), ts["P_N"].data_ptr(),
        ts["p_N"].data_ptr(), ts["defects"].data_ptr(), gains.data_ptr(),
        B, N, float(h), float(lm), stream)
    _build.check(err, "riccati_sweep_launch")
    riccati_sweep.launches += 1
    return gains


riccati_sweep.launches = 0


def forward_rollout(h: float, gains, defects, dx0):
    """gains [K | kff] (B, N, 30, 37) + defects (B, N, 36) + dx0 (B, 36) ->
    the alpha=1 step dX (B, N+1, 36), dU (B, N, 30). On the card one warp
    a problem, each node's gains and defects streamed ahead by bulk copies
    of 16-byte aligned spans (the tensors are made contiguous and 16-byte
    aligned here)."""
    if _takes_twin("forward_rollout", gains):
        return forward_rollout_plain(h, gains, defects, dx0)
    B, N = gains.shape[0], gains.shape[1]
    dev = gains.device
    ts = _checked("forward_rollout", dev,
                  dict(gains=(B, N, NU, NX + 1), defects=(B, N, NX), dx0=(B, NX)),
                  dict(gains=gains, defects=defects, dx0=dx0))
    f32 = dict(dtype=torch.float32, device=dev)
    dX = torch.empty(B, N + 1, NX, **f32)
    dU = torch.empty(B, N, NU, **f32)
    if B == 0:
        return dX, dU
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().forward_rollout_launch(
        ts["gains"].data_ptr(), ts["defects"].data_ptr(), ts["dx0"].data_ptr(),
        dX.data_ptr(), dU.data_ptr(), B, N, float(h), stream)
    _build.check(err, "forward_rollout_launch")
    forward_rollout.launches += 1
    return dX, dU


forward_rollout.launches = 0


def kernel_attributes() -> dict:
    """{kernel: (registers, local bytes, resident blocks an SM)} of the four
    compiled kernels at their launch shapes (cudaFuncGetAttributes, local
    bytes being the stack frame and spills;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; forward_rollout's block
    is one warp, one problem)."""
    out = (ctypes.c_int * 12)()
    _build.check(_build.library().riccati_attributes(out), "riccati_attributes")
    names = ("riccati_rollout", "riccati_sweep_terminal", "riccati_sweep", "forward_rollout")
    return {k: tuple(out[3 * i:3 * i + 3]) for i, k in enumerate(names)}
