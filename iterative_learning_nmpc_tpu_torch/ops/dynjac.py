"""FK + foot velocities + RNEA and their exact Jacobian with respect to
(x, a) for a flat batch of evaluations: CUDA kernel ``csrc/dynjac.cu`` and
its plain PyTorch twin.

Replaces the JAX package's ``ops/dynjac_kernel.py:dynjac_pallas``
(``_dynjac_kernel``). The foot forces are held fixed: d tau / d f is not
propagated (``solver.linearize.lingram_structured`` gets it by duality).
CPU tensors take ``dynjac_plain``; CUDA tensors launch the kernel or raise.
The kernel runs a (direction, leg) pair per lane, 96 lanes an evaluation,
and builds each evaluation's 42 x 54 tile in shared memory; the Jacobian's
structural zeros (``structural_zeros``) are stored as zeros.
"""
from __future__ import annotations

import ctypes

import torch

from ..robots.spec import RobotSpec
from . import _build
from .dyncore import N_OUT, _check, dyncore_plain
from .layout import cached_robot_consts

N_DIR = 54   # Jacobian columns: x 36 (q 18, v 18), a 18


def structural_zeros() -> torch.Tensor:
    """(42, 54) bool: the entries of J that are zero at every state. Those
    no path of the dependency graph reaches: the foot points along v and a,
    the foot velocities along a and along the base position q 0..2, and
    each leg's rows (its foot point and velocity, its joint torques
    6+3l..8+3l) along another leg's joints; and the torques along the base
    position, which a translation leaves as they were (the trunk's moment is
    taken about the base origin; the graph reaches them by terms that
    cancel, exactly so in the plain twin)."""
    Z = torch.zeros(N_OUT, N_DIR, dtype=torch.bool)
    Z[0:12, 18:] = True
    Z[12:42, 0:3] = True
    Z[12:24, 36:] = True
    for leg in range(4):
        rows = [*range(3 * leg, 3 * leg + 3), *range(12 + 3 * leg, 15 + 3 * leg),
                *range(30 + 3 * leg, 33 + 3 * leg)]
        for other in range(4):
            if other != leg:
                cols = [18 * kind + 6 + 3 * other + k for kind in range(3) for k in range(3)]
                Z[torch.tensor(rows)[:, None], torch.tensor(cols)[None, :]] = True
    return Z


def dynjac_plain(spec: RobotSpec, X: torch.Tensor, A: torch.Tensor,
                 Fe: torch.Tensor):
    """X (M, 36), A (M, 18), Fe (M, 12) -> (prim (M, 42), J (M, 42, 54)):
    ``torch.func.jacfwd`` of ``dyncore_plain`` with respect to [x, a]."""
    def one(xa, fe):
        out = dyncore_plain(spec, xa[None, :36], xa[None, 36:], fe[None])[0]
        return out, out

    J, prim = torch.func.vmap(torch.func.jacfwd(one, has_aux=True))(
        torch.cat([X, A], dim=1), Fe)
    return prim, J


def dynjac(spec: RobotSpec, X: torch.Tensor, A: torch.Tensor, Fe: torch.Tensor):
    """Batched dynamics core and its Jacobian; same contract as dynjac_plain."""
    if X.device.type == "cpu":
        return dynjac_plain(spec, X, A, Fe)
    if X.device.type != "cuda":
        raise ValueError(f"dynjac: unsupported device {X.device}")
    M = X.shape[0]
    X, A, Fe = X.contiguous(), A.contiguous(), Fe.contiguous()
    _check("dynjac", "X", X, (M, 36))
    _check("dynjac", "A", A, (M, 18))
    _check("dynjac", "Fe", Fe, (M, 12))
    if A.device != X.device or Fe.device != X.device:
        raise ValueError("dynjac: X, A, Fe must share one device")
    consts = cached_robot_consts(spec, X.device)
    prim = torch.empty(M, N_OUT, dtype=torch.float32, device=X.device)
    J = torch.empty(M, N_OUT, N_DIR, dtype=torch.float32, device=X.device)
    if M == 0:
        return prim, J
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _build.library().dynjac_launch(
        X.data_ptr(), A.data_ptr(), Fe.data_ptr(), consts.data_ptr(),
        prim.data_ptr(), J.data_ptr(), M, stream)
    _build.check(err, "dynjac_launch")
    dynjac.launches += 1
    return prim, J


dynjac.launches = 0


def kernel_attributes() -> dict:
    """{"dynjac_kernel": (registers, local bytes, resident blocks an SM)}
    (cudaFuncGetAttributes, local bytes being the stack frame and spills;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().dynjac_attributes(out), "dynjac_attributes")
    return {"dynjac_kernel": tuple(out)}
