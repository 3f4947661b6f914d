"""FK + foot velocities + RNEA and their exact Jacobian with respect to
(x, a) for a flat batch of evaluations: CUDA kernel ``csrc/dynjac.cu`` and
its plain PyTorch twin.

Replaces the JAX package's ``ops/dynjac_kernel.py:dynjac_pallas``
(``_dynjac_kernel``). The foot forces are held fixed: d tau / d f is not
propagated (``solver.linearize.lingram_structured`` gets it by duality).
CPU tensors take ``dynjac_plain``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from ..robots.spec import RobotSpec
from . import _build
from .dyncore import N_OUT, _check, dyncore_plain
from .layout import cached_robot_consts

N_DIR = 54   # Jacobian columns: x 36 (q 18, v 18), a 18


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
