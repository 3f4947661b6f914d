"""Value-only FK + RNEA for a flat batch of evaluations: CUDA kernel
``csrc/dyncore.cu`` and its plain PyTorch twin.

Replaces the JAX package's ``ops/dynjac_kernel.py:dyncore_pallas``
(``_dyncore_kernel``). CPU tensors take ``dyncore_plain``; CUDA tensors
launch the kernel or raise. The kernel runs a leg per lane, four lanes an
evaluation; its rows pass through shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from ..models import dynamics as dyn
from ..robots.spec import RobotSpec
from . import _build
from .layout import cached_robot_consts

N_OUT = 42   # p_feet 12 | v_feet 12 | tau 18


def dyncore_plain(spec: RobotSpec, X: torch.Tensor, A: torch.Tensor,
                  Fe: torch.Tensor) -> torch.Tensor:
    """X (M, 36), A (M, 18), Fe (M, 12) -> (M, 42) = [p_feet, v_feet, tau]."""
    M = X.shape[0]
    q, v = X[:, :18], X[:, 18:]
    pf = dyn.foot_positions(spec, q)
    vf = dyn.foot_velocities(spec, q, v)
    tau = dyn.rnea(spec, q, v, A, f_ext_feet=Fe.reshape(M, 4, 3))
    return torch.cat([pf.reshape(M, 12), vf.reshape(M, 12), tau], dim=1)


def _check(op, name, t, shape):
    if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"{op}: {name} must be contiguous float32 {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def dyncore(spec: RobotSpec, X: torch.Tensor, A: torch.Tensor,
            Fe: torch.Tensor) -> torch.Tensor:
    """Batched value-only dynamics core; same contract as dyncore_plain."""
    if X.device.type == "cpu":
        return dyncore_plain(spec, X, A, Fe)
    if X.device.type != "cuda":
        raise ValueError(f"dyncore: unsupported device {X.device}")
    M = X.shape[0]
    X, A, Fe = X.contiguous(), A.contiguous(), Fe.contiguous()
    _check("dyncore", "X", X, (M, 36))
    _check("dyncore", "A", A, (M, 18))
    _check("dyncore", "Fe", Fe, (M, 12))
    if A.device != X.device or Fe.device != X.device:
        raise ValueError("dyncore: X, A, Fe must share one device")
    consts = cached_robot_consts(spec, X.device)
    out = torch.empty(M, N_OUT, dtype=torch.float32, device=X.device)
    if M == 0:
        return out
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _build.library().dyncore_launch(
        X.data_ptr(), A.data_ptr(), Fe.data_ptr(), consts.data_ptr(),
        out.data_ptr(), M, stream)
    _build.check(err, "dyncore_launch")
    dyncore.launches += 1
    return out


dyncore.launches = 0


def kernel_attributes() -> dict:
    """{"dyncore_kernel": (registers, local bytes, resident blocks an SM)}
    (cudaFuncGetAttributes, local bytes being the stack frame and spills;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().dyncore_attributes(out), "dyncore_attributes")
    return {"dyncore_kernel": tuple(out)}
