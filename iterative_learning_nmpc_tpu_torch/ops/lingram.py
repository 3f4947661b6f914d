"""Linearize + Gauss-Newton Gram blocks of every (problem, node): CUDA
kernel ``csrc/lingram.cu`` and its plain PyTorch twin.

Replaces the JAX package's ``ops/dynjac_kernel.py:lingram_lane_major``
(``_lingram_kernel``). Outputs are batch-major, as ``lingram_structured``
returns them: Q (B,N,36,36), R (B,N,30,30), M (B,N,36,30), qx (B,N,36),
ru (B,N,30). CPU tensors take ``lingram_plain``; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from ..ocp.problem import NU, NX, OCPParams, Weights
from ..robots.spec import RobotSpec
from ..solver.linearize import gn_blocks_jacfwd
from . import _build
from .layout import node_params, robot_consts, weight_consts


def lingram_plain(spec: RobotSpec, w: Weights, X: torch.Tensor, U: torch.Tensor,
                  p: OCPParams, include_torque: bool = True):
    """The torch.func.jacfwd Gram (solver.linearize.gn_blocks_jacfwd)."""
    return gn_blocks_jacfwd(spec, w, X, U, p, include_torque=include_torque)


def lingram(spec: RobotSpec, w: Weights, X: torch.Tensor, U: torch.Tensor,
            p: OCPParams, include_torque: bool = True):
    """X (B, N+1, 36), U (B, N, 30), batched OCPParams -> (Q, R, M, qx, ru)."""
    if X.device.type == "cpu":
        return lingram_plain(spec, w, X, U, p, include_torque)
    if X.device.type != "cuda":
        raise ValueError(f"lingram: unsupported device {X.device}")
    B, N = U.shape[0], U.shape[1]
    if (X.dtype != torch.float32 or U.dtype != torch.float32
            or tuple(X.shape) != (B, N + 1, NX) or tuple(U.shape) != (B, N, NU)):
        raise ValueError(f"lingram: X (B, N+1, 36) and U (B, N, 30) float32 "
                         f"expected, got {tuple(X.shape)} {tuple(U.shape)}")
    dev = X.device
    Xn = X[:, :-1].reshape(B * N, NX).contiguous()
    Un = U.reshape(B * N, NU).contiguous()
    par = node_params(p, N)
    spec = spec.to(dev)
    consts, wts = robot_consts(spec), weight_consts(spec, w.to(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    Q = torch.empty(B, N, NX, NX, **f32)
    R = torch.empty(B, N, NU, NU, **f32)
    M = torch.empty(B, N, NX, NU, **f32)
    qx = torch.empty(B, N, NX, **f32)
    ru = torch.empty(B, N, NU, **f32)
    if B * N == 0:
        return Q, R, M, qx, ru
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().lingram_launch(
        Xn.data_ptr(), Un.data_ptr(), par.data_ptr(), consts.data_ptr(),
        wts.data_ptr(), Q.data_ptr(), R.data_ptr(), M.data_ptr(),
        qx.data_ptr(), ru.data_ptr(), B * N, int(bool(include_torque)), stream)
    _build.check(err, "lingram_launch")
    lingram.launches += 1
    return Q, R, M, qx, ru


lingram.launches = 0
