"""The learned policy's fused serving step: BatchNorm-folded MLP + joint PD
torque for a batch of environments. CUDA kernel ``csrc/policy_pd.cu`` and
its plain PyTorch twin.

Replaces the JAX package's ``ops/policy_kernel.py:make_fused_policy_pd``
(``_policy_pd_kernel``, fp32). CPU tensors take ``policy_pd_plain``; CUDA
tensors launch the kernel or raise. ``layers`` is the list of folded
``(W (d_in, d_out), b (d_out,))`` float32 tensors from ``fold_batchnorm``;
the kernel takes exactly four (three hidden layers), as the TPU kernel.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .dyncore import _check


def fold_batchnorm(variables, eps: float = 1e-5) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Fold inference-mode BatchNorm into the preceding Dense layers of a
    Flax-layout variables dict (``params`` Dense_i / BatchNorm_i,
    ``batch_stats`` BatchNorm_i): [(W, b), ...] float32 with
    y = x @ W + b per layer. eps is Flax's BatchNorm default."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    layers = []
    i = 0
    while f"Dense_{i}" in params:
        W = np.asarray(params[f"Dense_{i}"]["kernel"], np.float32)
        b = np.asarray(params[f"Dense_{i}"]["bias"], np.float32)
        bn_p = params.get(f"BatchNorm_{i}")
        bn_s = stats.get(f"BatchNorm_{i}") if stats else None
        if bn_p is not None and bn_s is not None:
            mean = np.asarray(bn_s["mean"], np.float32)
            var = np.asarray(bn_s["var"], np.float32)
            scale = np.asarray(bn_p["scale"], np.float32)
            bias = np.asarray(bn_p["bias"], np.float32)
            inv = scale / np.sqrt(var + eps)
            W = W * inv[None, :]
            b = (b - mean) * inv + bias
        layers.append((W, b))
        i += 1
    return layers


def policy_pd_plain(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], kp: float,
                    kd: float, x: torch.Tensor, qj: torch.Tensor, vj: torch.Tensor):
    """x (B, n_in), qj, vj (B, n_out) -> (act, tau) (B, n_out): one addmm
    per layer, ReLU between them, then tau = kp (act - qj) - kd vj."""
    h = x
    for i, (W, b) in enumerate(layers):
        h = torch.addmm(b, h, W)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h, kp * (h - qj) - kd * vj


def policy_pd(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], kp: float,
              kd: float, x: torch.Tensor, qj: torch.Tensor, vj: torch.Tensor):
    """Fused policy inference + PD torque; same contract as policy_pd_plain."""
    if x.device.type == "cpu":
        return policy_pd_plain(layers, kp, kd, x, qj, vj)
    if x.device.type != "cuda":
        raise ValueError(f"policy_pd: unsupported device {x.device}")
    if len(layers) != 4:
        raise ValueError(f"policy_pd: the kernel takes 4 layers, got {len(layers)}")
    B, n_in = x.shape
    dims = [n_in] + [int(W.shape[1]) for W, _ in layers]
    n_out = dims[-1]
    x, qj, vj = x.contiguous(), qj.contiguous(), vj.contiguous()
    _check("policy_pd", "x", x, (B, n_in))
    _check("policy_pd", "qj", qj, (B, n_out))
    _check("policy_pd", "vj", vj, (B, n_out))
    for i, (W, b) in enumerate(layers):
        _check("policy_pd", f"W{i + 1}", W, (dims[i], dims[i + 1]))
        _check("policy_pd", f"b{i + 1}", b, (dims[i + 1],))
        if dims[i + 1] % 4:
            raise ValueError(f"policy_pd: layer widths must be multiples of 4, got {dims}")
    if any(t.device != x.device for t in (qj, vj, *[a for l in layers for a in l])):
        raise ValueError("policy_pd: every tensor must lie on x's device")
    if any(W.data_ptr() % 16 for W, _ in layers):
        raise ValueError("policy_pd: the weights must be 16-byte aligned")
    act = torch.empty(B, n_out, dtype=torch.float32, device=x.device)
    tau = torch.empty(B, n_out, dtype=torch.float32, device=x.device)
    if B == 0:
        return act, tau
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().policy_pd_launch(
        x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
        *[t.data_ptr() for l in layers for t in l],
        act.data_ptr(), tau.data_ptr(), B, *dims[:4], n_out,
        float(kp), float(kd), stream)
    _build.check(err, "policy_pd_launch")
    policy_pd.launches += 1
    return act, tau


policy_pd.launches = 0
