"""The learned policy's fused serving step: BatchNorm-folded MLP + joint PD
torque for a batch of environments. CUDA kernels ``csrc/policy_pd.cu``
(fp32) and ``csrc/policy_pd_bf16.cu`` (bf16 products on the tensor cores),
each with its plain PyTorch twin, and the factory that picks one.

Replaces the JAX package's ``ops/policy_kernel.py:make_fused_policy_pd``
(``_policy_pd_kernel``, fp32 and ``compute_dtype=jnp.bfloat16``). CPU
tensors take the twins; CUDA tensors launch the kernels or raise.
``layers`` is the list of folded ``(W (d_in, d_out), b (d_out,))`` tensors
from ``fold_batchnorm``; the kernels take exactly four (three hidden
layers), as the TPU kernel. ``kernel_takes`` states which widths kernel 8
takes; ``policy_pd_dense`` serves every other shape on the card, as the
JAX package serves any net outside its Pallas kernel. The factory pads
hidden widths with zeros to the kernels' multiples (``pad_hidden``), so it
takes every width the JAX kernel takes, up to each kernel's limit.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
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


def policy_pd_dense(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], kp: float,
                    kd: float, x: torch.Tensor, qj: torch.Tensor, vj: torch.Tensor):
    """The policy step for the widths kernel 8 does not take (``kernel_takes``
    false): one fp32 ``torch.addmm`` a layer with TF32 off (the package's
    setting; raises if it was turned on), ReLU between them, then the PD
    torque. The counterpart of the JAX package's own route on its serving
    paths (``learning/ondevice.py:164-172``, ``sim/jax_sim.py:153,174``: the
    Flax module under ``vmap``): a plain product that the JAX package
    computes outside any Pallas kernel. ``ServedPolicy`` chooses it by shape
    when it is built; ``calls`` counts its calls. Same contract as
    policy_pd_plain."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("policy_pd_dense: TF32 matmuls are on; the port serves in full "
                           "fp32 (torch.backends.cuda.matmul.allow_tf32 = False)")
    policy_pd_dense.calls += 1
    return policy_pd_plain(layers, kp, kd, x, qj, vj)


policy_pd_dense.calls = 0


# kernel 8's widths: hidden layers at most HIDDEN_MAX (csrc/policy_pd.cu
# PP_HMAX; 32 rows a cluster up to 512, 16 past it), n_out at most N_OUT_MAX
HIDDEN_MAX, N_OUT_MAX = 1024, 64


def _refusal(dims: Sequence[int]) -> Optional[str]:
    """Why kernel 8 does not take a net of widths dims = (n_in, h1, ...,
    n_out), or None: it takes four layers, every layer's width a multiple of
    4, hidden widths <= 1024 and n_out <= 64."""
    if len(dims) != 5:
        return f"the kernel takes 4 layers, got {len(dims) - 1}"
    if any(d % 4 for d in dims[1:]):
        return f"layer widths must be multiples of 4, got {list(dims)}"
    if max(dims[1:4]) > HIDDEN_MAX or dims[4] > N_OUT_MAX:
        return (f"the kernel takes hidden widths <= {HIDDEN_MAX} and n_out <= {N_OUT_MAX}, "
                f"got {list(dims)}")
    return None


def kernel_takes(dims: Sequence[int]) -> bool:
    """Whether kernel 8 serves a net of widths dims = (n_in, h1, ..., n_out):
    the shapes ``policy_pd`` accepts, stated without a card. The block's
    shared memory is not part of the rule: a card that cannot hold it makes
    ``policy_pd`` raise. On an H100 (227 KB a block) it holds every net of
    47 inputs and 12 outputs that the rule accepts, the nets
    ``ServedPolicy`` serves (231,080 B at 3 x 512, 230,312 B at 3 x
    1024)."""
    return _refusal([int(d) for d in dims]) is None


# what policy_pd_launch returns when the widths need more shared memory a
# block than the card allows (csrc/policy_pd.cu PP_ERR_SMEM)
_ERR_SMEM = -1


def kernel_attributes(dims: Sequence[int], device: torch.device) -> dict:
    """Kernel 8 as compiled, for dims = (n_in, h1, h2, h3, n_out) on
    ``device``: registers and local bytes a thread (stack frame and
    spills), static and dynamic shared bytes a block, the clusters the
    card holds at once (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveClusters), and the layout's rows a cluster (32,
    or 16 past 512 hidden units)."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _build.check(_build.library().policy_pd_attributes(*dims, out), "policy_pd_attributes")
    return dict(registers=out[0], local_bytes=out[1], static_smem=out[2], dynamic_smem=out[3],
                max_active_clusters=out[4], rows_per_cluster=out[5])


def policy_pd(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], kp: float,
              kd: float, x: torch.Tensor, qj: torch.Tensor, vj: torch.Tensor):
    """Fused policy inference + PD torque; same contract as policy_pd_plain.
    On a CUDA tensor, one launch of kernel 8 (csrc/policy_pd.cu)."""
    if x.device.type == "cpu":
        return policy_pd_plain(layers, kp, kd, x, qj, vj)
    if x.device.type != "cuda":
        raise ValueError(f"policy_pd: unsupported device {x.device}")
    B, n_in = x.shape
    dims = [n_in] + [int(W.shape[1]) for W, _ in layers]
    why = _refusal(dims)
    if why is not None:
        raise ValueError(f"policy_pd: {why}")
    n_out = dims[-1]
    x, qj, vj = x.contiguous(), qj.contiguous(), vj.contiguous()
    _check("policy_pd", "x", x, (B, n_in))
    _check("policy_pd", "qj", qj, (B, n_out))
    _check("policy_pd", "vj", vj, (B, n_out))
    for i, (W, b) in enumerate(layers):
        _check("policy_pd", f"W{i + 1}", W, (dims[i], dims[i + 1]))
        _check("policy_pd", f"b{i + 1}", b, (dims[i + 1],))
    if any(t.device != x.device for t in (qj, vj, *[a for l in layers for a in l])):
        raise ValueError("policy_pd: every tensor must lie on x's device")
    if any(W.data_ptr() % 16 for W, _ in layers):
        raise ValueError("policy_pd: the weights must be 16-byte aligned")
    act = torch.empty(B, n_out, dtype=torch.float32, device=x.device)
    tau = torch.empty(B, n_out, dtype=torch.float32, device=x.device)
    if B == 0:
        return act, tau
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    err = lib.policy_pd_launch(
        x.data_ptr(), qj.data_ptr(), vj.data_ptr(),
        *[t.data_ptr() for l in layers for t in l],
        act.data_ptr(), tau.data_ptr(), B, *dims, float(kp), float(kd), stream)
    if err == _ERR_SMEM:
        raise ValueError(f"policy_pd: widths {dims} need {lib.policy_pd_smem_bytes(*dims)} B "
                         "of shared memory a block, more than the card allows")
    _build.check(err, "policy_pd_launch")
    policy_pd.launches += 1
    return act, tau


policy_pd.launches = 0


def policy_pd_bf16_plain(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], kp: float,
                         kd: float, x: torch.Tensor, qj: torch.Tensor, vj: torch.Tensor):
    """The bf16 policy step in fp32 arithmetic: layer 1 an fp32 addmm; layers
    2-4 multiply bf16-rounded inputs by bf16-rounded weights,
    ``h.to(bfloat16).float() @ W.to(bfloat16).float() + b``, in fp32 (the
    product of two bf16 values is exact in fp32, so only the order of the
    fp32 sums differs from the kernel). Layer l's width is its bias's: the
    factory's W4 carries zero columns past it. Same contract as
    policy_pd_plain."""
    f32, bf16 = torch.float32, torch.bfloat16
    W1, b1 = layers[0]
    h = torch.relu(torch.addmm(b1.to(f32), x, W1.to(f32)))
    for i, (W, b) in enumerate(layers[1:], start=1):
        W = W.to(bf16).to(f32)[:, :b.shape[0]]
        h = h.to(bf16).to(f32) @ W + b.to(f32)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h, kp * (h - qj) - kd * vj


# kernel 8b's widths: hidden layers multiples of BF16_MULTIPLE, at most
# BF16_HIDDEN_MAX (csrc/policy_pd_bf16.cu PB_HMAX); W4 16 columns wide
BF16_MULTIPLE, BF16_HIDDEN_MAX, BF16_N4 = 16, 1024, 16


def _refusal_bf16(dims: Sequence[int]) -> Optional[str]:
    """Why kernel 8b does not take a net of widths dims = (n_in, h1, h2, h3,
    n_out), or None: four layers, hidden widths multiples of 16 and at most
    1024 (the factory pads any width to 16), n_out <= 16."""
    if len(dims) != 5:
        return f"the kernel takes 4 layers, got {len(dims) - 1}"
    hidden = list(dims[1:4])
    if any(h % BF16_MULTIPLE or not 0 < h <= BF16_HIDDEN_MAX for h in hidden):
        return (f"the kernel takes hidden widths that are multiples of {BF16_MULTIPLE} and at "
                f"most {BF16_HIDDEN_MAX}, got {hidden}")
    if not 0 < dims[4] <= BF16_N4:
        return f"the kernel takes n_out <= {BF16_N4}, got {dims[4]}"
    return None


def bf16_kernel_attributes(B: int, dims: Sequence[int], device: torch.device) -> dict:
    """Kernel 8b as a launch of B rows at dims = (n_in, h1, h2, h3, n_out)
    takes it on ``device``: registers and local bytes a thread, static and
    dynamic shared bytes a block, the clusters the card holds at once
    (cudaFuncGetAttributes, cudaOccupancyMaxActiveClusters), rows a tile,
    clusters launched and ring slots."""
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        _build.check(_build.library().policy_pd_bf16_attributes(int(B), *map(int, dims), out),
                     "policy_pd_bf16_attributes")
    return dict(registers=out[0], local_bytes=out[1], static_smem=out[2], dynamic_smem=out[3],
                max_active_clusters=out[4], rows_per_tile=out[5], clusters=out[6],
                ring_slots=out[7])


def policy_pd_bf16(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], kp: float,
                   kd: float, x: torch.Tensor, qj: torch.Tensor, vj: torch.Tensor):
    """The bf16 policy step on the tensor cores; same contract as
    policy_pd_bf16_plain. ``layers`` as ``bf16_layers`` makes them: W1, every
    bias float32; W2 (h1, h2), W3 (h2, h3) bfloat16 with h1, h2, h3 multiples
    of 16 and at most 1024; W4 (h3, 16) bfloat16, zero past the n_out =
    len(b4) <= 16 columns. On a CUDA tensor, one launch of kernel 8b
    (csrc/policy_pd_bf16.cu)."""
    if x.device.type == "cpu":
        return policy_pd_bf16_plain(layers, kp, kd, x, qj, vj)
    if x.device.type != "cuda":
        raise ValueError(f"policy_pd_bf16: unsupported device {x.device}")
    if len(layers) != 4:
        raise ValueError(f"policy_pd_bf16: the kernel takes 4 layers, got {len(layers)}")
    (W1, b1), (W2, b2), (W3, b3), (W4, b4) = layers
    B, n_in = x.shape
    h1, h2, h3, n_out = (int(W1.shape[1]), int(W2.shape[1]), int(W3.shape[1]),
                         int(b4.shape[0]))
    why = _refusal_bf16((n_in, h1, h2, h3, n_out))
    if why is not None:
        raise ValueError(f"policy_pd_bf16: {why}")
    x, qj, vj = x.contiguous(), qj.contiguous(), vj.contiguous()
    _check("policy_pd_bf16", "x", x, (B, n_in))
    _check("policy_pd_bf16", "qj", qj, (B, n_out))
    _check("policy_pd_bf16", "vj", vj, (B, n_out))
    _check("policy_pd_bf16", "W1", W1, (n_in, h1))
    for i, (W, shape) in enumerate(((W2, (h1, h2)), (W3, (h2, h3)), (W4, (h3, BF16_N4))),
                                   start=2):
        if W.dtype != torch.bfloat16 or not W.is_contiguous() or tuple(W.shape) != shape:
            raise ValueError(f"policy_pd_bf16: W{i} must be contiguous bfloat16 {shape}, "
                             f"got {W.dtype} {tuple(W.shape)}")
    for i, (b, d) in enumerate(((b1, h1), (b2, h2), (b3, h3), (b4, n_out)), start=1):
        _check("policy_pd_bf16", f"b{i}", b, (d,))
    tensors = (qj, vj, W1, b1, W2, b2, W3, b3, W4, b4)
    if any(t.device != x.device for t in tensors):
        raise ValueError("policy_pd_bf16: every tensor must lie on x's device")
    if any(t.data_ptr() % 16 for t in (W1, W2, W3, W4)):
        raise ValueError("policy_pd_bf16: W1-W4 must be 16-byte aligned")
    act = torch.empty(B, n_out, dtype=torch.float32, device=x.device)
    tau = torch.empty(B, n_out, dtype=torch.float32, device=x.device)
    if B == 0:
        return act, tau
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().policy_pd_bf16_launch(
        x.data_ptr(), qj.data_ptr(), vj.data_ptr(), *[t.data_ptr() for l in layers for t in l],
        act.data_ptr(), tau.data_ptr(), B, n_in, h1, h2, h3, BF16_N4, n_out, float(kp),
        float(kd), stream)
    if err == _ERR_SMEM:
        raise ValueError(f"policy_pd_bf16: no row tile of widths {(n_in, h1, h2, h3, n_out)} "
                         "fits the card's shared memory")
    _build.check(err, "policy_pd_bf16_launch")
    policy_pd_bf16.launches += 1
    return act, tau


policy_pd_bf16.launches = 0


def _f32(a, dev) -> torch.Tensor:
    """A numpy array or tensor as a contiguous float32 tensor on dev."""
    return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()


def pad_hidden(layers, multiple: int, device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Folded (W, b) layers as float32 tensors on ``device`` with every
    hidden width padded with zeros to a multiple of ``multiple``: zero
    columns of W_l and entries of b_l, zero rows of W_(l+1). A padded unit
    is relu(0 + 0) = 0 and meets a zero row, so the outputs gain only +0.0
    terms; n_in and n_out stay as they are."""
    dev = resolve_device(device)
    out, pad_in = [], 0
    for i, (W, b) in enumerate(layers):
        W, b = _f32(W, dev), _f32(b, dev)
        pad_out = 0 if i == len(layers) - 1 else -W.shape[1] % multiple
        W = torch.nn.functional.pad(W, (0, pad_out, 0, pad_in)).contiguous()
        out.append((W, torch.nn.functional.pad(b, (0, pad_out)).contiguous()))
        pad_in = pad_out
    return out


def bf16_layers(layers, device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The bf16 kernel's weights from folded fp32 layers: hidden widths
    padded to multiples of 16 (``pad_hidden``), W1 and every bias float32;
    W2-W4 rounded to bfloat16 once (round to nearest even, as the TPU
    kernel's ``w_ref[:].astype(bfloat16)``), W4 padded to 16 zero columns."""
    out = []
    padded = pad_hidden(layers, BF16_MULTIPLE, device)
    for i, (W, b) in enumerate(padded):
        if i > 0:
            W = W.to(torch.bfloat16)
        if i == len(padded) - 1 and W.shape[1] < BF16_N4:
            W = torch.nn.functional.pad(W, (0, BF16_N4 - W.shape[1])).contiguous()
        out.append((W, b))
    return out


def make_fused_policy_pd(layers, kp: float, kd: float, compute_dtype=torch.float32,
                         device=None):
    """The policy step as one function, the counterpart of the JAX factory
    ``make_fused_policy_pd``: ``fn(x (B, n_in), qj, vj (B, n_out)) -> (act,
    tau)``. ``compute_dtype`` float32 serves through ``policy_pd`` (hidden
    widths padded to multiples of 4, at most 1024); bfloat16 through ``policy_pd_bf16``
    (layer 1 in fp32, layers 2-4 with bf16 inputs and fp32 sums; widths
    padded to 16, at most 1024), with its weights rounded here once. On the
    card a net past either kernel's limit raises at the call, naming it. ``layers``: folded
    (W, b) pairs (numpy or tensors); the weights go to ``device`` (the CUDA
    card unless named)."""
    if compute_dtype == torch.float32:
        ls = pad_hidden(layers, 4, device)
        return lambda x, qj, vj: policy_pd(ls, kp, kd, x, qj, vj)
    if compute_dtype == torch.bfloat16:
        ls = bf16_layers(layers, device)
        return lambda x, qj, vj: policy_pd_bf16(ls, kp, kd, x, qj, vj)
    raise ValueError(f"make_fused_policy_pd: compute_dtype must be torch.float32 or "
                     f"torch.bfloat16, got {compute_dtype}")
