"""The port's fp32 policy step (kernel 8's module, ``ops/policy_pd.py``)
against the JAX package's fp32 TPU kernel, on the CPU, at the widths and
batches kernel 8 is held to on the card (tests/test_torch_cuda_kernels.py):
the shipped 47 -> 512x3 -> 12 policy and seeded policies at hidden widths
256 (the JAX network's default) and 132 (a multiple of 4 but not of 8 or
32), at one row, a partial cluster of 32 rows and one row past the datagen
batch.

The JAX side is ``ops/policy_kernel.make_fused_policy_pd(..., interpret=True)``
in fp32, one tile of B rows, as ``tests/test_policy_kernel.py`` runs it; the
port's side is its factory's CPU path (``policy_pd`` on CPU tensors takes
the plain twin and launches nothing). Tolerance: the JAX package's own
kernel test bounds, fp32 sums over K = 512 in another order, tau scaled by
kp. Also a 3 x 1024 net (kernel 8's wide layout on the card) at B=17, one
interpret-mode call, within the same bounds.

xdist worker time: ~10 s on an 8-CPU Intel Xeon host (ten interpret-mode
calls of the JAX policy kernel, each under a second; the 1024-wide one,
0.39 s). The port's test files summed 648.1 s of worker time before that
case and 433.7 s after (--durations=0, -n 6, one 8-CPU host under other
load: the difference is the load's).
"""
import os
import pickle

import numpy as np
import pytest

import torch

from iterative_learning_nmpc_tpu.ops import policy_kernel as jpk
from iterative_learning_nmpc_tpu_torch.ops import policy_pd as tpp

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
KP, KD = 20.0, 1.5


def _layers(width):
    """Folded numpy layers: the shipped policy at 512, else a seeded Flax
    payload (Dense + BatchNorm with random running statistics)."""
    if width == 512:
        with open(ARTIFACT, "rb") as f:
            return tpp.fold_batchnorm(pickle.load(f)["variables"])
    rng = np.random.default_rng(width)
    dims = (47, width, width, width, 12)
    params, stats = {}, {}
    for i in range(4):
        params[f"Dense_{i}"] = {
            "kernel": rng.normal(0, dims[i] ** -0.5, dims[i:i + 2]).astype(np.float32),
            "bias": rng.normal(0, 0.1, dims[i + 1]).astype(np.float32)}
        if i < 3:
            params[f"BatchNorm_{i}"] = {
                "scale": rng.uniform(0.5, 1.5, width).astype(np.float32),
                "bias": rng.normal(0, 0.1, width).astype(np.float32)}
            stats[f"BatchNorm_{i}"] = {
                "mean": rng.normal(0, 0.1, width).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, width).astype(np.float32)}
    return tpp.fold_batchnorm({"params": params, "batch_stats": stats})


@pytest.mark.parametrize("width", [512, 256, 132])
@pytest.mark.parametrize("B", [1, 33, 257])
def test_fp32_factory_matches_jax_fp32_kernel(B, width):
    layers = _layers(width)
    rng = np.random.default_rng(B)
    x, qj, vj = (rng.normal(size=(B, n)).astype(np.float32) for n in (47, 12, 12))
    a_j, t_j = (np.asarray(o) for o in jpk.make_fused_policy_pd(
        layers, KP, KD, tile_b=B, interpret=True)(x, qj, vj))
    n0 = tpp.policy_pd.launches
    a_t, t_t = tpp.make_fused_policy_pd(layers, KP, KD, device="cpu")(
        *(torch.as_tensor(a) for a in (x, qj, vj)))
    assert tpp.policy_pd.launches == n0
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=2e-4, atol=1e-3)


def test_fp32_factory_matches_jax_fp32_kernel_at_1024():
    """A seeded 47 -> 1024 x3 -> 12 policy, which kernel 8 serves on the card
    in its wide layout (16 rows a cluster, 128-column slices): the port's
    factory against one interpret-mode call of the JAX fp32 kernel."""
    test_fp32_factory_matches_jax_fp32_kernel(17, 1024)
