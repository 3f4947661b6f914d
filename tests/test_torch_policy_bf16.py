"""The port's bf16 policy step (kernel 8b's module, ``ops/policy_pd.py``)
against the JAX package, on the CPU.

The JAX side is ``ops/policy_kernel.make_fused_policy_pd(...,
compute_dtype=jnp.bfloat16, interpret=True)``, the TPU kernel in interpret
mode as ``tests/test_policy_kernel.py`` runs it (about half a second on a CPU),
on the shipped policy's folded weights
(``assets/policy_go2_trot_ondevice_dagger.pkl``) and numpy-seeded inputs at
B=64 and full width (47 -> 512x3 -> 12). The port's side is the factory's
CPU path, ``policy_pd_bf16_plain``: layer 1 in fp32, layers 2-4 on
bf16-rounded inputs and weights with fp32 sums.

Tolerance against JAX: one bf16 ulp (2^-8) of the output scale. The two
sum the fp32 products in another order; where a sum lands near a bf16
rounding boundary that can flip one rounding of an activation at a later
layer's input, which moves the output by about one bf16 ulp of that
activation times a weight. Against fp32 serving: 2^-5 of the output scale
(three layers' bf16 roundings).

xdist worker time: ~6 s on an 8-CPU Intel Xeon host (one interpret-mode JAX build).
"""
import os
import pickle

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.ops import policy_kernel as jpk
from iterative_learning_nmpc_tpu_torch.ops import policy_pd as tpp

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
KP, KD, B = 20.0, 1.5, 64
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def case():
    """(folded numpy layers, x, qj, vj) with numpy-seeded inputs."""
    with open(ARTIFACT, "rb") as f:
        layers = tpp.fold_batchnorm(pickle.load(f)["variables"])
    rng = np.random.default_rng(0)
    x, qj, vj = (rng.normal(size=(B, n)).astype(np.float32) for n in (47, 12, 12))
    return layers, x, qj, vj


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_bf16_factory_matches_jax_bf16_kernel(case):
    layers, x, qj, vj = case
    fn = jpk.make_fused_policy_pd(layers, KP, KD, tile_b=64, interpret=True,
                                  compute_dtype=jnp.bfloat16)
    a_j, t_j = (np.asarray(o) for o in fn(x, qj, vj))
    a_t, t_t = tpp.make_fused_policy_pd(layers, KP, KD, compute_dtype=torch.bfloat16,
                                        device="cpu")(*_t(x, qj, vj))
    layers_t = [tuple(_t(W, b)) for W, b in layers]
    a_p, t_p = tpp.policy_pd_bf16_plain(layers_t, KP, KD, *_t(x, qj, vj))
    assert torch.equal(a_t, a_p) and torch.equal(t_t, t_p)
    scale = max(1.0, float(np.abs(a_j).max()))
    assert np.abs(a_t.numpy() - a_j).max() <= BF16_ULP * scale
    assert np.abs(t_t.numpy() - t_j).max() <= KP * BF16_ULP * scale + 1e-3


def test_fp32_factory_equals_policy_pd_plain(case):
    layers, x, qj, vj = case
    out = tpp.make_fused_policy_pd(layers, KP, KD, device="cpu")(*_t(x, qj, vj))
    ref = tpp.policy_pd_plain([tuple(_t(W, b)) for W, b in layers], KP, KD, *_t(x, qj, vj))
    assert all(torch.equal(o, r) for o, r in zip(out, ref))


def test_bf16_weights_are_rounded_once(case):
    layers, _, _, _ = case
    bl = tpp.bf16_layers(layers, device="cpu")
    assert bl[0][0].dtype == torch.float32 and torch.equal(bl[0][0], torch.as_tensor(layers[0][0]))
    for (W, b), (W0, b0) in zip(bl[1:], layers[1:]):
        assert W.dtype == torch.bfloat16 and b.dtype == torch.float32
        ref = torch.as_tensor(W0).to(torch.bfloat16)      # round to nearest even
        assert torch.equal(W[:, :ref.shape[1]], ref) and torch.equal(b, torch.as_tensor(b0))
    W4 = bl[3][0]
    assert tuple(W4.shape) == (512, 16) and not W4[:, 12:].any()


def test_bf16_twin_within_its_bound_of_fp32(case):
    layers, x, qj, vj = case
    layers_t = [tuple(_t(W, b)) for W, b in layers]
    a16, _ = tpp.policy_pd_bf16_plain(layers_t, KP, KD, *_t(x, qj, vj))
    a32, _ = tpp.policy_pd_plain(layers_t, KP, KD, *_t(x, qj, vj))
    scale = max(1.0, float(a32.abs().max()))
    gap = float((a16 - a32).abs().max()) / scale
    assert 0.0 < gap <= 2.0 ** -5


def test_factory_rejects_other_compute_dtypes(case):
    with pytest.raises(ValueError, match="compute_dtype"):
        tpp.make_fused_policy_pd(case[0], KP, KD, compute_dtype=torch.float16, device="cpu")
