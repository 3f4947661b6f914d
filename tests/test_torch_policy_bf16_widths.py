"""The port's policy factory at widths that are not the kernels' multiples
(``ops/policy_pd.py``: ``pad_hidden``, ``bf16_layers``, the bf16 kernel's
static shape check), against the JAX package and against itself, on the
CPU.

The JAX side is ``ops/policy_kernel.make_fused_policy_pd(...,
compute_dtype=jnp.bfloat16, interpret=True)``, the TPU kernel in interpret
mode as ``tests/test_policy_kernel.py`` runs it, on a seeded net of hidden
widths (132, 100, 260) (``interop.random_policy_payload``, folded) and
numpy-seeded inputs at B=64. The port's side is its factory's CPU path,
which pads the hidden widths with zeros (to 144, 112, 272 for bf16) and
serves through the plain twins. The padding itself is held at hidden
widths (130, 98, 250), which both dtypes pad (fp32 to 132, 100, 252; bf16
to 144, 112, 256), and both factories are held to hand their kernel
widths it takes.

Tolerances: against JAX, one bf16 ulp (2^-8) of the output scale, as in
``tests/test_torch_policy_bf16.py`` (the two sum fp32 products in another
order, which can flip one bf16 rounding of an activation at a later
layer's input). Padded against unpadded: the padded units are exactly 0
and add only +0.0 terms, but a BLAS product may block a longer K
differently, so fp32 within 1e-5 of the output scale and bf16 within one
bf16 ulp of it.

xdist worker time: ~6 s on an 8-CPU Intel Xeon host (one interpret-mode JAX
build).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.ops import policy_kernel as jpk
from iterative_learning_nmpc_tpu_torch.interop import random_policy_payload
from iterative_learning_nmpc_tpu_torch.ops import policy_pd as tpp

torch.set_num_threads(1)
KP, KD, B = 20.0, 1.5, 64
BF16_ULP = 2.0 ** -8
WIDTHS = (132, 100, 260)      # multiples of 4, not of 16
ODD_WIDTHS = (130, 98, 250)   # multiples of neither


def _case(widths):
    """(folded numpy layers of 47 -> widths -> 12, x, qj, vj)."""
    layers = tpp.fold_batchnorm(random_policy_payload(3, widths, 5)["variables"])
    rng = np.random.default_rng(1)
    x, qj, vj = (rng.normal(size=(B, n)).astype(np.float32) for n in (47, 12, 12))
    return layers, x, qj, vj


@pytest.fixture(scope="module")
def case():
    return _case(WIDTHS)


@pytest.fixture(scope="module")
def odd():
    return _case(ODD_WIDTHS)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _hidden(layers, x, bf16: bool):
    """The hidden activations of the plain twin (``policy_pd_plain`` or
    ``policy_pd_bf16_plain``) on x, layer by layer."""
    h, out = x, []
    for i, (W, b) in enumerate(layers[:-1]):
        if bf16 and i > 0:
            h = h.to(torch.bfloat16).float() @ W.to(torch.bfloat16).float() + b
        else:
            h = torch.addmm(b, h, W.float())
        h = torch.relu(h)
        out.append(h)
    return out


def test_bf16_factory_matches_jax_bf16_kernel_at_uneven_widths(case):
    layers, x, qj, vj = case
    fn = jpk.make_fused_policy_pd(layers, KP, KD, tile_b=B, interpret=True,
                                  compute_dtype=jnp.bfloat16)
    a_j, t_j = (np.asarray(o) for o in fn(x, qj, vj))
    assert a_j.shape == (B, 12)
    n0 = tpp.policy_pd_bf16.launches
    a_t, t_t = tpp.make_fused_policy_pd(layers, KP, KD, compute_dtype=torch.bfloat16,
                                        device="cpu")(*_t(x, qj, vj))
    assert tpp.policy_pd_bf16.launches == n0
    scale = max(1.0, float(np.abs(a_j).max()))
    assert np.abs(a_t.numpy() - a_j).max() <= BF16_ULP * scale
    assert np.abs(t_t.numpy() - t_j).max() <= KP * BF16_ULP * scale + 1e-3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_padded_twin_matches_unpadded(odd, compute_dtype):
    """The factory's padded layers through the plain twin against the
    folded layers as they are: the padded activations exactly zero, the
    outputs within the summation-order tolerance."""
    layers, x, qj, vj = odd
    bf16 = compute_dtype == "bfloat16"
    plain = tpp.policy_pd_bf16_plain if bf16 else tpp.policy_pd_plain
    padded = tpp.bf16_layers(layers, "cpu") if bf16 else tpp.pad_hidden(layers, 4, "cpu")
    widths = [int(b.shape[0]) for _, b in padded[:-1]]
    assert widths == ([144, 112, 256] if bf16 else [132, 100, 252])
    xt = torch.as_tensor(x)
    for h, h0 in zip(_hidden(padded, xt, bf16), ODD_WIDTHS):
        assert h.shape[1] > h0 and not h[:, h0:].any()
    ref = [tuple(_t(W, b)) for W, b in layers]
    a_p, t_p = plain(padded, KP, KD, *_t(x, qj, vj))
    a_u, t_u = plain(ref, KP, KD, *_t(x, qj, vj))
    scale = max(1.0, float(a_u.abs().max()))
    tol = BF16_ULP if bf16 else 1e-5
    assert float((a_p - a_u).abs().max()) <= tol * scale
    assert float((t_p - t_u).abs().max()) <= KP * tol * scale + (1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("multiple", [4, 16])
def test_pad_hidden_adds_only_zeros(odd, multiple):
    layers = odd[0]
    padded = tpp.pad_hidden(layers, multiple, "cpu")
    assert [int(b.shape[0]) for _, b in padded[:3]] == [-(-h // multiple) * multiple
                                                        for h in ODD_WIDTHS]
    dims_in = [47, *ODD_WIDTHS]
    for i, ((W, b), (W0, b0)) in enumerate(zip(padded, layers)):
        k0, n0 = W0.shape
        assert W.dtype == b.dtype == torch.float32
        assert W.shape[0] == (dims_in[i] if i == 0 else -(-k0 // multiple) * multiple)
        assert W.shape[1] == (n0 if i == 3 else -(-n0 // multiple) * multiple)
        assert torch.equal(W[:k0, :n0], torch.as_tensor(W0))
        assert torch.equal(b[:n0], torch.as_tensor(b0))
        assert not W[k0:].any() and not W[:, n0:].any() and not b[n0:].any()


def test_bf16_layers_pad_to_the_kernel_widths(case):
    """W1 and the biases float32, W2-W4 bfloat16 rounded once; hidden widths
    padded to 16 with zeros, the original values elsewhere; W4 16 columns."""
    layers = case[0]
    bl = tpp.bf16_layers(layers, "cpu")
    assert [tuple(W.shape) for W, _ in bl] == [(47, 144), (144, 112), (112, 272), (272, 16)]
    assert bl[0][0].dtype == torch.float32
    for i, ((W, b), (W0, b0)) in enumerate(zip(bl, layers)):
        k0, n0 = W0.shape
        ref = torch.as_tensor(W0)
        if i > 0:
            assert W.dtype == torch.bfloat16
            ref = ref.to(torch.bfloat16)
        assert b.dtype == torch.float32
        assert torch.equal(W[:k0, :n0], ref) and torch.equal(b[:n0], torch.as_tensor(b0))
        assert not W[k0:].any() and not W[:, n0:].any() and not b[n0:].any()
    assert tpp._refusal_bf16((47, 144, 112, 272, len(bl[3][1]))) is None


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_factory_hands_its_kernel_widths_it_takes(odd, monkeypatch, compute_dtype):
    """Each factory, at widths neither kernel takes as they are, calls its
    wrapper with padded layers that pass the wrapper's static shape check
    (on a CUDA tensor the unpadded ones would raise), and serves what the
    unpadded twin serves within the summation-order tolerance."""
    layers, x, qj, vj = odd
    bf16 = compute_dtype == "bfloat16"
    name, refusal = (("policy_pd_bf16", tpp._refusal_bf16) if bf16
                     else ("policy_pd", tpp._refusal))
    dims = [47, *ODD_WIDTHS, 12]
    assert refusal(dims) is not None
    seen, wrapper = [], getattr(tpp, name)

    def spy(ls, *args):
        seen.append([47] + [int(W.shape[1]) for W, _ in ls])
        return wrapper(ls, *args)

    monkeypatch.setattr(tpp, name, spy)
    fn = tpp.make_fused_policy_pd(layers, KP, KD, compute_dtype=getattr(torch, compute_dtype),
                                  device="cpu")
    a_f, _ = fn(*_t(x, qj, vj))
    assert len(seen) == 1 and refusal(seen[0]) is None, seen
    plain = tpp.policy_pd_bf16_plain if bf16 else tpp.policy_pd_plain
    a_u, _ = plain([tuple(_t(W, b)) for W, b in layers], KP, KD, *_t(x, qj, vj))
    scale = max(1.0, float(a_u.abs().max()))
    assert float((a_f - a_u).abs().max()) <= (BF16_ULP if bf16 else 1e-5) * scale


@pytest.mark.parametrize("width, refused", [(1024, False), (1025, True), (2048, True)])
def test_bf16_refusal_past_the_width_limit(width, refused):
    """The wrapper's static shape check on the factory's padded widths: up to
    1024 taken, past it refused with the limit in the message."""
    layers = tpp.fold_batchnorm(random_policy_payload(3, (width, 64, 64), 3)["variables"])
    bl = tpp.bf16_layers(layers, "cpu")
    why = tpp._refusal_bf16((47, *[int(b.shape[0]) for _, b in bl[:3]], 12))
    assert (why is not None) == refused
    if refused:
        assert "1024" in why and str(-(-width // 16) * 16) in why
