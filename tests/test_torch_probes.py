"""The port's probes (``ops/probes.py``) against the JAX package and the
reference scripts, on the CPU.

- ``node_solve_plain`` against the JAX package's node solve,
  ``ops/riccati_kernel._solve_node_unrolled``, called eagerly outside
  Pallas on (d, d, L)-laid arrays of a few lanes, the u blocks padded to
  NUP=32 as ``scripts/proto_sublane_riccati.py`` pads them (identity on the
  pad diagonal); inputs from that script's generator. Tolerance 1e-5 of each
  output's scale: fp32 sums in another order on a well-conditioned Quu
  (G G^T + 3 I).
- ``node_solve_plain`` against ``_solve_node_sublane`` of
  ``scripts/proto_sublane_riccati.py:100`` (the body of the TPU kernel
  ``_kernel_sublane``, which ``node_solve_warp`` replaces): its output on 37
  nodes of that script's generator, stored by
  ``scripts/make_torch_node_solve_golden.py`` in
  ``tests/data/node_solve_sublane_golden.npz`` (the solve takes ~25 s to
  compile on the CPU, so this test reads the file and imports no JAX), each
  mapping's CPU route on the same inputs. Tolerance 1e-5 of each output's
  scale, as above.
- The three mappings' CPU paths, the batch-innermost layout's round trip,
  ``fma_chain_plain`` against a numpy recurrence, and the port's copies of
  the hand FLOP counts against ``scripts/roofline.py``'s.

xdist worker time: ~8 s on an 8-CPU Intel Xeon host (no JAX build: the node solve runs
eagerly, op by op); the sublane golden's tests under 0.1 s of it.
"""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from iterative_learning_nmpc_tpu.ops import riccati_kernel as jrk
from iterative_learning_nmpc_tpu_torch.ops import probes

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBLANE_GOLDEN = os.path.join(ROOT, "tests", "data", "node_solve_sublane_golden.npz")
NX, NU, NUP = 36, 30, 32


def _lanes(x):
    """(L, ...) -> (..., L) as numpy."""
    return np.moveaxis(x.numpy(), 0, -1)


def test_node_solve_plain_matches_jax_node_solve():
    L = 4
    Qxx, Quu, Qux, qxp, qu = (t.reshape(L, *t.shape[2:])
                              for t in probes.reference_node_blocks(L, 1, seed=3))
    pu = NUP - NU
    Quu_p = np.pad(Quu.numpy(), ((0, 0), (0, pu), (0, pu)))
    Quu_p[:, NU:, NU:] += np.eye(pu, dtype=np.float32)
    Qux_p = np.pad(Qux.numpy(), ((0, 0), (0, pu), (0, 0)))
    qu_p = np.pad(qu.numpy(), ((0, 0), (0, pu)))
    lanes = lambda a: jnp.asarray(np.moveaxis(a, 0, -1))
    K_j, kff_j, P_j, p_j = jrk._solve_node_unrolled(
        lanes(Qxx.numpy()), lanes(Quu_p), lanes(Qux_p), lanes(qxp.numpy()[..., None]),
        lanes(qu_p[..., None]))
    K, kff, P, p = probes.node_solve_plain(Qxx, Quu, Qux, qxp, qu)
    for mine, ref in ((K, K_j), (kff[..., None], kff_j), (P, P_j), (p[..., None], p_j)):
        ref = np.asarray(ref)
        assert _lanes(mine).shape == ref.shape
        assert np.abs(_lanes(mine) - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("mapping", ["plain", "block", "warp", "thread"])
def test_node_solve_matches_the_sublane_golden(mapping):
    g = np.load(SUBLANE_GOLDEN)
    args = [torch.as_tensor(g[k]) for k in ("Qxx", "Quu", "Qux", "qxp", "qu")]
    L = args[0].shape[0]
    assert L == 37
    fn = getattr(probes, f"node_solve_{mapping}")
    if mapping == "thread":
        outs = [probes.unlay_batch_inner(o, (L,))
                for o in fn(*(probes.lay_batch_inner(a, a.dim() - 1) for a in args))]
    else:
        outs = fn(*args)
    for name, mine in zip(("K", "kff", "P", "p"), outs):
        ref = g[name]
        assert tuple(mine.shape) == ref.shape
        # fp32 sums in another order on Quu = G G^T + 3 I (eigenvalues in [3, ~14])
        assert np.abs(mine.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_node_solve_mappings_take_the_twin_on_the_cpu():
    B, N = 3, 2
    args = probes.reference_node_blocks(B, N, seed=1)
    ref = probes.node_solve_plain(*args)
    laid = [probes.lay_batch_inner(a, a.dim() - 2) for a in args]
    outs = {"block": probes.node_solve_block(*args), "warp": probes.node_solve_warp(*args),
            "thread": [probes.unlay_batch_inner(o, (B, N))
                       for o in probes.node_solve_thread(*laid)]}
    for out in outs.values():
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert tuple(ref[0].shape) == (B, N, NU, NX) and tuple(ref[3].shape) == (B, N, NX)


@pytest.mark.parametrize("shape, nd", [((3, 2, 36, 36), 2), ((5, 30), 1), ((36, 36), 2)])
def test_lay_batch_inner_round_trips(shape, nd):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    lead = shape[:len(shape) - nd]
    laid = probes.lay_batch_inner(x, nd)
    assert tuple(laid.shape) == (*shape[len(shape) - nd:], int(np.prod(lead)))
    assert laid.is_contiguous()
    assert torch.equal(probes.unlay_batch_inner(laid, lead), x)
    # neighbouring (problem, node) pairs sit at neighbouring addresses
    flat = x.reshape(-1, *shape[len(shape) - nd:])
    assert torch.equal(laid[(0,) * nd], flat[(slice(None),) + (0,) * nd])


def test_fma_chain_plain_matches_a_numpy_recurrence():
    rng = np.random.default_rng(0)
    a = (0.5 + 0.5 * rng.random(257)).astype(np.float32)
    b = (0.05 + 0.85 * rng.random(257)).astype(np.float32)
    iters, nacc = 40, 4
    xs = [a * np.float32(1.0 + 0.001 * k) for k in range(nacc)]
    for _ in range(iters):
        xs = [x * b + b for x in xs]
    ref = xs[0]
    for x in xs[1:]:
        ref = ref + x
    out = probes.fma_chain(torch.as_tensor(a), torch.as_tensor(b), iters, nacc)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    assert probes.fma_chain_flops(257, iters, nacc) == 2.0 * 257 * iters * nacc


def test_hand_counts_equal_the_reference_script():
    spec = importlib.util.spec_from_file_location(
        "roofline", os.path.join(ROOT, "scripts", "roofline.py"))
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    assert (roofline.B, roofline.N) == (512, 25)
    assert probes.algo_flops_lingram() == roofline.algo_flops_lingram()
    assert probes.algo_flops_riccati() == roofline.algo_flops_riccati()
    # per (problem, node): linear in B and N
    assert probes.algo_flops_lingram(256, 100) == 2 * roofline.algo_flops_lingram()
    sweep_only = probes.algo_flops_riccati(rollout=False)
    assert sweep_only == roofline.algo_flops_riccati() - 2.0 * (30 * 36 + 3 * 36) * 512 * 25
    # the node solve's terms: Cholesky, the two triangular solves, the Gram, the vectors
    assert probes.node_solve_flops(1) == 2.0 * (9000 + 16200 + 16200 + 19440 + 2160)
