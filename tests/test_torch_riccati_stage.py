"""The Riccati node stage's numerical edge case and the sweeps' input
contract, on the CPU: torch and numpy only, no JAX (~2 s alone).

``near_floor_case`` makes one node of GN blocks from a jointly positive
semi-definite stage Hessian whose force block has one eigenvalue at ~1e-6
of the rest, so the 30x30 Cholesky of Quu meets a pivot near its floor
while Quu stays positive definite. Its gains are ill-conditioned (cond(Quu)
~1e7: two fp32 solvers differ by ~1e-1), so the solve is held by its
normwise backward error in float64, which a backward-stable fp32 Cholesky
keeps near 2^-24 whatever the conditioning;
tests/test_torch_cuda_kernels.py holds the kernels to it on the card.
"""
import numpy as np
import torch

from iterative_learning_nmpc_tpu_torch.ops import riccati as R

H_STEP = 0.02
# a backward-stable solve of order 30 in fp32: 30 unit roundoffs
BACKWARD_GATE = 30 * 2.0 ** -24


def near_floor_case(B: int, seed: int, eps: float = 1e-6):
    """One node (N=1) of B problems: (Q, R, M, qx, ru) float32 from
    H = J^T J (+1e-3 on the x and acceleration diagonals), J (80 x 66)
    ~ N(0, 1/80) with the force columns squeezed by sqrt(eps) along a unit
    direction near the last one (so the last pivot is the small one), and
    the gradient J^T r; P_N = 0, p_N = 0 (so
    Quu = R + lm I), defects and dx0 small."""
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1, (B, 1, 80, 66)) / np.sqrt(80)
    v = rng.normal(0, 0.2, (B, 1, 12))
    v[..., -1] = 1.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    S = np.broadcast_to(np.eye(66), (B, 1, 66, 66)).copy()
    S[..., 54:, 54:] -= (1 - np.sqrt(eps)) * v[..., :, None] * v[..., None, :]
    J = J @ S
    H = np.swapaxes(J, -1, -2) @ J
    H[..., np.arange(54), np.arange(54)] += 1e-3
    g = (np.swapaxes(J, -1, -2) @ rng.normal(0, 0.1, (B, 1, 80, 1)))[..., 0]
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
    blocks = [f32(a) for a in (H[..., :36, :36], H[..., 36:, 36:], H[..., :36, 36:],
                               g[..., :36], g[..., 36:])]
    zeros = torch.zeros(B, 36, 36), torch.zeros(B, 36)
    return (blocks, *zeros, f32(rng.normal(0, 1e-3, (B, 1, 36))),
            f32(rng.normal(0, 1e-2, (B, 36))))


def backward_error(blocks, lm: float, gains) -> float:
    """Max over problems of the normwise (inf-norm) backward error of the
    node's solve Quu G = -[Qux | qu] in float64, Quu = R + lm I, Qux = M^T,
    qu = ru (P_N = 0): |Quu G + rhs| / (|Quu| |G| + |rhs|)."""
    Quu = blocks[1][:, 0].double() + lm * torch.eye(30, dtype=torch.float64)
    rhs = torch.cat([blocks[2][:, 0].double().transpose(1, 2),
                     blocks[4][:, 0].double()[..., None]], 2)
    G = gains[:, 0].double()
    nrm = lambda a: a.abs().sum(-1).amax(-1)
    return float((nrm(Quu @ G + rhs) / (nrm(Quu) * nrm(G) + nrm(rhs))).max())


def test_near_floor_case_has_a_tiny_positive_pivot():
    """Quu = R (lm = 0) is positive definite with one eigenvalue at ~1e-6
    of the largest; the factor's last pivot L[29][29]^2 is as small."""
    blocks = near_floor_case(16, 0)[0]
    Quu = blocks[1][:, 0].double()
    ev = torch.linalg.eigvalsh(Quu)
    assert float(ev[:, 0].min()) > 0.0
    ratio = ev[:, 0] / ev[:, -1]
    assert float(ratio.max()) < 3e-6 and float(ratio.min()) > 1e-8
    piv = torch.linalg.cholesky(Quu).diagonal(dim1=-2, dim2=-1) ** 2
    assert float((piv[:, -1] / piv.amax(-1)).max()) < 3e-6


def test_plain_sweep_meets_the_near_floor_gate():
    """The gate the kernels are held to is met by the fp32 twin (LAPACK's
    Cholesky), and the float64 twin solves the system to rounding."""
    blocks, P_N, p_N, d, _ = near_floor_case(16, 1)
    g32 = R.riccati_sweep(H_STEP, 0.0, *blocks, P_N, p_N, d)
    g64 = R.riccati_sweep(H_STEP, 0.0, *(x.double() for x in (*blocks, P_N, p_N, d)))
    assert bool(torch.isfinite(g32).all())
    assert backward_error(blocks, 0.0, g32) <= BACKWARD_GATE
    assert backward_error(blocks, 0.0, g64) <= 1e-12


def test_sweep_inputs_are_16_byte_aligned():
    """The sweeps copy the GN blocks by 16-byte cp.async: a contiguous view
    that starts 4 bytes into its storage is handed on as an aligned copy,
    an aligned one as it is."""
    base = torch.arange(1 + 2 * 36, dtype=torch.float32)
    shapes = {"qx": (2, 36), "d": (2, 36)}
    out = R._checked("test", base.device, shapes,
                     {"qx": base[1:].view(2, 36), "d": base[:72].view(2, 36)})
    assert out["qx"].data_ptr() % 16 == 0
    assert torch.equal(out["qx"], base[1:].view(2, 36))
    assert out["d"].data_ptr() == base.data_ptr()
