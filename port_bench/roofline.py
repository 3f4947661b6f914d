"""The yardstick of the roofline shares: the chip's published peaks and the
algorithm's work in each of the step's kernels, from the shapes alone.

Peaks: NVIDIA H100 SXM, float32 outside the tensor cores 67 TFLOP/s, HBM3
3.35 TB/s (NVIDIA's data sheet, at the full 700 W power limit). The
operation counts are the hand counts of ``ops/probes.py`` of the port
(``algo_flops_lingram``, ``algo_flops_riccati``, ``algo_flops_dyncore``),
frozen here; the rollout's part of the Riccati count is kernel 5's. Bytes
are the algorithm's inputs read once and its outputs written once, float32:
nothing a kernel re-reads or keeps between its launches counts.

A kernel's least time is the larger of operations / peak FLOP/s and bytes
/ peak bandwidth; its roofline share is that least time over its measured
device time a call.
"""
from __future__ import annotations

PEAK_FLOPS = 67.0e12
PEAK_BYTES_S = 3.35e12
F32 = 4

NX, NU, NW = 36, 30, 37
BLOCKS = NX * NX + NU * NU + NX * NU + NX + NU      # Q, R, M, qx, ru of a node
NODE_PARAMS = 104                                    # the kernels' per-node parameters
TERMINAL = NX + 4 + 12 + 12 + 1                      # xN, peak_N, base_ref_e, joint_ref, step_h


def flops_lingram(B: int, N: int) -> float:
    """Linearize + Gram of every node (``algo_flops_lingram``)."""
    rnea = 1100.0
    jac = 40 * 1.5 * rnea + 4000.0
    gram = 30 * (66 * 67 / 2) + 24 * (36 * 37 / 2)
    return 2.0 * (jac + gram) * B * N


def flops_riccati(B: int, N: int, rollout: bool = True) -> float:
    """Structured sweep (+ the alpha = 1 rollout) (``algo_flops_riccati``)."""
    sweep = (3 * 36**2 + 30**3 / 3 + 30**2 * 36 / 2 + 30**2 * 36 / 2
             + 36**2 * 30 / 2 + 2 * 30 * 36 + 4 * 36**2)
    roll = 30 * 36 + 3 * 36 if rollout else 0
    return 2.0 * (sweep + roll) * B * N


def flops_rollout(B: int, N: int) -> float:
    """The rollout's part of ``flops_riccati``."""
    return flops_riccati(B, N, True) - flops_riccati(B, N, False)


def flops_dyncore(M: int) -> float:
    """FK + foot velocities + RNEA of M evaluations (``algo_flops_dyncore``)."""
    macs = 60 + 12 * 228 + 4 * 27 + 12 * 18 + 141
    return (2.0 * macs + 15) * M


def bytes_lingram(B: int, N: int) -> int:
    """X and U of every node and its parameters in; the blocks out."""
    return F32 * B * N * (NX + NU + NODE_PARAMS + BLOCKS)


def bytes_riccati_rollout(B: int, N: int) -> int:
    """Blocks and defects of every node, dx0 and the terminal inputs in;
    dX (B, N+1, 36) and dU (B, N, 30) out."""
    return F32 * (B * N * (BLOCKS + NX + NU) + B * (NX + TERMINAL + NX))


def bytes_riccati_sweep_terminal(B: int, N: int) -> int:
    """Blocks and defects in, the terminal inputs; the gains [K | kff] out."""
    return F32 * (B * N * (BLOCKS + NX + NU * NW) + B * TERMINAL)


def bytes_forward_rollout(B: int, N: int) -> int:
    """Gains and defects in, dx0; dX and dU out."""
    return F32 * (B * N * (NU * NW + NX + NX + NU) + B * (NX + NX))


def bytes_dyncore(M: int) -> int:
    """x, a, f of every evaluation in; feet points, velocities, tau out."""
    return F32 * M * (NX + 18 + 12 + 42)


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def kernels(B: int, N: int, n_alpha: int, fused: bool) -> dict:
    """{kernel: (flops, bytes)} of one inner pass of the step."""
    out = {"lingram": (flops_lingram(B, N), bytes_lingram(B, N))}
    if fused:
        out["riccati_rollout"] = (flops_riccati(B, N), bytes_riccati_rollout(B, N))
    else:
        out["riccati_sweep_terminal"] = (flops_riccati(B, N, False),
                                         bytes_riccati_sweep_terminal(B, N))
        out["forward_rollout"] = (flops_rollout(B, N), bytes_forward_rollout(B, N))
    M = n_alpha * B * (N + 1)
    out["dyncore"] = (flops_dyncore(M), bytes_dyncore(M))
    return out


def pass_least_s(B: int, N: int, n_alpha: int, fused: bool) -> float:
    """Least time of one pass: its kernels run one after another, each on
    what the one before wrote."""
    return sum(least_s(f, b) for f, b in kernels(B, N, n_alpha, fused).values())


def pass_flops(B: int, N: int, n_alpha: int, fused: bool) -> float:
    return sum(f for f, _ in kernels(B, N, n_alpha, fused).values())
