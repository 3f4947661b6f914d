"""Probes of the card and of the Riccati node solve: CUDA kernels
``csrc/probes.cu`` and their plain PyTorch twins, and the hand counts of
the solver kernels' minimal work.

- ``fma_chain``: the fp32 FMA ceiling (replaces the Pallas probe of
  ``scripts/roofline.py:vpu_peak_tflops``).
- ``node_solve_block`` / ``node_solve_warp`` / ``node_solve_thread``: one
  Riccati node's factorize-and-solve under three thread mappings (a block,
  a warp, a thread per node; replaces ``_kernel_lanes`` and
  ``_kernel_sublane`` of ``scripts/proto_sublane_riccati.py``). The block
  mapping runs the node stage of ``csrc/riccati.cuh`` that kernels 3, 4
  and 6 run, one block of ``RIC_THREADS`` (192) threads a node:
  ``ric_factor`` on the factor warp; ``ric_forward``, ``ric_backward`` and
  ``ric_value_p`` on the column threads; ``ric_value_tile`` on the tile
  threads. The warp and thread mappings are the baselines it was chosen
  against. All three compute ``node_solve_plain``'s function.

CPU tensors take the twins; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import _build
from .dyncore import _check

NX, NU, NW = 36, 30, 37
NACC_CHOICES = (1, 2, 4, 8)
# the ceiling's shape: 4 waves of 2048 resident threads on each of the 132
# SMs, 8 chains of 4096 steps per thread (7.1e10 flops)
FMA_N, FMA_ITERS, FMA_NACC = 132 * 2048 * 4, 4096, 8


# ---- the hand counts (copied from scripts/roofline.py, with B and N) ----
def algo_flops_lingram(B: int = 512, N: int = 25) -> float:
    """Per-(node, problem) algorithmic MACs of linearize+Gram, x2 for FLOPs.

    Row structure of the 130-row stage Jacobian (solver/linearize.py):
    - Jacobian build: 40 x-tangent dual numbers through the leg
      kinematics + RNEA recursion. One structured FK+RNEA evaluation for
      the 18-dof quadruped is ~1.1k MACs (analytic base + 4 legs x 3
      links x ~30 ops x 3 components); each of the 40 tangent rows pays
      the multiply-add half of every product rule (~1.5x value cost
      after constant folding of spec constants).
    - analytic ypr mass matrix (d tau/d a): symmetric 18x18, leg-block
      sparse: ~4k MACs.
    - Gram accumulation G += r_w * J_row^T J_row by row group:
      18 dynamics + 12 torque rows touch all 66 cols: 30 * 66*67/2;
      24 foot-kinematic rows touch 36 x-cols: 24 * 36*37/2;
      ~56 diagonal tracking/acc/force rows: ~56 adds (negligible).
    """
    rnea = 1100.0
    jac = 40 * 1.5 * rnea + 4000.0
    gram = 30 * (66 * 67 / 2) + 24 * (36 * 37 / 2)
    return 2.0 * (jac + gram) * B * N


def algo_flops_riccati(B: int = 512, N: int = 25, rollout: bool = True) -> float:
    """Per-(node, problem) algorithmic MACs of the structured backward
    sweep + affine rollout, x2 for FLOPs (sqp._riccati_solve_structured).

    - Quu~ = R + B^T P B via structured A/B: O(nx^2) scale-adds ~ 3*36^2
    - Cholesky(30):            30^3/3
    - W = L^-1 Qux~ (30x36):   30^2*36/2
    - K backsolve L^-T W:      30^2*36/2
    - P' = Qxx~ - W^T W (sym): 36^2*30/2
    - vectors kff, p':         ~2*30*36
    - structured A-products:   ~4*36^2 masked roll scale-adds
    - forward rollout du=Kdx+kff, dx'=Adx+Bdu+d: (30*36 + ~3*36)/node

    ``rollout=False`` drops the last term (the sweep kernels 4 and 6).
    """
    sweep = (3 * 36**2 + 30**3 / 3 + 30**2 * 36 / 2 + 30**2 * 36 / 2
             + 36**2 * 30 / 2 + 2 * 30 * 36 + 4 * 36**2)
    roll = 30 * 36 + 3 * 36 if rollout else 0
    return 2.0 * (sweep + roll) * B * N


def algo_flops_dyncore(M: int = 2 * 512 * 26) -> float:
    """Per-evaluation algorithmic MACs of FK + foot velocities + RNEA, x2
    for FLOPs (csrc/dyncore.cu counted once per evaluation, none of its
    lanes' repeats of the trunk's terms), over M evaluations.

    - trunk frame, Euler-rate map, w_b, dw_b:                       ~60
    - each of 12 links: the joint axis and offset in the world (18), the
      joint rotation (Rodrigues 18, R_p Rot 27), the velocity and
      acceleration recursion (~45), the CoM acceleration (~27), R I R^T
      on w and dw (54), the link wrench (~21):                     ~228
    - each of 4 feet: point, velocity, the wrench of its force:     ~27
    - each of 12 joint torques: the wrench sums and a . (M - p x F): ~18
    - trunk Newton-Euler and the Euler-chart moment:               ~141
    The 15 sin/cos pairs count one operation each.
    """
    macs = 60 + 12 * 228 + 4 * 27 + 12 * 18 + 141
    return (2.0 * macs + 15) * M


def node_solve_flops(M: int) -> float:
    """The node solve's terms of algo_flops_riccati (Cholesky, the two
    triangular solves, the Gram, the vectors), x2 for FLOPs, over M nodes."""
    return 2.0 * (30**3 / 3 + 30**2 * 36 / 2 + 30**2 * 36 / 2 + 36**2 * 30 / 2
                  + 2 * 30 * 36) * M


def node_solve_bytes(M: int) -> int:
    """Inputs read once and outputs written once, fp32, over M nodes."""
    return 4 * M * ((NX * NX + NU * NU + NU * NX + NX + NU)
                    + (NU * NX + NU + NX * NX + NX))


# ---- fma_chain ----
def fma_chain_flops(n: int, iters: int, nacc: int) -> float:
    return 2.0 * n * iters * nacc


def fma_chain_plain(a: torch.Tensor, b: torch.Tensor, iters: int, nacc: int) -> torch.Tensor:
    """a, b (n,) -> (n,): nacc chains x_k = a (1 + 0.001 k), each stepped
    ``iters`` times as x_k <- x_k b + b, summed."""
    xs = [a * (1.0 + 0.001 * k) for k in range(nacc)]
    for _ in range(iters):
        xs = [x * b + b for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def fma_chain(a: torch.Tensor, b: torch.Tensor, iters: int, nacc: int) -> torch.Tensor:
    """The FMA-chain probe; same contract as fma_chain_plain. 2 n iters nacc
    flops; the caller sizes n to whole waves of the card."""
    if a.device.type == "cpu":
        return fma_chain_plain(a, b, iters, nacc)
    if a.device.type != "cuda":
        raise ValueError(f"fma_chain: unsupported device {a.device}")
    if nacc not in NACC_CHOICES or iters < 0:
        raise ValueError(f"fma_chain: nacc must be one of {NACC_CHOICES}, iters >= 0")
    n = a.shape[0]
    _check("fma_chain", "a", a, (n,))
    _check("fma_chain", "b", b, (n,))
    if b.device != a.device:
        raise ValueError("fma_chain: a and b must share one device")
    out = torch.empty_like(a)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _build.library().fma_chain_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                                            iters, nacc, stream)
    _build.check(err, "fma_chain_launch")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


# ---- the node solve ----
def node_solve_plain(Qxx, Quu, Qux, qxp, qu) -> Tuple[torch.Tensor, ...]:
    """Qxx (..., 36, 36), Quu (..., 30, 30), Qux (..., 30, 36), qxp (..., 36),
    qu (..., 30) -> K (..., 30, 36), kff (..., 30), P (..., 36, 36),
    p (..., 36): Quu = L L^T, W = L^{-1} [Qux | qu], Z = L^{-T} W, [K | kff]
    = -Z, P = Qxx - W_x^T W_x, p = qxp - W_x^T w_f."""
    L = torch.linalg.cholesky(Quu)
    W = torch.linalg.solve_triangular(L, torch.cat([Qux, qu[..., None]], -1), upper=False)
    Z = torch.linalg.solve_triangular(L.transpose(-1, -2), W, upper=True)
    Wx, wf = W[..., :NX], W[..., NX]
    P = Qxx - Wx.transpose(-1, -2) @ Wx
    p = qxp - (Wx.transpose(-1, -2) @ wf[..., None])[..., 0]
    return -Z[..., :NX], -Z[..., NX], P, p


def reference_node_blocks(B: int, N: int, seed: int = 0, device=None):
    """The random node blocks of scripts/proto_sublane_riccati.py
    (``default_rng(seed)``; Quu = G G^T + 3 I, G ~ N(0, 0.3^2)), batch-major
    float32: (Qxx, Quu, Qux, qxp, qu)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    G = rng.normal(0, 0.3, (B, N, NU, NU)).astype(f32)
    Quu = (G @ np.swapaxes(G, 2, 3) + 3.0 * np.eye(NU, dtype=f32)).astype(f32)
    Qux = rng.normal(0, 0.5, (B, N, NU, NX)).astype(f32)
    Qxx = rng.normal(0, 0.5, (B, N, NX, NX)).astype(f32)
    qxp = rng.normal(0, 0.5, (B, N, NX)).astype(f32)
    qu = rng.normal(0, 0.5, (B, N, NU)).astype(f32)
    return tuple(torch.as_tensor(a, device=device) for a in (Qxx, Quu, Qux, qxp, qu))


def lay_batch_inner(x: torch.Tensor, nd: int) -> torch.Tensor:
    """(..., d1[, d2]) with nd trailing matrix dims -> (d1[, d2], L), the
    batch dims flattened last (L = their product): the thread mapping's
    layout, in which neighbouring threads read neighbouring addresses."""
    return x.reshape(-1, *x.shape[x.dim() - nd:]).movedim(0, -1).contiguous()


def unlay_batch_inner(x: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """The inverse of lay_batch_inner: (d1[, d2], L) -> (*lead, d1[, d2])."""
    return x.movedim(-1, 0).reshape(*lead, *x.shape[:-1])


_SHAPES = {"Qxx": (NX, NX), "Quu": (NU, NU), "Qux": (NU, NX), "qxp": (NX,), "qu": (NU,)}


def _node_solve(name: str, launch: str, args, batch_inner: bool):
    """Check the five inputs (batch-major, or laid out batch-innermost), run
    the kernel ``launch`` into fresh outputs of the same layout."""
    x = args[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if batch_inner:
        M = x.shape[-1]
        shape = lambda s: (*s, M)
    else:
        lead = tuple(x.shape[:-2])
        M = math.prod(lead)
        shape = lambda s: (*lead, *s)
    args = [a.contiguous() for a in args]
    for (k, s), a in zip(_SHAPES.items(), args):
        _check(name, k, a, shape(s))
        if a.device != x.device:
            raise ValueError(f"{name}: every input must lie on Qxx's device")
    outs = [torch.empty(shape(s), dtype=torch.float32, device=x.device)
            for s in ((NU, NX), (NU,), (NX, NX), (NX,))]
    if M == 0:
        return tuple(outs)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(_build.library(), launch)(*[t.data_ptr() for t in (*args, *outs)], M,
                                            stream)
    _build.check(err, launch)
    return tuple(outs)


def node_solve_block(Qxx, Quu, Qux, qxp, qu):
    """One 192-thread block per node (the production node stage); same
    contract as node_solve_plain."""
    if Qxx.device.type == "cpu":
        return node_solve_plain(Qxx, Quu, Qux, qxp, qu)
    out = _node_solve("node_solve_block", "node_solve_block_launch",
                      (Qxx, Quu, Qux, qxp, qu), False)
    node_solve_block.launches += 1
    return out


def node_solve_warp(Qxx, Quu, Qux, qxp, qu):
    """One warp per node; same contract as node_solve_plain."""
    if Qxx.device.type == "cpu":
        return node_solve_plain(Qxx, Quu, Qux, qxp, qu)
    out = _node_solve("node_solve_warp", "node_solve_warp_launch",
                      (Qxx, Quu, Qux, qxp, qu), False)
    node_solve_warp.launches += 1
    return out


def node_solve_thread(Qxx, Quu, Qux, qxp, qu):
    """One thread per node, on inputs laid out by lay_batch_inner: Qxx (36,
    36, L), Quu (30, 30, L), Qux (30, 36, L), qxp (36, L), qu (30, L) -> K
    (30, 36, L), kff (30, L), P (36, 36, L), p (36, L)."""
    if Qxx.device.type == "cpu":
        L = Qxx.shape[-1]
        outs = node_solve_plain(*(unlay_batch_inner(a, (L,)) for a in (Qxx, Quu, Qux, qxp, qu)))
        return tuple(lay_batch_inner(o, o.dim() - 1) for o in outs)
    out = _node_solve("node_solve_thread", "node_solve_thread_launch",
                      (Qxx, Quu, Qux, qxp, qu), True)
    node_solve_thread.launches += 1
    return out


node_solve_block.launches = 0
node_solve_warp.launches = 0
node_solve_thread.launches = 0
