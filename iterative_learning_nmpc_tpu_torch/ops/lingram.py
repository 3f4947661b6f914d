"""Linearize + Gauss-Newton Gram blocks of every (problem, node): CUDA
kernel ``csrc/lingram.cu`` and its plain PyTorch twin.

Replaces the JAX package's ``ops/dynjac_kernel.py:lingram_lane_major``
(``_lingram_kernel``). Outputs are batch-major, as ``lingram_structured``
returns them: Q (B,N,36,36), R (B,N,30,30), M (B,N,36,30), qx (B,N,36),
ru (B,N,30). CPU tensors take ``lingram_plain``; CUDA tensors launch the
kernel or raise. The kernel sums the Gram row group by row group from one
structured derivative pass per node.

``gram_gate`` is the yardstick the kernel is held to: per part of each
block, with every row group on and with each row group alone.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..ocp.problem import NU, NX, OCPParams, Weights
from ..robots.spec import RobotSpec
from ..solver.linearize import gn_blocks_jacfwd
from . import _build
from .layout import cached_robot_consts, node_params, weight_consts


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
    consts = cached_robot_consts(spec, dev)
    wts = weight_consts(spec.to(dev), w.to(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    Q = torch.empty(B, N, NX, NX, **f32)
    R = torch.empty(B, N, NU, NU, **f32)
    M = torch.empty(B, N, NX, NU, **f32)
    qx = torch.empty(B, N, NX, **f32)
    ru = torch.empty(B, N, NU, **f32)
    if B * N == 0:
        return Q, R, M, qx, ru
    lib = _build.library()
    # the row buffer between the kernel's three launches
    rows = torch.empty(B * N, lib.lingram_row_floats(), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lingram_launch(
        Xn.data_ptr(), Un.data_ptr(), par.data_ptr(), consts.data_ptr(),
        wts.data_ptr(), rows.data_ptr(), Q.data_ptr(), R.data_ptr(), M.data_ptr(),
        qx.data_ptr(), ru.data_ptr(), B * N, int(bool(include_torque)), stream)
    _build.check(err, "lingram_launch")
    lingram.launches += 1
    return Q, R, M, qx, ru


def kernel_attributes() -> dict:
    """{kernel: (registers, local bytes)} of the three compiled kernels
    (cudaFuncGetAttributes; local bytes are the stack frame and spills)."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.library().lingram_attributes(out), "lingram_attributes")
    names = ("lingram_rows_kernel", "lingram_mass_kernel", "lingram_gram_kernel")
    return {k: (out[2 * i], out[2 * i + 1]) for i, k in enumerate(names)}


# the stage residual's row groups, by the weights that scale them
# (ocp/problem.py:stage_residual)
ROW_GROUPS = {
    "tracking": ("base", "joint"),
    "acceleration": ("acc",),
    "force_reg": ("f_reg",),
    "swing_peak": ("swing",),
    "foot_disp": ("foot_disp",),
    "patch": ("patch",),
    "dynamics": ("dyn_cons",),
    "contact_pin": ("contact_vel",),
    "cone": ("cone",),
    "clearance": ("swing_clear",),
    "torque": ("torque",),
}
# column groups of the blocks: x = q | v, u = a | f
_XCOLS = (("q", slice(0, 18)), ("v", slice(18, NX)))
_UCOLS = (("a", slice(0, 18)), ("f", slice(18, NU)))


def isolate_group(w: Weights, group: str) -> Weights:
    """``w`` with the weights of every row group but ``group`` set to 0 (the
    unweighted swing-force pinning of R stays)."""
    return dataclasses.replace(w, **{f: torch.zeros_like(getattr(w, f))
                                     for g, fs in ROW_GROUPS.items() if g != group
                                     for f in fs})


def block_parts(blocks) -> list:
    """[(name, tensor)]: each of Q, R, M, qx, ru whole, then cut by column
    group (Q_qv, R_ff, M_va, qx_q, ...)."""
    Q, R, M, qx, ru = blocks
    out = list(zip(("Q", "R", "M", "qx", "ru"), blocks))
    for name, blk, rows, cols in (("Q", Q, _XCOLS, _XCOLS), ("R", R, _UCOLS, _UCOLS),
                                  ("M", M, _XCOLS, _UCOLS)):
        out += [(f"{name}_{a}{b}", blk[..., i, j]) for a, i in rows for b, j in cols]
    out += [(f"qx_{a}", qx[..., i]) for a, i in _XCOLS]
    out += [(f"ru_{a}", ru[..., i]) for a, i in _UCOLS]
    return out


def _double(obj):
    """A dataclass of tensors (RobotSpec, Weights, OCPParams) in float64."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})


def gram_gate(fn, spec: RobotSpec, w: Weights, X: torch.Tensor, U: torch.Tensor,
              p: OCPParams, include_torque: bool = True, labels=None) -> dict:
    """{label: [(part, err, bound, err64, twin64, ok)]}: ``fn`` (``lingram``'s
    signature) against ``lingram_plain`` with every row group on ("all") and
    with each row group of ``ROW_GROUPS`` alone, per part of each block
    (``block_parts``). Alone, a small group (a friction cone, the swing
    clearance) is held on its own scale, which the blocks' largest entries
    (the dynamics rows') would hide. ``labels`` picks some of the labels.

    err = max |fn - plain| and bound = 3e-4 * max(1, |plain|), the Gram
    bound of tests/test_fast_linearize.py. The five whole blocks under
    "all" must meet it. A part may instead be no further from the float64
    twin than twice the fp32 twin is (err64 <= 2 * twin64), as the sweep
    kernels are held: near a converged point a gradient part is a small sum
    of large cancelling terms (a dynamics residual of one fp32 ulp of the
    150 N body weight times w_dyn), whose fp32 value neither twin nor
    kernel resolves to 3e-4 of its size."""
    out = {}
    s64, w64, p64 = _double(spec), _double(w), _double(p)
    for label in labels or ("all", *ROW_GROUPS):
        wl = w if label == "all" else isolate_group(w, label)
        wl64 = w64 if label == "all" else isolate_group(w64, label)
        got = block_parts(fn(spec, wl, X, U, p, include_torque))
        ref = block_parts(lingram_plain(spec, wl, X, U, p, include_torque))
        ref64 = block_parts(lingram_plain(s64, wl64, X.double(), U.double(), p64,
                                          include_torque))
        rows = []
        for k, ((n, a), (_, b), (_, c)) in enumerate(zip(got, ref, ref64)):
            err = float((a - b).abs().max())
            bound = 3e-4 * max(1.0, float(b.abs().max()))
            err64 = float((a.double() - c).abs().max())
            twin64 = float((b.double() - c).abs().max())
            whole = label == "all" and k < 5
            ok = err <= bound or (not whole and err64 <= 2.0 * twin64)
            rows.append((n, err, bound, err64, twin64, ok))
        out[label] = rows
    return out


def gate_failures(gate: dict) -> list:
    """["label part err/bound (float64: err64/twin64)"] of every part that
    fails."""
    return [f"{label} {n} {e:.2e}/{b:.2e} (float64: {e64:.2e}/{t64:.2e})"
            for label, rows in gate.items() for n, e, b, e64, t64, ok in rows if not ok]


def gate_summary(gate: dict) -> str:
    """Per label, the part with the largest err / bound, and how many parts
    passed by the float64 rule."""
    def worst(rows):
        n, e, b, e64, t64, _ = max(rows, key=lambda t: t[1] / t[2])
        by64 = sum(1 for r in rows if r[5] and r[1] > r[2])
        return f"{n} {e:.2e}/{b:.2e}" + (f" ({by64} by float64)" if by64 else "")
    return ", ".join(f"{label} {worst(rows)}" for label, rows in gate.items())


lingram.launches = 0
