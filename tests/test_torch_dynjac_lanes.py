"""The split the dynjac kernel (csrc/dynjac.cu, a (direction, leg) pair per
lane) rests on, held to its plain twin on the CPU: torch and numpy only, no
JAX.

``lane_split`` is the kernel's decomposition written with torch ops, each
lane's leg chain differentiated alone by forward mode (``torch.func.jvp``):
15 base directions (the attitude q 3..5, v 0..5 and a 0..5 of the trunk)
push their tangent through the trunk's state and each of the four legs'
chains, the legs' wrenches summed (l0 + l1) + (l2 + l3) as the lanes' two
shuffle steps sum them, then the trunk's Newton-Euler; the 36 joint
directions push theirs through their own leg's chain alone, and tau 0..5
takes that leg's wrench tangent with the trunk's motion fixed; the base
position's columns are the constants the kernel writes (each foot point
moves with it, nothing else does). J is assembled from zeros, each lane
writing only the rows its direction can move, as the kernel fills its
tile. In float64 it equals ``dynjac_plain`` to rounding; in
float32 it stays within the kernel's gate (tests/test_torch_cuda_kernels.py
``test_dynjac_kernel_matches_plain``: values 1e-5 of their scale, J 3e-5
of its largest entry). The entries no lane writes are
``ops.dynjac.structural_zeros``, and ``dynjac_plain`` has them exactly zero.

xdist worker time: 6.6 s on an 8-CPU host (9 tests, 3.2 s of it the first
jvp's warm-up). The port's test files (tests/test_torch_*.py, -n 6
--dist loadfile, --durations=0) summed 648.1 s of worker time in 199.6 s
of wall before this file and the other added cases, and 433.7 s in 131.5
s after, on one 8-CPU host whose other load, not the tests, made the
difference.
"""
import dataclasses

import pytest
import torch
from torch.func import jvp

from iterative_learning_nmpc_tpu_torch.ops import layout
from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac_plain, structural_zeros
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

from test_torch_dyncore_legs import GRAVITY, OFF, seeded_inputs

torch.set_num_threads(1)
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def spec_in(dtype):
    spec = go2_spec(device="cpu")
    return dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(dtype) for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)
        and getattr(spec, f.name).is_floating_point()})


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(R, x):
    return torch.einsum("nij,nj->ni", R, x)


def _mtv(R, x):
    return torch.einsum("nji,nj->ni", R, x)


def _c(C, name, n, i=0):
    return C[OFF[name] + n * i:OFF[name] + n * i + n]


def trunk_state(q6, v6, a6):
    """The trunk's frame, Euler-rate map, position, velocity, angular
    velocity and accelerations (legdyn.cuh trunk_state), rows batched."""
    cy, cp, cr = torch.cos(q6[:, 3:6]).unbind(1)
    sy, sp, sr = torch.sin(q6[:, 3:6]).unbind(1)
    R = torch.stack([torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], 1),
                     torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], 1),
                     torch.stack([-sp, cp * sr, cp * cr], 1)], 1)
    z, one = torch.zeros_like(sp), torch.ones_like(sp)
    T = torch.stack([torch.stack([-sp, z, one], 1), torch.stack([cp * sr, cr, z], 1),
                     torch.stack([cp * cr, -sr, z], 1)], 1)
    pd, rd = v6[:, 4], v6[:, 5]
    Td = torch.stack([torch.stack([-cp * pd, z, z], 1),
                      torch.stack([-sp * pd * sr + cp * cr * rd, -sr * rd, z], 1),
                      torch.stack([-sp * pd * cr - cp * sr * rd, -cr * rd, z], 1)], 1)
    grav = torch.zeros_like(a6[:, :3])
    grav[:, 2] = GRAVITY
    return dict(R=R, T=T, p=q6[:, :3], v=v6[:, :3], w=_mv(R, _mv(T, v6[:, 3:6])),
                dw=_mv(R, _mv(Td, v6[:, 3:6]) + _mv(T, a6[:, 3:6])), dv=a6[:, :3] + grav)


def leg_chain(C, leg, b, q3, v3, a3, fe3):
    """Leg ``leg``'s foot point and velocity, joint torques, and the wrench
    (F, M about the world origin) it puts on the trunk (legdyn.cuh
    leg_chain)."""
    Rp, pp, wp, vp, dwp, dvp = b["R"], b["p"], b["w"], b["v"], b["dw"], b["dv"]
    N = q3.shape[0]
    links = []
    for k in range(3):
        i = 3 * leg + k
        axis, jp, com = (_c(C, n, 3, i) for n in ("C_AX", "C_JP", "C_COM"))
        Il = _c(C, "C_IC", 9, i).reshape(3, 3)
        K = torch.zeros(3, 3, dtype=C.dtype)
        K[0, 1], K[0, 2], K[1, 0] = -axis[2], axis[1], axis[2]
        K[1, 2], K[2, 0], K[2, 1] = -axis[0], -axis[1], axis[0]
        ck, sk = torch.cos(q3[:, k]), torch.sin(q3[:, k])
        Rot = sk[:, None, None] * K + (1 - ck)[:, None, None] * (K @ K) + torch.eye(3, dtype=C.dtype)
        a_w, off = _mv(Rp, axis.expand(N, 3)), _mv(Rp, jp.expand(N, 3))
        Rk, pk = Rp @ Rot, pp + off
        vk = vp + _cross(wp, off)
        dvk = dvp + _cross(dwp, off) + _cross(wp, _cross(wp, off))
        awqd = a_w * v3[:, k:k + 1]
        wk = wp + awqd
        dwk = dwp + a_w * a3[:, k:k + 1] + _cross(wp, awqd)
        cw = _mv(Rk, com.expand(N, 3))
        ac = dvk + _cross(dwk, cw) + _cross(wk, _cross(wk, cw))
        body = lambda x: _mv(Rk, torch.einsum("ij,nj->ni", Il, _mtv(Rk, x)))
        F = ac * C[OFF["C_ML"] + i]
        links.append((pk, a_w, F, body(dwk) + _cross(wk, body(wk)) + _cross(pk + cw, F)))
        Rp, pp, wp, vp, dwp, dvp = Rk, pk, wk, vk, dwk, dvk
    foot = _mv(Rp, _c(C, "C_FOOT", 3, leg).expand(N, 3))
    pf, f = pp + foot, -fe3
    vf = vp + _cross(wp, foot)
    Fs, Ms, tau3 = f, _cross(pf, f), [None] * 3
    for k in (2, 1, 0):
        pk, a_w, F, Mk = links[k]
        Fs, Ms = Fs + F, Ms + Mk
        tau3[k] = (a_w * (Ms - _cross(pk, Fs))).sum(1)
    return pf, vf, torch.stack(tau3, 1), Fs, Ms


def trunk_wrench(C, b, F_legs, M_legs):
    """tau 0..5: the trunk's Newton-Euler with the legs' summed wrench
    (legdyn.cuh trunk_wrench)."""
    R, w, dw, p = b["R"], b["w"], b["dw"], b["p"]
    N = p.shape[0]
    cw = _mv(R, _c(C, "C_COMT", 3).expand(N, 3))
    It = _c(C, "C_IT", 9).reshape(3, 3)
    body = lambda x: _mv(R, torch.einsum("ij,nj->ni", It, _mtv(R, x)))
    F_t = (b["dv"] + _cross(dw, cw) + _cross(w, _cross(w, cw))) * C[OFF["C_MT"]]
    M_t = body(dw) + _cross(w, body(w)) + _cross(p + cw, F_t)
    F_tot, M_tot = F_t + F_legs, M_t + M_legs
    return torch.cat([F_tot, _mtv(b["T"], _mtv(R, M_tot - _cross(p, F_tot)))], 1)


def _rows(leg):
    return (list(range(3 * leg, 3 * leg + 3)), list(range(12 + 3 * leg, 15 + 3 * leg)),
            list(range(30 + 3 * leg, 33 + 3 * leg)))


def lane_split(X, A, Fe, dtype):
    """(prim (M, 42), J (M, 42, 54), written (42, 54) bool) by the kernel's
    lanes in ``dtype``; ``written`` marks the entries some lane writes."""
    C = layout.robot_consts(go2_spec(device="cpu")).to(dtype)
    X, A, Fe = (torch.as_tensor(t, dtype=dtype) for t in (X, A, Fe))
    M = X.shape[0]
    q, v, a = X[:, :18], X[:, 18:], A
    J = torch.zeros(M, 42, 54, dtype=dtype)
    prim = torch.zeros(M, 42, dtype=dtype)
    written = torch.zeros(42, 54, dtype=torch.bool)

    def put(rows, cols, vals):
        """vals (D*M, len(rows)), direction-major, into J[:, rows, cols[d]]."""
        vals = vals.reshape(len(cols), M, len(rows))
        for d, c in enumerate(cols):
            J[:, rows, c] = vals[d]
            written[rows, c] = True

    # base directions d: q 3..5 (columns 3..5), v 0..5 (18..23), a 0..5 (36..41)
    D = 15
    rep = lambda t: t.repeat(D, 1)
    seeds = torch.eye(18, dtype=dtype)[3:].repeat_interleave(M, 0).split(6, 1)
    trunk_in = (rep(q[:, :6]), rep(v[:, :6]), rep(a[:, :6]))
    cols = [d % 6 + 18 * (d // 6) for d in range(3, 18)]
    outs = []
    for leg in range(4):
        j = slice(6 + 3 * leg, 9 + 3 * leg)
        fn = lambda q6, v6, a6, leg=leg, j=j: leg_chain(
            C, leg, trunk_state(q6, v6, a6), rep(q[:, j]), rep(v[:, j]), rep(a[:, j]),
            rep(Fe[:, 3 * leg:3 * leg + 3]))
        outs.append(jvp(fn, trunk_in, seeds))
    # the four legs' wrenches, values and tangents: (l0 + l1) + (l2 + l3)
    F_legs, M_legs = ((outs[0][i][n] + outs[1][i][n]) + (outs[2][i][n] + outs[3][i][n])
                      for i, n in ((0, 3), (0, 4)))
    dF, dM = ((outs[0][1][n] + outs[1][1][n]) + (outs[2][1][n] + outs[3][1][n]) for n in (3, 4))
    tau6, dtau6 = jvp(lambda q6, v6, a6, F, Mm: trunk_wrench(C, trunk_state(q6, v6, a6), F, Mm),
                      (*trunk_in, F_legs, M_legs), (*seeds, dF, dM))
    for leg, ((pf, vf, tau3, _, _), (dpf, dvf, dtau3, _, _)) in enumerate(outs):
        rp, rv, rt = _rows(leg)
        put(rp, cols[:3], dpf[:3 * M])                  # along the attitude
        put(rv, cols[:9], dvf[:9 * M])                  # along the attitude and v
        put(rt, cols, dtau3)
        prim[:, rp], prim[:, rv], prim[:, rt] = pf[:M], vf[:M], tau3[:M]
        # along the base position: the foot point moves with it
        put(rp, [0, 1, 2], torch.eye(3, dtype=dtype).repeat_interleave(M, 0))
    put(list(range(24, 30)), cols, dtau6)
    prim[:, 24:30] = tau6[:M]

    # joint directions: q, v, a of leg l's joint k, column 18 kind + 6 + 3 l + k
    D = 9
    rep = lambda t: t.repeat(D, 1)
    seeds = torch.eye(D, dtype=dtype).repeat_interleave(M, 0).split(3, 1)
    b = {k: t.repeat((D,) + (1,) * (t.dim() - 1))
         for k, t in trunk_state(q[:, :6], v[:, :6], a[:, :6]).items()}
    for leg in range(4):
        j = slice(6 + 3 * leg, 9 + 3 * leg)
        (_, _, _, _, _), (dpf, dvf, dtau3, dFl, dMl) = jvp(
            lambda q3, v3, a3, leg=leg: leg_chain(C, leg, b, q3, v3, a3,
                                                  rep(Fe[:, 3 * leg:3 * leg + 3])),
            (rep(q[:, j]), rep(v[:, j]), rep(a[:, j])), seeds)
        # the trunk's motion fixed: tau 0..5 moves by this leg's wrench alone
        _, dtau6 = jvp(lambda F, Mm: trunk_wrench(C, b, F, Mm),
                       (rep(F_legs[:M]), rep(M_legs[:M])), (dFl, dMl))
        cols = [18 * kind + 6 + 3 * leg + k for kind in range(3) for k in range(3)]
        rp, rv, rt = _rows(leg)
        put(rp, cols[:3], dpf[:3 * M])
        put(rv, cols[:6], dvf[:6 * M])
        put(rt, cols, dtau3)
        put(list(range(24, 30)), cols, dtau6)
    return prim, J, written


def plain(X, A, Fe, dtype):
    t = lambda x: torch.as_tensor(x, dtype=dtype)
    return dynjac_plain(spec_in(dtype), t(X), t(A), t(Fe))


@pytest.mark.parametrize("M", [1, 7, 25])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lane_split_matches_plain(dtype, M):
    """The lanes' assembly equals jacfwd of the whole pass: float64 to
    rounding, float32 within the kernel's gate."""
    X, A, Fe = seeded_inputs(M, 100 + M)
    prim, J, _ = lane_split(X, A, Fe, DTYPES[dtype])
    pp, Jp = plain(X, A, Fe, DTYPES[dtype])
    e_p, e_J = float((prim - pp).abs().max()), float((J - Jp).abs().max())
    s_p, s_J = max(1.0, float(pp.abs().max())), float(Jp.abs().max())
    if dtype == "float64":
        assert e_p <= 1e-12 * s_p and e_J <= 1e-12 * s_J, (e_p, e_J)
    else:
        assert e_p <= 1e-5 * s_p and e_J <= 3e-5 * s_J, (e_p, e_J)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_structural_zeros_are_exact_in_plain(dtype):
    """Every structural zero of J is exactly zero in dynjac_plain (the
    kernel stores zeros there without computing them)."""
    X, A, Fe = seeded_inputs(25, 7)
    _, Jp = plain(X, A, Fe, DTYPES[dtype])
    Z = structural_zeros()
    assert int(Z.sum()) == 432 + 216 + 30 * 3 + 4 * 9 * 27 - 216 - 108
    assert bool((Jp[:, Z] == 0).all())


def test_lanes_write_every_entry_but_the_structural_zeros():
    """The lanes' write rule (the kernel's: each lane writes its column's
    rows that its direction can move) leaves exactly structural_zeros()
    unwritten."""
    X, A, Fe = seeded_inputs(1, 3)
    _, _, written = lane_split(X, A, Fe, torch.float64)
    assert torch.equal(~written, structural_zeros())
