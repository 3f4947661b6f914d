"""The identity the dyncore kernel (csrc/dyncore.cu, a leg per lane) rests
on, held through its plain twin on the CPU: torch and numpy only, no JAX
(~3 s alone).

Given the trunk's state, the four legs are independent: leg l's joint
values move only foot l's point and velocity, joint torques 6+3l..8+3l and,
through the wrench the leg puts on the trunk, tau 0..5. ``leg_split`` is
the kernel's arithmetic in numpy, one leg at a time: each leg's three-link
chain from the trunk's frame, the legs' wrenches summed (l0 + l1) + (l2 +
l3) as the lanes' two shuffle steps sum them, then the trunk's
Newton-Euler. In float64 it equals ``dyncore_plain`` to rounding; in float32
it stays within the kernel's gate, 1e-5 * max(1, |out|).
"""
import dataclasses

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch.ops import layout
from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore_plain
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

torch.set_num_threads(1)
GRAVITY = 9.81
KINDS = {"q": (0, 6), "v": (0, 24), "a": (1, 6), "fe": (2, 0)}   # (input, first column)
# offsets of the robot constants (ops/layout.robot_consts, csrc/legdyn.cuh)
OFF = {"C_JP": 0, "C_AX": 36, "C_ML": 72, "C_COM": 84, "C_IC": 120, "C_FOOT": 228,
       "C_MT": 240, "C_COMT": 241, "C_IT": 244}


def seeded_inputs(M: int, seed: int):
    """(X (M, 36), A (M, 18), Fe (M, 12)) float32 numpy: joints near the
    home pose, base attitude within ~0.3 rad, rates, accelerations and
    forces of a trot's scale."""
    spec = go2_spec(device="cpu")
    rng = np.random.default_rng(seed)
    q = spec.q_home.numpy()[None] + 0.3 * rng.standard_normal((M, 18))
    X = np.concatenate([q, rng.standard_normal((M, 18))], 1).astype(np.float32)
    A = (3.0 * rng.standard_normal((M, 18))).astype(np.float32)
    Fe = (30.0 * rng.standard_normal((M, 12))).astype(np.float32)
    return X, A, Fe


def plain(X, A, Fe, dtype=torch.float32) -> np.ndarray:
    spec = go2_spec(device="cpu")
    spec = dataclasses.replace(spec, **{
        f.name: getattr(spec, f.name).to(dtype) for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)
        and getattr(spec, f.name).is_floating_point()})
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return dyncore_plain(spec, t(X), t(A), t(Fe)).numpy()


def _cross(a, b):
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def _mv(R, x):
    return np.einsum("mij,mj->mi", R, x)


def leg_split(X, A, Fe, dtype) -> np.ndarray:
    """(M, 42) by the kernel's decomposition, in ``dtype``."""
    C = layout.robot_consts(go2_spec(device="cpu")).numpy().astype(dtype)
    X, A, Fe = X.astype(dtype), A.astype(dtype), Fe.astype(dtype)
    M = X.shape[0]
    q, v, a = X[:, :18], X[:, 18:], A
    c, s = np.cos(q[:, 3:6]), np.sin(q[:, 3:6])
    (cy, cp, cr), (sy, sp, sr) = c.T, s.T
    R = np.stack([np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], 1),
                  np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], 1),
                  np.stack([-sp, cp * sr, cp * cr], 1)], 1)
    z, one = np.zeros_like(sp), np.ones_like(sp)
    T = np.stack([np.stack([-sp, z, one], 1), np.stack([cp * sr, cr, z], 1),
                  np.stack([cp * cr, -sr, z], 1)], 1)
    pd, rd = v[:, 4], v[:, 5]
    Td = np.stack([np.stack([-cp * pd, z, z], 1),
                   np.stack([-sp * pd * sr + cp * cr * rd, -sr * rd, z], 1),
                   np.stack([-sp * pd * cr - cp * sr * rd, -cr * rd, z], 1)], 1)
    w = _mv(R, _mv(T, v[:, 3:6]))
    dw = _mv(R, _mv(Td, v[:, 3:6]) + _mv(T, a[:, 3:6]))
    p, dv = q[:, :3], a[:, :3] + np.array([0, 0, GRAVITY], dtype)
    out = np.zeros((M, 42), dtype)
    wrenches = []
    for leg in range(4):
        Rp, pp, wp, vp, dwp, dvp = R, p, w, v[:, :3], dw, dv
        links = []
        for k in range(3):
            i = 3 * leg + k
            axis, jp, com = (C[o + 3 * i:o + 3 * i + 3]
                             for o in (OFF["C_AX"], OFF["C_JP"], OFF["C_COM"]))
            Il = C[OFF["C_IC"] + 9 * i:OFF["C_IC"] + 9 * i + 9].reshape(3, 3)
            m = C[OFF["C_ML"] + i]
            K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]], dtype)
            ck, sk = np.cos(q[:, 6 + i]), np.sin(q[:, 6 + i])
            Rot = (sk[:, None, None] * K + (1 - ck)[:, None, None] * (K @ K)
                   + np.eye(3, dtype=dtype))
            a_w, off = _mv(Rp, np.broadcast_to(axis, (M, 3))), _mv(Rp, np.broadcast_to(jp, (M, 3)))
            Rk, pk = Rp @ Rot, pp + off
            vk = vp + _cross(wp, off)
            dvk = dvp + _cross(dwp, off) + _cross(wp, _cross(wp, off))
            awqd = a_w * v[:, 6 + i:7 + i]
            wk = wp + awqd
            dwk = dwp + a_w * a[:, 6 + i:7 + i] + _cross(wp, awqd)
            cw = _mv(Rk, np.broadcast_to(com, (M, 3)))
            ac = dvk + _cross(dwk, cw) + _cross(wk, _cross(wk, cw))
            body = lambda x: _mv(Rk, np.einsum("ij,mj->mi", Il, np.einsum("mji,mj->mi", Rk, x)))
            F = ac * m
            links.append((pk, a_w, F, body(dwk) + _cross(wk, body(wk)) + _cross(pk + cw, F)))
            Rp, pp, wp, vp, dwp, dvp = Rk, pk, wk, vk, dwk, dvk
        foot = _mv(Rp, np.broadcast_to(C[OFF["C_FOOT"] + 3 * leg:][:3], (M, 3)))
        p_f, f = pp + foot, -Fe[:, 3 * leg:3 * leg + 3]
        out[:, 3 * leg:3 * leg + 3] = p_f
        out[:, 12 + 3 * leg:15 + 3 * leg] = vp + _cross(wp, foot)
        Fs, Ms = f, _cross(p_f, f)
        for k in (2, 1, 0):
            pk, a_w, F, Mk = links[k]
            Fs, Ms = Fs + F, Ms + Mk
            out[:, 30 + 3 * leg + k] = (a_w * (Ms - _cross(pk, Fs))).sum(1)
        wrenches.append((Fs, Ms))
    F_legs = (wrenches[0][0] + wrenches[1][0]) + (wrenches[2][0] + wrenches[3][0])
    M_legs = (wrenches[0][1] + wrenches[1][1]) + (wrenches[2][1] + wrenches[3][1])
    cw = _mv(R, np.broadcast_to(C[OFF["C_COMT"]:][:3], (M, 3)))
    It = C[OFF["C_IT"]:OFF["C_IT"] + 9].reshape(3, 3)
    body = lambda x: _mv(R, np.einsum("ij,mj->mi", It, np.einsum("mji,mj->mi", R, x)))
    F_t = (dv + _cross(dw, cw) + _cross(w, _cross(w, cw))) * C[OFF["C_MT"]]
    M_t = body(dw) + _cross(w, body(w)) + _cross(p + cw, F_t)
    F_tot, M_tot = F_t + F_legs, M_t + M_legs
    n_l = np.einsum("mji,mj->mi", R, M_tot - _cross(p, F_tot))
    out[:, 24:27] = F_tot
    out[:, 27:30] = np.einsum("mji,mj->mi", T, n_l)
    return out


def leg_rows(leg: int) -> list:
    """Output columns of leg ``leg``: foot point, foot velocity, joint torques."""
    return [*range(3 * leg, 3 * leg + 3), *range(12 + 3 * leg, 15 + 3 * leg),
            *range(30 + 3 * leg, 33 + 3 * leg)]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("leg", range(4))
def test_a_leg_moves_only_its_rows_and_the_trunk(leg, kind):
    """Leg ``leg``'s q, v, a or fe moves only its nine output columns and
    tau 0..5, and moves them: the other legs' columns are bit for bit the
    same."""
    args = list(seeded_inputs(52, 3))
    base = plain(*args)
    which, col = KINDS[kind]
    moved = [a.copy() for a in args]
    rng = np.random.default_rng(leg)
    moved[which][:, col + 3 * leg:col + 3 * leg + 3] += (
        0.2 * rng.standard_normal((52, 3))).astype(np.float32)
    d = np.abs(plain(*moved) - base).max(0)
    mine = set(leg_rows(leg)) | set(range(24, 30))
    others = [c for c in range(42) if c not in mine]
    assert (d[others] == 0).all(), [c for c in others if d[c] != 0]
    # the joint torques and the base wrench always move; a force moves no
    # kinematics, a rate no foot point, an acceleration neither
    assert (d[30 + 3 * leg:33 + 3 * leg] > 0).all() and (d[24:30] > 0).any()
    assert (d[3 * leg:3 * leg + 3] > 0).all() == (kind == "q")
    assert (d[12 + 3 * leg:15 + 3 * leg] > 0).all() == (kind in ("q", "v"))


@pytest.mark.parametrize("M", [1, 7, 52])
def test_leg_split_equals_the_plain_twin(M):
    """At ragged M the plain twin is finite, of shape (M, 42), each row
    what it is alone, and equal to the leg split: to rounding in float64,
    within the kernel's gate in float32."""
    X, A, Fe = seeded_inputs(M, M)
    out = plain(X, A, Fe)
    assert out.shape == (M, 42) and np.isfinite(out).all()
    rows = np.concatenate([plain(X[i:i + 1], A[i:i + 1], Fe[i:i + 1]) for i in range(M)])
    np.testing.assert_allclose(out, rows, rtol=0, atol=1e-6 * max(1.0, np.abs(out).max()))
    ref64 = plain(X, A, Fe, torch.float64)
    np.testing.assert_allclose(leg_split(X, A, Fe, np.float64), ref64, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(ref64).max()))
    gate = 1e-5 * max(1.0, np.abs(out).max())
    assert np.abs(leg_split(X, A, Fe, np.float32) - out).max() <= gate


def test_robot_consts_are_kept_until_the_spec_changes():
    """The kernel wrappers' constants (layout.cached_robot_consts): built
    once per spec and device, refilled in the same buffer after a field they
    read changes in place."""
    spec, cpu = go2_spec(device="cpu"), torch.device("cpu")
    first = layout.cached_robot_consts(spec, cpu)
    assert layout.cached_robot_consts(spec, cpu) is first
    assert layout.cached_robot_consts(spec.to(cpu), cpu) is first      # the same tensors
    stale = first.clone()
    spec.inertia[7, 0, 0] += 1.0
    again = layout.cached_robot_consts(spec, cpu)
    assert again is first and torch.equal(again, layout.robot_consts(spec))
    assert not torch.equal(again, stale)
