"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``cuda``: skipped where no CUDA device is present. This file imports
no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Inputs: the golden converged flagship trajectory (Go2 trot, N=25, and
N=100 for the long-horizon route) for B problems, with the initial state
moved by 1 cm-scale noise (lingram: gradient blocks far from zero; also
the stress cases of tests/test_torch_lingram_structure.py) or the
interior states by 5e-4 (riccati: a well-conditioned fp32 step, as in the
steady RTI regime); for dynjac also the seeded states of
tests/test_torch_dyncore_legs.py at M = 1, 25, 12,800, with the structural
zeros of J held exact; kernels 1, 2, 3 and 7 also at Solo12's constants
(its standing problem, converged) and kernel 2 with the contacts
restricted (``restrict`` = 1, footsteps and patches); for policy_pd and policy_pd_bf16 the shipped
policy's folded weights (and seeded nets up to 3 x 1024) and seeded normal
inputs, kernel 8's shipped-net output held bit for bit to
tests/data/go2_trot_policy_pd_kernel_golden.npz; for the node solves the
random blocks of scripts/proto_sublane_riccati.py (Quu = G G^T + 3 I), the
warp mapping also held to that script's own node solve
(tests/data/node_solve_sublane_golden.npz).
Without a card every test here skips: ~3.5 s of collection and no worker
time, the kernel 7 and 3 x 1024 cases included.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from iterative_learning_nmpc_tpu_torch import flagship as F
from iterative_learning_nmpc_tpu_torch.interop import random_policy_payload
from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore, dyncore_plain
from iterative_learning_nmpc_tpu_torch.ops.dynjac import dynjac, dynjac_plain, structural_zeros
from iterative_learning_nmpc_tpu_torch.ops.lingram import (
    ROW_GROUPS, _double, gate_failures, gram_gate, lingram, lingram_plain)
from iterative_learning_nmpc_tpu_torch.ops import probes
from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
    bf16_kernel_attributes, fold_batchnorm, make_fused_policy_pd, policy_pd, policy_pd_bf16,
    policy_pd_bf16_plain, policy_pd_plain)
from iterative_learning_nmpc_tpu_torch.ops.riccati import (
    forward_rollout, forward_rollout_plain, riccati_rollout, riccati_rollout_plain,
    riccati_sweep, riccati_sweep_plain, riccati_sweep_terminal,
    riccati_sweep_terminal_plain, terminal_gram)

from test_torch_dyncore_legs import seeded_inputs
from test_torch_lingram_structure import go2_solver, stress_case
from test_torch_riccati_stage import BACKWARD_GATE, H_STEP, backward_error, near_floor_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "go2_trot_n25_golden.npz")
GOLDEN_N100 = os.path.join(ROOT, "tests", "data", "go2_trot_n100_golden.npz")
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
GOLDEN_PD = os.path.join(ROOT, "tests", "data", "go2_trot_policy_pd_kernel_golden.npz")
GOLDEN_SUBLANE = os.path.join(ROOT, "tests", "data", "node_solve_sublane_golden.npz")
B = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    solver, _, _, params = F.flagship(device=dev)
    g = np.load(GOLDEN)
    X = torch.as_tensor(g["X_conv"], device=dev)[None]
    U = torch.as_tensor(g["U_conv"], device=dev)[None]
    params = params.replace(lam_ineq=torch.as_tensor(g["lam_ineq_conv"], device=dev)[None])
    return solver, X, U, params


def _max_rel(a, b):
    return float(((a - b).abs() / (1.0 + b.abs())).max())


@pytest.mark.cuda
def test_dyncore_kernel_matches_plain(card):
    solver, X, U, p = card
    Xb, Ub, _ = F.perturbed_batch(X, U, p, B, seed=1)
    M = B * solver.N
    Xm = Xb[:, :-1].reshape(M, 36).contiguous()
    Am = Ub[..., :18].reshape(M, 18).contiguous()
    Fm = Ub[..., 18:].reshape(M, 12).contiguous()
    n0 = dyncore.launches
    out_k, out_p = dyncore(solver.spec, Xm, Am, Fm), dyncore_plain(solver.spec, Xm, Am, Fm)
    assert dyncore.launches == n0 + 1
    # fp32 reassociation: 1e-5 of the output scale
    assert float((out_k - out_p).abs().max()) <= 1e-5 * max(1.0, float(out_p.abs().max()))


def _dyncore_rows(card, M):
    """M evaluations of the line-search candidates' layout
    (linearize.dyncore_inputs) from perturbed copies of the golden."""
    from iterative_learning_nmpc_tpu_torch.solver.linearize import dyncore_inputs

    solver, X, U, p = card
    L = -(-M // (solver.N + 1))
    rows = dyncore_inputs(*F.perturbed_batch(X, U, p, L, seed=4))
    return solver.spec, *(r[:M].contiguous() for r in rows)


def _dyncore_check(spec, X, A, Fe):
    n0 = dyncore.launches
    out_k = dyncore(spec, X, A, Fe)
    assert dyncore.launches == n0 + 1
    out_p = dyncore_plain(spec, X, A, Fe)
    assert out_k.shape == out_p.shape == (X.shape[0], 42)
    assert float((out_k - out_p).abs().max()) <= 1e-5 * max(1.0, float(out_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 7, 52, 13312, 26627])
def test_dyncore_kernel_shapes(card, M):
    """Within 1e-5 of the output scale at the replan's M = 52, datagen's
    13,312 and ragged edges: a block takes 64 evaluations, a warp 8, so M =
    1, 7 and 26,627 leave part of a warp and of a block empty."""
    _dyncore_check(*_dyncore_rows(card, M))


@pytest.mark.cuda
def test_dyncore_kernel_takes_unaligned_views(card):
    """Rows whose first float is not 16-byte aligned (contiguous views at 4,
    8 and 12 bytes into their storage) take the kernel's 4-byte staging."""
    spec, *rows = _dyncore_rows(card, 300)
    views = []
    for r, off in zip(rows, (1, 2, 3)):
        flat = torch.empty(r.numel() + off, dtype=r.dtype, device=r.device)
        v = flat[off:].view(r.shape)
        v.copy_(r)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4 * off
        views.append(v)
    _dyncore_check(spec, *views)


@pytest.mark.cuda
def test_dyncore_kernel_attributes(card):
    """No local memory (every per-thread index static), and at least two
    256-thread blocks resident an SM."""
    from iterative_learning_nmpc_tpu_torch.ops.dyncore import kernel_attributes

    regs, local, blocks = kernel_attributes()["dyncore_kernel"]
    assert local == 0 and blocks >= 2, (regs, local, blocks)


@pytest.fixture(scope="module")
def lingram_cases(card):
    """(solver, X, U, p) cases of the lingram kernel: the golden trajectory
    perturbed (B=3, N=25), and tests/test_torch_lingram_structure.py's
    stress cases (every row group active, hinges at their ties) at B=2,
    N=100 and at B*N = 25 and 100, which leave a ragged last block in the
    rows kernel (7 nodes a block) and the Gram kernel (2)."""
    solver, X, U, p = card
    out = [(solver, *F.perturbed_batch(X, U, p, B, seed=2))]
    for n_nodes, b, seed in ((100, 2, 7), (25, 1, 8), (100, 1, 9)):
        s = go2_solver(n_nodes, device=torch.device("cuda"))
        out.append((s, *stress_case(s, b, seed)))
    return out


@pytest.mark.cuda
def test_lingram_kernel_matches_plain(lingram_cases):
    """Per part of each block within tests/test_fast_linearize.py's Gram
    bound, 3e-4 * max(1, |part|), with every row group on and with each row
    group alone (ops.lingram.gram_gate), for both include_torque values."""
    for solver, Xb, Ub, pb in lingram_cases:
        for inc in (True, False):
            n0 = lingram.launches
            out = lingram(solver.spec, solver.weights, Xb, Ub, pb, inc)
            assert lingram.launches == n0 + 1
            assert [tuple(o.shape) for o in out] == [
                tuple(o.shape) for o in lingram_plain(solver.spec, solver.weights, Xb, Ub, pb,
                                                      inc)]
            bad = gate_failures(gram_gate(lingram, solver.spec, solver.weights, Xb, Ub, pb,
                                          inc))
            assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("group", list(ROW_GROUPS))
def test_lingram_gate_rejects_kernel_without_a_row_group(lingram_cases, group):
    """The gate sees each row group of the kernel's output: the kernel run
    with one group's weights at 0 (for the cone, the output of a kernel
    whose closed-form cone blocks are zero) fails the check of that group
    alone, at the stress case B=1, N=25."""
    solver, Xb, Ub, pb = lingram_cases[2]

    def without(spec, w, X, U, p, inc):
        return lingram(spec, dataclasses.replace(w, **{
            f: torch.zeros_like(getattr(w, f)) for f in ROW_GROUPS[group]}), X, U, p, inc)

    assert gate_failures(gram_gate(without, solver.spec, solver.weights, Xb, Ub, pb, True,
                                   labels=(group,)))


@pytest.mark.cuda
def test_riccati_kernel_matches_plain(card):
    solver, X, U, p = card
    gen = torch.Generator().manual_seed(3)
    Xb = X.repeat(B, 1, 1)
    Xb[:, 1:] += 5e-4 * torch.randn(Xb[:, 1:].shape, generator=gen).to(X.device)
    Ub = U.repeat(B, 1, 1)
    pb = p.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
    blocks = lingram(solver.spec, solver.weights, Xb, Ub, pb)
    args = (solver.spec, solver.weights, solver.dt_nodes, float(solver.opt.lm_reg),
            float(solver.cost.reg_eps_e), *blocks, solver._defects(Xb, Ub, pb),
            pb.x0 - Xb[:, 0], Xb[:, -1], pb.peak[:, :, -1], pb.base_ref_e,
            pb.joint_ref, pb.step_height)
    for a, b in zip(riccati_rollout(*args), riccati_rollout_plain(*args)):
        assert _max_rel(a, b) <= 1e-3       # the bench's rel |dU| gate


@pytest.mark.cuda
def test_dynjac_kernel_matches_plain(card):
    """The controller's shape: one problem's N=25 nodes, plus B=3."""
    solver, X, U, p = card
    for b in (1, B):
        Xb, Ub, pb = F.perturbed_batch(X, U, p, b, seed=4)
        M = b * solver.N
        cnt = pb.cnt[:, :, :-1].transpose(1, 2).reshape(M, 4, 1)
        args = (Xb[:, :-1].reshape(M, 36).contiguous(), Ub[..., :18].reshape(M, 18).contiguous(),
                (cnt * Ub[..., 18:].reshape(M, 4, 3)).reshape(M, 12).contiguous())
        n0 = dynjac.launches
        (pk, Jk), (pp, Jp) = dynjac(solver.spec, *args), dynjac_plain(solver.spec, *args)
        assert dynjac.launches == n0 + 1
        assert Jk.shape == (M, 42, 54)
        # tests/test_dynjac_kernel.py's bounds against the jacfwd oracle
        assert float((pk - pp).abs().max()) <= 1e-5 * max(1.0, float(pp.abs().max()))
        assert float((Jk - Jp).abs().max()) <= 3e-5 * float(Jp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 25, 12800])
def test_dynjac_kernel_shapes_and_structural_zeros(card, M):
    """Kernel 7 (a (direction, leg) pair per lane) at one evaluation, the
    controller's M=25 and chip_smoke.py's stress shape, on seeded states of
    a trot's scale: within tests/test_dynjac_kernel.py's bounds, and every
    structural zero of J stored as an exact zero (as the twin has it)."""
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in seeded_inputs(M, M)]
    spec = card[0].spec
    n0 = dynjac.launches
    (pk, Jk), (pp, Jp) = dynjac(spec, *args), dynjac_plain(spec, *args)
    torch.cuda.synchronize()
    assert dynjac.launches == n0 + 1
    assert pk.shape == (M, 42) and Jk.shape == (M, 42, 54)
    assert float((pk - pp).abs().max()) <= 1e-5 * max(1.0, float(pp.abs().max()))
    assert float((Jk - Jp).abs().max()) <= 3e-5 * float(Jp.abs().max())
    Z = structural_zeros().to(dev)
    assert bool((Jk[:, Z] == 0).all()) and bool((Jp[:, Z] == 0).all())


@pytest.mark.cuda
def test_dynjac_kernel_attributes(card):
    """No local memory and no spills (every per-thread index static)."""
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.dynjac import kernel_attributes

    report = _build.ptxas_report(_build.CSRC / "dynjac.cu")
    assert {k: v[1:] for k, v in report.items()} == {"dynjac_kernel": (0, 0, 0)}, report
    regs, local, blocks = kernel_attributes()["dynjac_kernel"]
    assert local == 0 and blocks >= 1, (regs, local, blocks)


@pytest.fixture(scope="module")
def solo12_case(card):
    """Solo12's standing problem (about a sixth of Go2's mass, calf
    inertias of 3.2e-6), converged in 15 iterations, then B problems with
    1 cm-scale noise on the initial state."""
    solver, X, U, params = F.flagship(device=torch.device("cuda"), robot="solo12")
    conv = solver.solve(X, U, params, 15)
    p = params.replace(lam_ineq=conv.lam_ineq)
    return (solver, conv.X, conv.U, p, *F.perturbed_batch(conv.X, conv.U, p, B, seed=5))


@pytest.mark.cuda
def test_kernels_at_solo12_constants(solo12_case):
    """Kernels 1, 2, 3 and 7 within their Go2 bounds at Solo12's robot
    constants: lingram by gram_gate, the fused Riccati by the bench's gate,
    dyncore by 1e-5 of its scale, dynjac by tests/test_dynjac_kernel.py's
    bounds with its structural zeros exact."""
    solver, X1, U1, p1, Xb, Ub, pb = solo12_case
    spec, w = solver.spec, solver.weights
    assert spec.name == "solo12"
    assert not gate_failures(gram_gate(lingram, spec, w, Xb, Ub, pb, True))
    args = (spec, w, solver.dt_nodes, float(solver.opt.lm_reg), float(solver.cost.reg_eps_e),
            *lingram(spec, w, Xb, Ub, pb), solver._defects(Xb, Ub, pb), pb.x0 - Xb[:, 0],
            Xb[:, -1], pb.peak[:, :, -1], pb.base_ref_e, pb.joint_ref, pb.step_height)
    # the bench's gate, or, where the fp32 twin is itself further than it
    # from the float64 step on the same blocks (Solo12's lighter links), the
    # sweep kernels' rule: no further from the float64 step than twice the
    # fp32 twin
    k, tw = riccati_rollout(*args), riccati_rollout_plain(*args)
    ref = riccati_rollout_plain(_double(spec), _double(w), *(
        t.double() if isinstance(t, torch.Tensor) else t for t in args[2:]))
    r_k, r_p = (max(_max_rel(a.double(), b) for a, b in zip(o, ref)) for o in (k, tw))
    assert max(_max_rel(a, b) for a, b in zip(k, tw)) <= 1e-3 or r_k <= 2.0 * r_p + 1e-4
    M = B * solver.N
    rows = (Xb[:, :-1].reshape(M, 36).contiguous(), Ub[..., :18].reshape(M, 18).contiguous(),
            Ub[..., 18:].reshape(M, 12).contiguous())
    _dyncore_check(spec, *rows)
    cnt = p1.cnt[:, :, :-1].transpose(1, 2).reshape(solver.N, 4, 1)
    args = (X1[:, :-1].reshape(-1, 36).contiguous(), U1[..., :18].reshape(-1, 18).contiguous(),
            (cnt * U1[..., 18:].reshape(-1, 4, 3)).reshape(-1, 12).contiguous())
    (pk, Jk), (pp, Jp) = dynjac(spec, *args), dynjac_plain(spec, *args)
    assert float((pk - pp).abs().max()) <= 1e-5 * max(1.0, float(pp.abs().max()))
    assert float((Jk - Jp).abs().max()) <= 3e-5 * float(Jp.abs().max())
    assert bool((Jk[:, structural_zeros().to(Jk.device)] == 0).all())


@pytest.mark.cuda
def test_lingram_kernel_at_restrict(card):
    """Kernel 2 with the contacts restricted (``restrict`` = 1): footsteps
    5 cm ahead of the standing feet, a 3 cm patch radius on half the
    problems (the hinge active) and the controller's 1e3 on the rest, with
    every row group on and each alone; the foot-displacement and patch
    groups are not zero."""
    solver, X, U, p = card
    Xb, Ub, pb = F.perturbed_batch(X, U, p, 4, seed=6)
    from iterative_learning_nmpc_tpu_torch.models.dynamics import foot_positions

    loc = foot_positions(solver.spec, Xb[:, 0, :18]).clone()
    loc[..., 0] += 0.05
    loc[..., 2] = 0.0085
    cnt_loc = loc[:, :, None, :].expand(-1, -1, solver.N + 1, -1).contiguous()
    radius = pb.patch_radius.clone()
    radius[:2] = 0.03
    pb = pb.replace(cnt_loc=cnt_loc, patch_radius=radius, restrict=torch.ones_like(pb.restrict))
    spec, w = solver.spec, solver.weights
    gate = gram_gate(lingram, spec, w, Xb, Ub, pb, True)
    assert not gate_failures(gate)
    for group in ("foot_disp", "patch"):
        assert max(row[2] for row in gate[group]) > 3e-4, group     # a part's bound > the floor


@pytest.mark.cuda
def test_entry_points_default_to_the_card(card):
    """Called without a device, the entry points put their tensors on the
    CUDA card."""
    from iterative_learning_nmpc_tpu_torch.interop import sim_state_from_numpy
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    solver, X, U, params = F.flagship()
    assert solver.device.type == "cuda"
    assert X.is_cuda and U.is_cuda and params.x0.is_cuda and solver.spec.mass.is_cuda
    spec = go2_spec()
    assert spec.mass.is_cuda
    mpc = LocomotionMPC(spec)
    try:
        assert mpc.device.type == "cuda" and mpc.solver.weights.base.is_cuda
    finally:
        mpc.close()
    assert device_sim.contact_params_for(spec).stiffness.is_cuda
    assert sim_state_from_numpy(np.zeros(18), np.zeros(18)).q.is_cuda


def _shipped_layers():
    import pickle

    with open(ARTIFACT, "rb") as f:
        return fold_batchnorm(pickle.load(f)["variables"])


def _random_layers(h, seed):
    """A seeded 47 -> h x3 -> 12 policy in the Flax layout (Dense + BatchNorm
    with random running statistics), folded as the shipped one is."""
    return fold_batchnorm(random_policy_payload(3, h, seed)["variables"])


def _policy_layers(width, dev):
    """The shipped 47 -> 512x3 -> 12 policy, or a seeded one at hidden width
    256 (the JAX network's default), 132 (a multiple of 4 but not of 8 or
    32: ragged column slices, the last one empty) or 1024 (the wide layout:
    16 rows a cluster, 128-column slices)."""
    layers = _shipped_layers() if width == 512 else _random_layers(width, width)
    return [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev)) for W, b in layers]


# one row, one cluster of 32 rows and the partial ones on each side of it,
# the datagen batch and past it, B on each side of one wave (the 15
# clusters an H100 SXM holds at once), a ragged batch and the largest bench
# batch
PD_BATCHES = [1, 31, 32, 33, 256, 257, 480, 481, 1000, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [512, 256, 132, 1024])
@pytest.mark.parametrize("B", PD_BATCHES)
def test_policy_pd_kernel_matches_plain(card, B, width):
    """Kernel 8 in one launch, at every edge of its cluster layouts (32
    rows a cluster up to 512 hidden units, 16 at 1024)."""
    dev = torch.device("cuda")
    layers = _policy_layers(width, dev)
    gen = torch.Generator().manual_seed(B)
    x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
    n0 = policy_pd.launches
    (ak, tk), (ap, tp) = policy_pd(layers, 20.0, 1.5, x, qj, vj), policy_pd_plain(
        layers, 20.0, 1.5, x, qj, vj)
    torch.cuda.synchronize()
    assert policy_pd.launches == n0 + 1
    # fp32 sums over K = 512 in another order: tests/test_policy_kernel.py's
    # bounds, tau scaled by kp
    torch.testing.assert_close(ak, ap, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tk, tp, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [33, 256])
def test_policy_pd_kernel_bit_equal_to_golden(card, B):
    """The shipped net's layout (hidden widths <= 512) gives, bit for bit,
    the output kernel 8 gave before it took wider nets
    (tests/data/go2_trot_policy_pd_kernel_golden.npz, recorded on the card by
    scripts/make_torch_policy_pd_golden.py from that kernel)."""
    dev = torch.device("cuda")
    g = np.load(GOLDEN_PD)
    x, qj, vj = (torch.as_tensor(g[f"{k}_{B}"], device=dev) for k in ("x", "qj", "vj"))
    ak, tk = policy_pd(_policy_layers(512, dev), 20.0, 1.5, x, qj, vj)
    assert torch.equal(ak.cpu(), torch.as_tensor(g[f"act_{B}"]))
    assert torch.equal(tk.cpu(), torch.as_tensor(g[f"tau_{B}"]))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [15, 17, 4096])
def test_policy_pd_factory_serves_1024_wide_nets(card, B):
    """Kernel 8's wide layout (hidden widths 513..1024: 16 rows a cluster,
    128-column slices, 64-row chunks) at a 3 x 1024 net through the fp32
    factory, one launch, against the addmm chain in float64 within kernel
    8's bounds."""
    dev = torch.device("cuda")
    layers = _policy_layers(1024, dev)
    fn = make_fused_policy_pd(layers, 20.0, 1.5, device=dev)
    gen = torch.Generator().manual_seed(B)
    x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
    n0 = policy_pd.launches
    ak, tk = fn(x, qj, vj)
    torch.cuda.synchronize()
    assert policy_pd.launches == n0 + 1
    ap, tp = policy_pd_plain([(W.double(), b.double()) for W, b in layers], 20.0, 1.5,
                             x.double(), qj.double(), vj.double())
    torch.testing.assert_close(ak.double(), ap, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tk.double(), tp, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [33, 256])
def test_policy_pd_factory_serves_uneven_widths(card, B):
    """The fp32 factory at hidden widths (130, 98, 250), which kernel 8
    refuses as they are: padded with zeros to (132, 100, 252), one launch,
    held to the unpadded twin within kernel 8's bounds."""
    dev = torch.device("cuda")
    layers = fold_batchnorm(random_policy_payload(3, (130, 98, 250), 478)["variables"])
    fn = make_fused_policy_pd(layers, 20.0, 1.5, device=dev)
    gen = torch.Generator().manual_seed(B)
    x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
    n0 = policy_pd.launches
    ak, tk = fn(x, qj, vj)
    torch.cuda.synchronize()
    assert policy_pd.launches == n0 + 1
    ref = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev)) for W, b in layers]
    ap, tp = policy_pd_plain(ref, 20.0, 1.5, x, qj, vj)
    torch.testing.assert_close(ak, ap, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tk, tp, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [33, 257, 1000])
def test_policy_pd_kernel_writes_no_row_past_B(card, B):
    """act and tau as views of larger canary-filled buffers: rows past B
    (a partial cluster's) are never written."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    dev = torch.device("cuda")
    layers = _policy_layers(512, dev)
    gen = torch.Generator().manual_seed(B)
    x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
    dims = [47, 512, 512, 512, 12]
    canary = -12345.0
    act_buf, tau_buf = (torch.full((B + 64, 12), canary, device=dev) for _ in range(2))
    err = _build.library().policy_pd_launch(
        x.data_ptr(), qj.data_ptr(), vj.data_ptr(), *[t.data_ptr() for l in layers for t in l],
        act_buf.data_ptr(), tau_buf.data_ptr(), B, *dims, 20.0, 1.5,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "policy_pd_launch")
    torch.cuda.synchronize()
    assert bool((act_buf[B:] == canary).all() and (tau_buf[B:] == canary).all())
    ap, tp = policy_pd_plain(layers, 20.0, 1.5, x, qj, vj)
    torch.testing.assert_close(act_buf[:B], ap, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tau_buf[:B], tp, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
def test_policy_pd_kernel_refuses_what_it_cannot_take(card):
    """The narrower contract raises ValueError, never a fallback: hidden
    widths past 1024 (8 slices of 128), n_out past 64, and an input so wide
    that the block's shared memory passes the card's limit."""
    dev = torch.device("cuda")
    for dims in ((47, 1028, 512, 512, 12), (47, 512, 512, 1028, 12), (47, 512, 512, 512, 68),
                 (600, 512, 512, 512, 12), (1100, 1024, 1024, 1024, 12)):
        layers = [(torch.zeros(dims[i], dims[i + 1], device=dev), torch.zeros(dims[i + 1],
                                                                               device=dev))
                  for i in range(4)]
        x = torch.zeros(4, dims[0], device=dev)
        qj = torch.zeros(4, dims[-1], device=dev)
        with pytest.raises(ValueError):
            policy_pd(layers, 20.0, 1.5, x, qj, qj)


@pytest.mark.cuda
def test_policy_pd_kernel_attributes(card):
    """No spills in either layout's instance (nvcc -Xptxas -v), and the
    layouts the design states: at the shipped widths 32 rows a cluster, at
    3 x 1024 16; one block a SM (more than half the opt-in shared memory of
    an H100) and at least 15 clusters of 8 blocks resident at once."""
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import kernel_attributes

    report = _build.ptxas_report(_build.CSRC / "policy_pd.cu")
    assert {k: v[2:] for k, v in report.items()} == {
        "policy_pd_kernel<32,64,128>": (0, 0), "policy_pd_kernel<16,128,64>": (0, 0)}, report
    for h, rows in ((512, 32), (1024, 16)):
        at = kernel_attributes((47, h, h, h, 12), torch.device("cuda"))
        assert at["local_bytes"] == 0 and at["dynamic_smem"] > 232448 // 2, at
        assert at["max_active_clusters"] >= 15 and at["rows_per_cluster"] == rows, at


@pytest.mark.cuda
def test_policy_rollout_defaults_to_the_card(card):
    from iterative_learning_nmpc_tpu_torch.learning.network import load_policy
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    net, norm = load_policy(ARTIFACT)
    assert next(net.parameters()).is_cuda and norm[0].is_cuda
    spec = go2_spec(device="cpu")
    q0 = spec.q_home.numpy()[None]
    n0 = policy_pd.launches
    Q, V, fell = device_sim.make_batched_policy_rollout(spec, (net, norm), 3)(
        q0, np.zeros((1, 18), np.float32), np.array([[0.3, 0.0, 0.0]], np.float32))
    assert Q.is_cuda and V.is_cuda and fell.is_cuda and Q.shape == (1, 3, 18)
    assert policy_pd.launches == n0 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_hidden, width", [(4, 256)])
def test_served_policy_takes_the_dense_route_for_other_shapes(card, n_hidden, width):
    """A net kernel 8 does not take (4 hidden layers of 256, the JAX
    network's class default), loaded as a payload and served on the card:
    route "dense", one policy_pd_dense call and no kernel 8 launch a step,
    and the addmm chain's result in float64 to kernel 8's bounds. (3 x 1024
    took this route until kernel 8 took hidden widths up to 1024.)"""
    from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy
    from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd_dense

    dev = torch.device("cuda")
    payload = random_policy_payload(n_hidden, width, width)
    served = ServedPolicy(*policy_from_numpy(payload, device=dev), device=dev)
    assert served.route == "dense"
    gen = torch.Generator().manual_seed(width)
    s44, goal, qj, vj = (torch.randn(256, n, generator=gen).to(dev) for n in (44, 3, 12, 12))
    n_kernel, n_dense = policy_pd.launches, policy_pd_dense.calls
    act, tau = served(s44, goal, qj, vj, 20.0, 1.5)
    torch.cuda.synchronize()
    assert (policy_pd.launches, policy_pd_dense.calls) == (n_kernel, n_dense + 1)
    ap, tp = policy_pd_plain([(W.double(), b.double()) for W, b in served.layers], 20.0, 1.5,
                             served.normalize(s44, goal).double(), qj.double(), vj.double())
    torch.testing.assert_close(act.double(), ap, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tau.double(), tp, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
def test_served_policy_takes_the_kernel_for_1024_wide_nets(card):
    """A 3 x 1024 payload served on the card: route "kernel", one kernel 8
    launch a step and no dense call, within kernel 8's bounds of the addmm
    chain in float64."""
    from iterative_learning_nmpc_tpu_torch.interop import policy_from_numpy
    from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd_dense

    dev = torch.device("cuda")
    served = ServedPolicy(*policy_from_numpy(random_policy_payload(3, 1024, 1024), device=dev),
                          device=dev)
    assert served.route == "kernel"
    gen = torch.Generator().manual_seed(1024)
    s44, goal, qj, vj = (torch.randn(256, n, generator=gen).to(dev) for n in (44, 3, 12, 12))
    n_kernel, n_dense = policy_pd.launches, policy_pd_dense.calls
    act, tau = served(s44, goal, qj, vj, 20.0, 1.5)
    torch.cuda.synchronize()
    assert (policy_pd.launches, policy_pd_dense.calls) == (n_kernel + 1, n_dense)
    ap, tp = policy_pd_plain([(W.double(), b.double()) for W, b in served.layers], 20.0, 1.5,
                             served.normalize(s44, goal).double(), qj.double(), vj.double())
    torch.testing.assert_close(act.double(), ap, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(tau.double(), tp, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
def test_served_policy_keeps_the_kernel_for_the_shipped_payload(card):
    """The shipped 47 -> 512x3 -> 12 payload: route "kernel", one kernel 8
    launch a step and no dense call."""
    from iterative_learning_nmpc_tpu_torch.learning.network import ServedPolicy, load_policy
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import policy_pd_dense

    dev = torch.device("cuda")
    served = ServedPolicy(*load_policy(ARTIFACT, device=dev), device=dev)
    assert served.route == "kernel"
    gen = torch.Generator().manual_seed(0)
    s44, goal, qj, vj = (torch.randn(256, n, generator=gen).to(dev) for n in (44, 3, 12, 12))
    n_kernel, n_dense = policy_pd.launches, policy_pd_dense.calls
    served(s44, goal, qj, vj, 20.0, 1.5)
    torch.cuda.synchronize()
    assert (policy_pd.launches, policy_pd_dense.calls) == (n_kernel + 1, n_dense)


@pytest.fixture(scope="module")
def horizons(card):
    """N -> (solver, X, U, params) at the golden converged points of N=25 and
    N=100 (one problem)."""
    dev = torch.device("cuda")
    out = {25: card}
    solver, _, _, params = F.flagship(device=dev, n_nodes=100)
    g = np.load(GOLDEN_N100)
    out[100] = (solver, torch.as_tensor(g["X_conv"], device=dev)[None],
                torch.as_tensor(g["U_conv"], device=dev)[None],
                params.replace(lam_ineq=torch.as_tensor(g["lam_ineq_conv"], device=dev)[None]))
    return out


def _sweep_inputs(solver, X, U, p, B, seed, n=None):
    """B copies with the interior states moved by 5e-4: the sweeps'
    arguments (spec, w, h, lm, reg_e, Q, R, M, qx, ru, defects), the
    terminal inputs and dx0; with ``n``, the horizon cut to its first n
    nodes (terminal state X[:, n])."""
    gen = torch.Generator().manual_seed(seed)
    Xb = X.repeat(B, 1, 1)
    Xb[:, 1:] += 5e-4 * torch.randn(Xb[:, 1:].shape, generator=gen).to(X.device)
    Ub = U.repeat(B, 1, 1)
    pb = p.map(lambda t: t.expand((B,) + t.shape[1:]).contiguous())
    blocks = lingram(solver.spec, solver.weights, Xb, Ub, pb)
    defects = solver._defects(Xb, Ub, pb)
    n = solver.N if n is None else n
    args = (solver.spec, solver.weights, solver.dt_nodes, float(solver.opt.lm_reg),
            float(solver.cost.reg_eps_e),
            *(x[:, :n].contiguous() for x in (*blocks, defects)))
    term = (Xb[:, n].contiguous(), pb.peak[:, :, n].contiguous(), pb.base_ref_e,
            pb.joint_ref, pb.step_height)
    return args, term, pb.x0 - Xb[:, 0]


def _assert_same_step(gains_k, gains_p, gains64, h, defects, dx0):
    """fp32 gains are ill-conditioned near the end of a horizon (one ulp of
    noise on the GN blocks moves K by a few 1e-3 of its scale, and two fp32
    sweeps of 256 problems give steps up to 1e-2 apart): the gains within
    1e-2 of their scale of the twin's, and the step they give (the rollout
    in float64) no further from the float64 sweep's step than twice the
    fp32 twin's, plus 1e-4."""
    for a, b in ((gains_k[..., :36], gains_p[..., :36]), (gains_k[..., 36], gains_p[..., 36])):
        assert float((a - b).abs().max()) <= 1e-2 * max(1.0, float(b.abs().max()))

    def step(g):
        return forward_rollout_plain(h, g.double(), defects.double(), dx0.double())

    ref = step(gains64)
    r_k, r_p = (max(_max_rel(a, b) for a, b in zip(step(g), ref)) for g in (gains_k, gains_p))
    assert r_k <= 2.0 * r_p + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 256])
@pytest.mark.parametrize("N", [1, 25, 89, 100])
def test_riccati_sweep_kernels_match_plain(horizons, N, B):
    """Kernels 4 (terminal Gram + sweep), 6 (sweep from P_N) and 5 (rollout)
    against their twins, on the N=25 golden horizon and on the N=100 one cut
    to its first N nodes (one node; one past the fused route's 88; the
    whole)."""
    solver, X, U, p = horizons[25 if N == 25 else 100]
    args, term, dx0 = _sweep_inputs(solver, X, U, p, B, seed=N + B, n=N)
    spec, w, h, lm, reg = args[:5]
    blocks, defects = args[5:10], args[10]
    n4, n5, n6 = (riccati_sweep_terminal.launches, forward_rollout.launches,
                  riccati_sweep.launches)

    P_N, p_N = terminal_gram(spec, w, reg, *term)
    g64 = riccati_sweep_plain(h, lm, *(x.double() for x in (*blocks, P_N, p_N, defects)))
    g4 = riccati_sweep_terminal(*args, *term)
    assert g4.shape == (B, N, 30, 37)
    _assert_same_step(g4, riccati_sweep_terminal_plain(*args, *term), g64, h, defects, dx0)
    g6 = riccati_sweep(h, lm, *blocks, P_N, p_N, defects)
    _assert_same_step(g6, riccati_sweep_plain(h, lm, *blocks, P_N, p_N, defects), g64, h,
                      defects, dx0)

    for a, b in zip(forward_rollout(h, g4, defects, dx0),
                    forward_rollout_plain(h, g4, defects, dx0)):
        assert _max_rel(a, b) <= 1e-3          # the bench's rel |dU| gate
    torch.cuda.synchronize()
    assert (riccati_sweep_terminal.launches, forward_rollout.launches,
            riccati_sweep.launches) == (n4 + 1, n5 + 1, n6 + 1)


def _rollout_case(horizons, B, N, seed):
    """(h, gains, defects, dx0) of B problems on the N=25 golden horizon or
    the N=100 one (cut to its first N nodes; N=101 repeats its last node),
    the gains from the fp32 twin of kernel 4 (no kernel needed to make
    them)."""
    solver, X, U, p = horizons[25 if N == 25 else 100]
    n = min(N, solver.N)
    args, term, dx0 = _sweep_inputs(solver, X, U, p, B, seed=seed, n=n)
    gains, d = riccati_sweep_terminal_plain(*args, *term), args[10]
    if N > n:
        gains, d = (torch.cat([x, x[:, -1:]], 1) for x in (gains, d))
    return args[2], gains.contiguous(), d.contiguous(), dx0


def _assert_rollout(a5):
    """Kernel 5 against its twin: the bench's rel |d(dU, dX)| gate, or no
    further from the float64 rollout than twice the twin plus 1e-4 (as
    chip_smoke.py holds it)."""
    out_k = forward_rollout(*a5)
    out_p = forward_rollout_plain(*a5)
    out64 = forward_rollout_plain(a5[0], *(x.double() for x in a5[1:]))
    B, N = a5[1].shape[:2]
    assert out_k[0].shape == (B, N + 1, 36) and out_k[1].shape == (B, N, 30)
    r = max(_max_rel(a, b) for a, b in zip(out_k, out_p))
    r_k, r_p = (max(_max_rel(a.double(), b) for a, b in zip(o, out64)) for o in (out_k, out_p))
    assert r <= 1e-3 or r_k <= 2.0 * r_p + 1e-4, (r, r_k, r_p)
    return out_k


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 256, 512])
@pytest.mark.parametrize("N", [1, 25, 100, 101])
def test_forward_rollout_kernel_shapes(horizons, N, B):
    """Kernel 5 at one problem, a ragged batch, the N=100 chain's batch and
    twice it, over one node, the jacfwd route's 25, the long horizon's 100
    and 101 (odd B N: the tensor's last node starts 16-byte aligned, and
    its window is cut short), one launch a call."""
    a5 = _rollout_case(horizons, B, N, seed=N + B)
    n0 = forward_rollout.launches
    _assert_rollout(a5)
    torch.cuda.synchronize()
    assert forward_rollout.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset_nodes", [1, 2])
def test_forward_rollout_kernel_takes_views(horizons, offset_nodes):
    """Gains and defects as views that start inside their storage (one node
    in: 8 mod 16 bytes, copied by the wrapper to an aligned tensor; two
    nodes: aligned, taken as they are): the same result as the whole
    tensors' rows."""
    h, gains, d, dx0 = _rollout_case(horizons, 33, 25, seed=5)
    whole = forward_rollout(h, gains, d, dx0)
    k = offset_nodes
    big_g = torch.cat([gains.reshape(-1)[:k * 1110], gains.reshape(-1)])
    big_d = torch.cat([d.reshape(-1)[:k * 36], d.reshape(-1)])
    g_view = big_g[k * 1110:].view(33, 25, 30, 37)
    d_view = big_d[k * 36:].view(33, 25, 36)
    assert g_view.storage_offset() == k * 1110 and g_view.data_ptr() % 16 == 8 * (k % 2)
    for a, b in zip(forward_rollout(h, g_view, d_view, dx0), whole):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_forward_rollout_kernel_attributes(card):
    """No local memory (stack or spills), and the layout the design states:
    one warp a block and at least four blocks resident an SM (B=512 in one
    wave over 132 SMs)."""
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.riccati import kernel_attributes

    regs, local, blocks = kernel_attributes()["forward_rollout"]
    assert local == 0 and blocks >= 4, (regs, local, blocks)
    assert _build.ptxas_report(_build.CSRC / "riccati.cu")["forward_rollout_kernel"][1:] == (
        0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 25, 100])
def test_fused_kernel_equals_split_chain(horizons, N):
    """Kernel 3 against kernels 4 -> 5 at B=256 on the N=100 golden horizon
    cut to N nodes: the same stages of csrc/riccati.cuh with one thread
    mapping, so bit for bit."""
    solver, X, U, p = horizons[100]
    args, term, dx0 = _sweep_inputs(solver, X, U, p, 256, seed=7, n=N)
    fused = riccati_rollout(*args, dx0, *term)
    split = forward_rollout(args[2], riccati_sweep_terminal(*args, *term), args[10], dx0)
    for a, b in zip(split, fused):
        assert torch.equal(a, b)


def _step_rel(h, gains, g64, defects, dx0):
    """rel |d(dU, dX)| of the step ``gains`` give (rolled out in float64) to
    the float64 gains' step."""
    def step(g):
        return forward_rollout_plain(h, g.double(), defects.double(), dx0.double())

    return max(_max_rel(a, b) for a, b in zip(step(gains), step(g64)))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 512])
@pytest.mark.parametrize("N", [1, 25])
def test_riccati_rollout_kernel_shapes(horizons, N, B):
    """Kernel 3 at one problem (the replan), a ragged batch and the main
    path's batch, on the N=25 golden horizon and on its first node alone:
    the step no further from the float64 sweep's step than twice the fp32
    twin's, plus 1e-4. Held to the float64 twin, as the sweeps are: on
    these inputs the fp32 twin itself is up to 2.6e-3 from the float64 step
    at B=512 (8e-3 cut to one node), more than the bench's 1e-3 between two
    fp32 solvers (test_riccati_kernel_matches_plain keeps that gate at
    B=3)."""
    solver, X, U, p = horizons[25]
    args, term, dx0 = _sweep_inputs(solver, X, U, p, B, seed=N + B, n=N)
    spec, w, h, lm, reg = args[:5]
    blocks, defects = args[5:10], args[10]
    n0 = riccati_rollout.launches
    k = riccati_rollout(*args, dx0, *term)
    torch.cuda.synchronize()
    assert riccati_rollout.launches == n0 + 1
    assert k[0].shape == (B, N + 1, 36) and k[1].shape == (B, N, 30)
    pl = riccati_rollout_plain(*args, dx0, *term)
    P_N, p_N = terminal_gram(spec, w, reg, *term)
    g64 = riccati_sweep_plain(h, lm, *(x.double() for x in (*blocks, P_N, p_N, defects)))
    s64 = forward_rollout_plain(h, g64, defects.double(), dx0.double())
    r_k, r_p = (max(_max_rel(a.double(), b) for a, b in zip(o, s64)) for o in (k, pl))
    assert r_k <= 2.0 * r_p + 1e-4


@pytest.mark.cuda
def test_riccati_sweep_near_floor_pivot(card):
    """Kernel 6 on one node whose Quu has one eigenvalue at ~1e-6 of the rest
    (tests/test_torch_riccati_stage.py's near_floor_case, B=64): finite,
    and its gains solve the node's system in float64 to a normwise
    backward error of 30 unit roundoffs, as the fp32 twin's do (the
    forward error, ~1e-1 for any fp32 solver at cond(Quu) ~1e7, says
    nothing)."""
    dev = torch.device("cuda")
    blocks, P_N, p_N, d, _ = near_floor_case(64, 2)
    on = [x.to(dev) for x in (*blocks, P_N, p_N, d)]
    g = riccati_sweep(H_STEP, 0.0, *on)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(g).all())
    assert backward_error(blocks, 0.0, g.cpu()) <= BACKWARD_GATE
    assert backward_error(blocks, 0.0, riccati_sweep_plain(H_STEP, 0.0, *on).cpu()) <= \
        BACKWARD_GATE


@pytest.mark.cuda
def test_riccati_kernel_attributes(card):
    """The layout the node stage's design states: four blocks of the sweeps
    resident an SM (B=512 in one wave over 132 SMs), and the stage alone
    (the node-solve probe's block mapping, no register cap) without local
    memory (nvcc -Xptxas -v)."""
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.riccati import kernel_attributes

    at = kernel_attributes()
    for k in ("riccati_rollout", "riccati_sweep_terminal", "riccati_sweep"):
        assert at[k][2] >= 4, (k, at[k])
    report = _build.ptxas_report(_build.CSRC / "probes.cu")
    assert report["node_solve_block_kernel"][1:] == (0, 0, 0)


# kernel 8b: the shipped net at one row, ragged tiles, the datagen batch and
# the bench batches; seeded nets of uneven widths (padded by the factory to
# 144, 112, 272: ragged and empty column slices) and of 3 x 1024 (128-column
# slices, the kernel's widest), at a ragged batch and the datagen batch
BF16_CASES = ([((512,) * 3, B) for B in (1, 33, 256, 1000, 4096)]
              + [(w, B) for w in ((132, 100, 260), (1024,) * 3) for B in (33, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("widths, B", BF16_CASES)
def test_policy_pd_bf16_kernel_matches_plain(card, widths, B):
    """Kernel 8b (bf16 products on the tensor cores) through the factory."""
    dev = torch.device("cuda")
    layers = (_shipped_layers() if widths == (512,) * 3
              else fold_batchnorm(random_policy_payload(3, widths, sum(widths))["variables"]))
    fn = make_fused_policy_pd(layers, 20.0, 1.5, compute_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator().manual_seed(B)
    x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
    n0 = policy_pd_bf16.launches
    ak, tk = fn(x, qj, vj)
    torch.cuda.synchronize()
    assert policy_pd_bf16.launches == n0 + 1
    fp32 = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev)) for W, b in layers]
    ap, tp = policy_pd_bf16_plain(fp32, 20.0, 1.5, x, qj, vj)
    af, _ = policy_pd_plain(fp32, 20.0, 1.5, x, qj, vj)
    scale = max(1.0, float(ap.abs().max()))
    # the fp32 sums run in another order, which can flip one bf16 rounding at
    # a later layer's input: one bf16 ulp (2^-8) of the output scale
    assert float((ak - ap).abs().max()) <= 2.0 ** -8 * scale
    assert float((tk - tp).abs().max()) <= 20.0 * 2.0 ** -8 * scale + 1e-3
    # against fp32 serving: the bf16 roundings of three layers, 2^-5 of scale
    assert float((ak - af).abs().max()) <= 2.0 ** -5 * scale


@pytest.mark.cuda
def test_policy_pd_bf16_kernel_attributes(card):
    """The layout kernel 8b's design states (csrc/policy_pd_bf16.cu, ROWS
    RULE): at B=256 the shipped net runs one pass of 32-row tiles (8
    clusters of 8 blocks); past one pass of the clusters the card holds (at
    least 15), 64-row tiles on every one of them; the 3 x 1024 net (128-
    column slices) 32-row tiles; no instance uses local memory."""
    dev = torch.device("cuda")
    dims = (47, 512, 512, 512, 12)
    at = {B: bf16_kernel_attributes(B, dims, dev) for B in (256, 1000, 4096)}
    at["1024"] = bf16_kernel_attributes(4096, (47, 1024, 1024, 1024, 12), dev)
    assert at[256]["rows_per_tile"] == 32 and at[256]["clusters"] == 8, at
    for B in (1000, 4096):
        assert at[B]["rows_per_tile"] == 64, at
        assert at[B]["clusters"] == at[B]["max_active_clusters"] >= 15, at
    assert at["1024"]["rows_per_tile"] == 32, at
    assert all(a["local_bytes"] == 0 for a in at.values()), at


@pytest.mark.cuda
@pytest.mark.parametrize("nacc", [1, 4, 8])
def test_fma_chain_kernel_matches_plain(card, nacc):
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(nacc)
    a = (0.5 + 0.5 * torch.rand(132 * 256, generator=gen)).to(dev)
    b = (0.05 + 0.85 * torch.rand(132 * 256, generator=gen)).to(dev)
    n0 = probes.fma_chain.launches
    out = probes.fma_chain(a, b, 64, nacc)
    torch.cuda.synchronize()
    assert probes.fma_chain.launches == n0 + 1
    # one rounding per FMA against two per step in the twin; |b| < 1 damps
    # the difference, so 1e-5 of the value
    ref = probes.fma_chain_plain(a, b, 64, nacc)
    assert float(((out - ref).abs() / ref.abs()).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mapping", ["block", "warp", "thread"])
def test_node_solve_kernels_match_plain(card, mapping):
    """The three thread mappings of the node solve against the twin, at a
    ragged count of nodes (B=7, N=5)."""
    B, N = 7, 5
    args = probes.reference_node_blocks(B, N, 0, torch.device("cuda"))
    fn = getattr(probes, f"node_solve_{mapping}")
    n0 = fn.launches
    if mapping == "thread":
        lay = [probes.lay_batch_inner(a, a.dim() - 2) for a in args]
        out = [probes.unlay_batch_inner(o, (B, N)) for o in fn(*lay)]
    else:
        out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    ref = probes.node_solve_plain(*args)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        # Quu is well conditioned (eigenvalues in [3, ~14]): fp32 sums in
        # another order, 1e-5 of each output's scale
        assert float((o - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.cuda
def test_node_solve_warp_matches_the_sublane_golden(card):
    """The warp mapping (persistent warps eliminating pivot by pivot, the
    order of the TPU prototype's ``_solve_node_sublane``) against that
    function's own output on 37 nodes (fewer than the warps the card holds
    at once, no multiple of a block's 5 warps)."""
    dev = torch.device("cuda")
    g = np.load(GOLDEN_SUBLANE)
    args = [torch.as_tensor(g[k], device=dev) for k in ("Qxx", "Quu", "Qux", "qxp", "qu")]
    n0 = probes.node_solve_warp.launches
    out = probes.node_solve_warp(*args)
    torch.cuda.synchronize()
    assert probes.node_solve_warp.launches == n0 + 1
    for name, o in zip(("K", "kff", "P", "p"), out):
        ref = torch.as_tensor(g[name], device=dev)
        assert o.shape == ref.shape
        # fp32 sums in another order on Quu = G G^T + 3 I: 1e-5 of the scale
        assert float((o - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 33, 2677])
def test_node_solve_warp_walks_nodes_on_unaligned_views(card, M):
    """One node, a ragged 33, and 2,677 nodes (past the 1,320 warps an H100
    holds at once: each warp walks two or three nodes), every input a view
    that starts 4 bytes into its storage (the wrapper copies it to a 16-byte
    aligned tensor for the cp.async copies), against the twin."""
    dev = torch.device("cuda")
    args = [a[:, 0] for a in probes.reference_node_blocks(M, 1, 2, dev)]
    views = []
    for a in args:
        flat = torch.empty(a.numel() + 1, device=dev)
        views.append(flat[1:].view(a.shape).copy_(a))
    assert all(v.data_ptr() % 16 for v in views)
    out = probes.node_solve_warp(*views)
    torch.cuda.synchronize()
    ref = probes.node_solve_plain(*args)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert float((o - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.cuda
def test_node_solve_warp_kernel_has_no_local_memory(card):
    """The warp mapping's register rows and columns stay in registers
    (nvcc -Xptxas -v: no stack, no spills)."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    report = _build.ptxas_report(_build.CSRC / "probes.cu")
    assert report["node_solve_warp_kernel"][1:] == (0, 0, 0), report
