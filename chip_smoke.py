#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the batched warm-started RTI solve of the Go2
trot NMPC (N=25 nodes, 36-dim state, 30-dim input), through its public
entry points, and checks every CUDA kernel of that path against its plain
PyTorch twin. Phases, one line each:

  1. the card's name and power limit (nvidia-smi),
  2. build the kernels from ``iterative_learning_nmpc_tpu_torch/csrc``,
  3. the 15-iteration converged solve of the flagship problem (B=1): cost
     in the BENCH_ANCHOR.json band, controls and one RTI step within
     rel |dU| <= 1e-3 of the JAX-on-CPU golden (tests/data),
  4. the main path: a B=512 warm RTI chain with dual carry-over, with the
     kernels' launch counters set to 0 before it and read after it,
  5. each kernel against its plain twin at the chain's shapes (lingram at
     its first step, the others at its end state), timed with CUDA events,
  6. one RTI step of the kernel path against the plain path on the card.

It then prints one JSON line with the kernels' results and, last, the
result line. Any failed check exits non-zero without that line; there is
no CPU fallback.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, CHAIN_STEPS, SEED = 512, 20, 0
REL_GATE = 1.0e-3          # the bench's rel |dU| / (1 + |U|) gate


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def rel(a, b) -> float:
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import numpy as np

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.interop import warm_start_from_numpy
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore, dyncore_plain
    from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram, lingram_plain
    from iterative_learning_nmpc_tpu_torch.ops.riccati import (
        riccati_rollout, riccati_rollout_plain)
    from iterative_learning_nmpc_tpu_torch.solver.linearize import dyncore_inputs
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver

    dev = torch.device("cuda", 0)

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] kernels built from csrc/ in {time.perf_counter() - t0:.2f} s "
          f"({lib.name})", flush=True)

    # ---- 3. converged flagship solve vs the anchor and the JAX golden ----
    solver, X, U, params = F.flagship(device=dev)
    golden = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_n25_golden.npz"))
    dx0 = float(np.abs(params.x0[0].cpu().numpy() - golden["x0"]).max())
    if dx0 > 1e-6:
        fail(f"flagship x0 differs from the golden instance by {dx0:.2e}")
    conv = solver.solve(X, U, params, 15)
    cost = float(conv.stats.cost[0])
    with open(os.path.join(ROOT, "BENCH_ANCHOR.json")) as f:
        anchor = json.load(f)
    ref_cost, tol = float(anchor["converged_cost_cpu"]), float(anchor["tol_rel"])
    du_conv = rel(conv.U[0].cpu(), torch.as_tensor(golden["U_conv"]))
    Xg, Ug, _, lig = warm_start_from_numpy(golden["X_conv"], golden["U_conv"],
                                           golden["U_conv"][:, :18],
                                           golden["lam_ineq_conv"], device=dev)
    rti = solver.solve(Xg, Ug, params.replace(lam_ineq=lig), 1)
    du_rti = rel(rti.U[0].cpu(), torch.as_tensor(golden["U_rti"]))
    print(f"[flagship] 15-iteration B=1 solve: cost {cost:.4f} (anchor "
          f"{ref_cost} +- {tol:.0%}), rel|dU| vs JAX-CPU golden {du_conv:.2e}; "
          f"RTI step from the golden point rel|dU| {du_rti:.2e}", flush=True)
    if not abs(cost / ref_cost - 1.0) <= tol:
        fail(f"converged cost {cost} outside the anchor band")
    if not (du_conv <= REL_GATE and du_rti <= REL_GATE):
        fail(f"port vs golden rel|dU| {du_conv:.2e} / {du_rti:.2e} > {REL_GATE}")

    # ---- 4. the main path: B=512 warm RTI chain with dual carry-over ----
    Xb, Ub, pb = F.perturbed_batch(conv.X, conv.U, params, BATCH, seed=SEED)
    lam_eq = torch.zeros_like(pb.lam_eq)
    lam_ineq = conv.lam_ineq.expand_as(pb.lam_ineq).contiguous()
    F.rti_chain(solver, Xb, Ub, lam_eq, lam_ineq, pb, 1)        # warm-up
    for k in (dyncore, lingram, riccati_rollout):
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xe, Ue, le, lie, costs, qpi = F.rti_chain(solver, Xb, Ub, lam_eq, lam_ineq,
                                              pb, CHAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in (dyncore, lingram, riccati_rollout)}
    finite = all(bool(torch.isfinite(t).all()) for t in (Xe, Ue, le, lie, costs))
    print(f"[main path] B={BATCH} N={solver.N} warm RTI chain, {CHAIN_STEPS} steps: "
          f"{BATCH * CHAIN_STEPS / dt:.1f} solves/s ({card}; informational), "
          f"mean cost {float(costs[-1].mean()):.3f}, mean inner passes "
          f"{float(qpi.float().mean()):.3f}, finite {finite}, launches {launches}",
          flush=True)
    if not finite:
        fail("non-finite values in the RTI chain")
    if Xe.shape != (BATCH, solver.N + 1, 36) or Ue.shape != (BATCH, solver.N, 30):
        fail(f"unexpected chain output shapes {tuple(Xe.shape)} {tuple(Ue.shape)}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")

    # ---- 5. each kernel against its plain twin, at the chain's shapes ----
    pe = pb.replace(lam_eq=le, lam_ineq=lie)
    spec, w = solver.spec, solver.weights
    results = []

    def record(name, src, replaces, err, ok, bound, ms, plain_ms):
        print(f"[kernel] {name}: max_abs_err {err:.3e} ({bound}), "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms", flush=True)
        results.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))
        if not ok:
            fail(f"{name} disagrees with its plain twin ({bound})")

    N = solver.N
    inc = solver.opt.torque_limit_in_qp
    # lingram at the chain's first step: at a converged point the gradient
    # blocks qx, ru are ~0 sums of large cancelling terms (e.g. w_dyn^2 * m_tot
    # times one ulp of the 150 N base force), so a bound relative to |block|
    # measures nothing there; the converged state's blocks are held through
    # the riccati and full-step checks below
    ps = pb.replace(lam_eq=lam_eq, lam_ineq=lam_ineq)
    blocks_k = lingram(spec, w, Xb, Ub, ps, inc)
    blocks_p = lingram_plain(spec, w, Xb, Ub, ps, inc)
    # per block the bound of tests/test_fast_linearize.py: 3e-4 * max(1, |block|)
    errs = [float((a - b).abs().max()) for a, b in zip(blocks_k, blocks_p)]
    bounds = [3e-4 * max(1.0, float(b.abs().max())) for b in blocks_p]
    record("lingram", "iterative_learning_nmpc_tpu_torch/csrc/lingram.cu",
           "iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:698", max(errs),
           all(e <= b for e, b in zip(errs, bounds)),
           "per block <= 3e-4 * max(1, |block|): "
           + ", ".join(f"{n} {e:.2e}/{b:.2e}" for n, e, b in
                       zip(("Q", "R", "M", "qx", "ru"), errs, bounds)),
           cuda_time_ms(lambda: lingram(spec, w, Xb, Ub, ps, inc), 20),
           cuda_time_ms(lambda: lingram_plain(spec, w, Xb, Ub, ps, inc), 3))
    blocks_k = lingram(spec, w, Xe, Ue, pe, inc)

    defects = solver._defects(Xe, Ue, pe)
    ric_args = (spec, w, solver.dt_nodes, float(solver.opt.lm_reg),
                float(solver.cost.reg_eps_e), *blocks_k, defects, pe.x0 - Xe[:, 0],
                Xe[:, -1], pe.peak[:, :, -1], pe.base_ref_e, pe.joint_ref,
                pe.step_height)
    dX_k, dU_k = riccati_rollout(*ric_args)
    dX_p, dU_p = riccati_rollout_plain(*ric_args)
    r_ric = max(rel(dU_k, dU_p), rel(dX_k, dX_p))
    record("riccati_rollout", "iterative_learning_nmpc_tpu_torch/csrc/riccati.cu",
           "iterative_learning_nmpc_tpu/ops/riccati_kernel.py:202",
           max(float((dU_k - dU_p).abs().max()), float((dX_k - dX_p).abs().max())),
           r_ric <= REL_GATE, f"rel |d(dU, dX)| / (1 + |plain|) {r_ric:.2e} <= {REL_GATE}",
           cuda_time_ms(lambda: riccati_rollout(*ric_args), 20),
           cuda_time_ms(lambda: riccati_rollout_plain(*ric_args), 3))

    # dyncore on the line-search candidates (alphas 1, 0.25): M = 2 * 512 * 26
    alphas = torch.tensor(solver.opt.ls_alphas_steady, device=dev)
    nA = len(alphas)
    Xc = (Xe[None] + alphas[:, None, None, None] * dX_k[None]).reshape(-1, N + 1, 36)
    Uc = (Ue[None] + alphas[:, None, None, None] * dU_k[None]).reshape(-1, N, 30)
    pc = pe.map(lambda t: t.repeat((nA,) + (1,) * (t.dim() - 1)))
    Xm, Am, Fm = (t.contiguous() for t in dyncore_inputs(Xc, Uc, pc))
    out_k, out_p = dyncore(spec, Xm, Am, Fm), dyncore_plain(spec, Xm, Am, Fm)
    # the two reassociate fp32 sums differently: 1e-5 of the output scale
    err_dc = float((out_k - out_p).abs().max())
    bound_dc = 1e-5 * max(1.0, float(out_p.abs().max()))
    record("dyncore", "iterative_learning_nmpc_tpu_torch/csrc/dyncore.cu",
           "iterative_learning_nmpc_tpu/ops/dynjac_kernel.py:599", err_dc,
           err_dc <= bound_dc, f"<= 1e-5 * max(1, |out|) = {bound_dc:.3e}, M={Xm.shape[0]}",
           cuda_time_ms(lambda: dyncore(spec, Xm, Am, Fm), 50),
           cuda_time_ms(lambda: dyncore_plain(spec, Xm, Am, Fm), 5))

    # ---- 6. one RTI step: kernel path vs plain path, both on the card ----
    class PlainSolver(TrajOptSolver):
        lingram = staticmethod(lingram_plain)
        riccati_rollout = staticmethod(riccati_rollout_plain)
        dyncore = staticmethod(dyncore_plain)

    plain = PlainSolver(solver.spec, solver.opt, solver.cost, device=dev)
    s_k = solver.solve(Xe, Ue, pe, 1)
    s_p = plain.solve(Xe, Ue, pe, 1)
    r_step = rel(s_k.U, s_p.U)
    print(f"[rti step] B={BATCH} kernel path vs plain path on the card: rel|dU| "
          f"{r_step:.2e} (gate {REL_GATE})", flush=True)
    if not r_step <= REL_GATE:
        fail(f"kernel path vs plain path rel|dU| {r_step:.2e}")

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
