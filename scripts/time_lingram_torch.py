#!/usr/bin/env python3
"""Time the lingram kernel (kernel 2, ``ops/lingram.py``) on one CUDA card
at the shapes of its two solver paths.

Cases, made as chip_smoke.py makes them:
- B=512, N=25: the first step of the main path's chain (phase 5): the
  flagship's 15-iteration converged solve, x0 perturbed by N(0, 0.01^2)
  (seed 0), the converged inequality shifts, zero equality duals;
- B=256, N=100: the long-horizon chain's start (phase 14): the converged
  point of tests/data/go2_trot_n100_golden.npz, perturbed the same way.

``lingram`` is checked against ``lingram_plain`` per block within
3e-4 * max(1, |block|), timed with CUDA events, and split by CUDA kernel
with torch.profiler (device time per kernel name over ``--reps`` calls).
``--root DIR`` times the package of another checkout (a parent commit
unpacked with ``git archive``, say) on the same card, so one call can time
two versions in turns. ``--chains`` also runs the two warm RTI chains that launch the
kernel (B=512, N=25 for 20 steps, chip_smoke.py phase 4; B=256, N=100 for 5
steps, phase 14) after one warm-up step, and prints their solves/s and,
from torch.profiler over 3 more steps, the device's busy ms per step
(the sum of its kernels' device time), the wall ms per step under the
profiler and lingram's share of the busy time. ``--ptxas SRC ...`` prints the registers,
stack and spills of each source's kernels (``nvcc -Xptxas -v``, this
checkout's flags) and times nothing. Prints the card's name and power
limit first and one JSON line last.

    python3 scripts/time_lingram_torch.py [--root DIR] [--reps 20] [--chains]
    python3 scripts/time_lingram_torch.py --ptxas iterative_learning_nmpc_tpu_torch/csrc/lingram.cu
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_MAIN, B_LONG, SEED = 512, 256, 0


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cases(root, dev):
    """{label: (spec, w, X, U, p, include_torque)} of the two paths."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F

    solver, X, U, params = F.flagship(device=dev)
    conv = solver.solve(X, U, params, 15)
    Xb, Ub, pb = F.perturbed_batch(conv.X, conv.U, params, B_MAIN, seed=SEED)
    pb = pb.replace(lam_eq=torch.zeros_like(pb.lam_eq),
                    lam_ineq=conv.lam_ineq.expand_as(pb.lam_ineq).contiguous())
    out = {f"B={B_MAIN} N={solver.N}": (solver.spec, solver.weights, Xb, Ub, pb,
                                       solver.opt.torque_limit_in_qp)}
    g = np.load(os.path.join(root, "tests", "data", "go2_trot_n100_golden.npz"))
    sol_l, _, _, p_l = F.flagship(device=dev, n_nodes=100)
    t = lambda a: torch.as_tensor(a, device=dev)
    Xb, Ub, pb = F.perturbed_batch(t(g["X_conv"])[None], t(g["U_conv"])[None], p_l, B_LONG,
                                   seed=SEED)
    pb = pb.replace(lam_ineq=t(g["lam_ineq_conv"])[None].expand_as(pb.lam_ineq).contiguous())
    out[f"B={B_LONG} N={sol_l.N}"] = (sol_l.spec, sol_l.weights, Xb, Ub, pb,
                                      sol_l.opt.torque_limit_in_qp)
    return out


def chains(root, dev, kernel: str = "lingram") -> dict:
    """{label: numbers} of the B=512, N=25 and B=256, N=100 warm RTI chains;
    the share of the busy time is that of the CUDA kernels whose name holds
    ``kernel``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iterative_learning_nmpc_tpu_torch import flagship as F

    solver, X, U, params = F.flagship(device=dev)
    conv = solver.solve(X, U, params, 15)
    Xb, Ub, pb = F.perturbed_batch(conv.X, conv.U, params, B_MAIN, seed=SEED)
    runs = {f"B={B_MAIN} N={solver.N}, 20 steps": (
        solver, Xb, Ub, pb, conv.lam_ineq.expand_as(pb.lam_ineq).contiguous(), 20)}
    g = np.load(os.path.join(root, "tests", "data", "go2_trot_n100_golden.npz"))
    sol_l, _, _, p_l = F.flagship(device=dev, n_nodes=100)
    t = lambda a: torch.as_tensor(a, device=dev)
    Xb, Ub, pb = F.perturbed_batch(t(g["X_conv"])[None], t(g["U_conv"])[None], p_l, B_LONG,
                                   seed=SEED)
    runs[f"B={B_LONG} N={sol_l.N}, 5 steps"] = (
        sol_l, Xb, Ub, pb, t(g["lam_ineq_conv"])[None].expand_as(pb.lam_ineq).contiguous(), 5)
    out = {}
    for label, (s, Xb, Ub, pb, lam_ineq, steps) in runs.items():
        run = lambda n: F.rti_chain(s, Xb, Ub, torch.zeros_like(pb.lam_eq), lam_ineq, pb, n)
        run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        solves = Xb.shape[0] * steps / (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
        busy, lin = 0.0, 0.0
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            busy += us / 1e3 / 3
            if kernel in e.key:
                lin += us / 1e3 / 3
        out[label] = {"solves_per_s": solves, "busy_ms_per_step": busy,
                      "profiled_wall_ms_per_step": wall, f"{kernel}_ms_per_step": lin}
        print(f"[chain {label}] {solves:.1f} solves/s; profiled: device busy {busy:.4f} ms of "
              f"{wall:.4f} ms wall per step (idle {1 - busy / wall:.3f}), {kernel} "
              f"{lin:.4f} ms ({lin / busy:.3f} of busy)", flush=True)
    return out


def by_kernel(fn, reps: int) -> dict:
    """{CUDA kernel name: device ms per call of fn} from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key[:48]] = us / 1e3 / reps
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", nargs="+", metavar="SRC")
    ap.add_argument("--chains", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE if args.ptxas else root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on a GPU")
    card = card_name()
    print(card, flush=True)
    if args.ptxas:
        from iterative_learning_nmpc_tpu_torch.ops import _build

        report = {src: _build.ptxas_report(os.path.abspath(src)) for src in args.ptxas}
        for src, kernels in report.items():
            for k, (regs, stack, st, ld) in kernels.items():
                print(f"{src} {k}: {regs} registers, {stack} B stack, {st} B spill stores, "
                      f"{ld} B spill loads", flush=True)
        print(json.dumps({"card": card, "ptxas": report}))
        return

    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops import lingram as L
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"card": card, "root": root, "cases": {}}
    for label, a in cases(root, dev).items():
        ref = L.lingram_plain(*a)
        bounds = [3e-4 * max(1.0, float(b.abs().max())) for b in ref]
        out = L.lingram(*a)
        torch.cuda.synchronize()
        errs = [float((x - y).abs().max()) for x, y in zip(out, ref)]
        ok = all(e <= b for e, b in zip(errs, bounds))
        ms = cuda_time_ms(lambda: L.lingram(*a), args.reps)
        res = {"ms": ms, "max_abs_err": max(errs), "within_bound": ok}
        print(f"[{label}] lingram: {ms:.4f} ms, per-block errors "
              + ", ".join(f"{e:.2e}/{b:.2e}" for e, b in zip(errs, bounds))
              + f" {'within' if ok else 'OUTSIDE'} 3e-4 * max(1, |block|) ({card})",
              flush=True)
        res["by_kernel_ms"] = by_kernel(lambda: L.lingram(*a), args.reps)
        print(f"[{label}] lingram by kernel (torch.profiler, ms per call): "
              + ", ".join(f"{k} {v:.4f}" for k, v in res["by_kernel_ms"].items()), flush=True)
        result["cases"][label] = res
    if args.chains:
        result["chains"] = chains(root, dev)
    print(json.dumps(result))
    if not all(c["within_bound"] for c in result["cases"].values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
