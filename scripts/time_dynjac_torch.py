#!/usr/bin/env python3
"""Time the dynjac kernel (kernel 7, ``ops/dynjac.py``: the B=1 route's
dynamics and Jacobian) on one CUDA card.

Cases, from the golden converged trajectory of tests/data (Go2 trot, N=25):
- M = 1: one evaluation, one block;
- M = 25: the closed loop's B=1 linearization (the golden's nodes);
- M = 12,800 = 512 * 25: chip_smoke.py phase 7's stress shape (512 copies,
  x0 moved by N(0, 0.01^2), ``flagship.perturbed_batch``, seed 0).
Each is checked against ``dynjac_plain`` (values 1e-5 of their scale, J 3e-5
of its largest entry, the structural zeros exact where the timed tree
states them), then timed three ways: eager calls of the wrapper between
CUDA events (``cuda_time_ms``, the measure of PERF.md's kernel table), the
wrapper's calls replayed from a CUDA graph (``graph_time_ms``: device time,
the host left out), and the bare launch (the C entry point on fixed
buffers, replayed from a graph: the kernel alone); plus the host's us a
wrapper call (perf_counter over calls that are not waited for).
``--root DIR`` times the package of another checkout (a parent commit
unpacked with ``git archive``) on the same card, so one call can time two
versions in turns. ``--steps`` also times one B=1 RTI step (linearize,
riccati, the merit of the line-search alphas) by the dynjac route and by
the lingram route (chip_smoke.py phase 7's ``b1_route_ms``); ``--replan
SECONDS`` runs chip_smoke.py phase 8's closed loop (replan median and
p95). ``--ptxas``
prints csrc/dynjac.cu's registers, stack and spills (``nvcc -Xptxas -v``),
its SASS instruction count and the kernel's attributes. Prints the card's
name and power limit first and one JSON line last; exits 1 if a case is
outside its bound.

    python3 scripts/time_dynjac_torch.py [--root DIR] [--reps 50] [--ptxas] [--steps]
                                         [--replan 2.0]
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
CASES = {"M=1": 1, "M=25 (B=1 replan)": 1, "M=12800 (512 x 25)": 512}


def inputs(root, dev, L, M=None):
    """(spec, X, A, Fe) of the N=25 golden (L = 1) or of L perturbed copies,
    flattened as linearize.lingram_structured hands them to dynjac; the
    first M rows if given."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F

    solver, _, _, p = F.flagship(device=dev)
    g = np.load(os.path.join(root, "tests", "data", "go2_trot_n25_golden.npz"))
    t = lambda a: torch.as_tensor(a, device=dev)
    X, U = t(g["X_conv"])[None], t(g["U_conv"])[None]
    p = p.replace(lam_ineq=t(g["lam_ineq_conv"])[None])
    if L > 1:
        X, U, p = F.perturbed_batch(X, U, p, L, seed=SEED)
    n = L * solver.N
    cnt = p.cnt[:, :, :-1].transpose(1, 2).reshape(n, 4, 1)
    rows = (X[:, :-1].reshape(n, 36), U[..., :18].reshape(n, 18),
            (cnt * U[..., 18:].reshape(n, 4, 3)).reshape(n, 12))
    return (solver.spec, *(r[:M or n].contiguous() for r in rows))


def time_case(spec, X, A, Fe, reps):
    """(ok, numbers) of one shape."""
    import torch

    from time_dyncore_torch import host_us
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops import dynjac as D
    from iterative_learning_nmpc_tpu_torch.ops.layout import robot_consts
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    (pk, Jk), (pp, Jp) = D.dynjac(spec, X, A, Fe), D.dynjac_plain(spec, X, A, Fe)
    torch.cuda.synchronize()
    e_p, e_J = float((pk - pp).abs().max()), float((Jk - Jp).abs().max())
    b_p, b_J = 1e-5 * max(1.0, float(pp.abs().max())), 3e-5 * float(Jp.abs().max())
    zeros = None
    if hasattr(D, "structural_zeros"):
        zeros = bool((Jk[:, D.structural_zeros().to(X.device)] == 0).all())
    lib, M = _build.library(), X.shape[0]
    consts, prim, J = robot_consts(spec.to(X.device)), torch.empty_like(pk), torch.empty_like(Jk)

    def bare():
        _build.check(lib.dynjac_launch(X.data_ptr(), A.data_ptr(), Fe.data_ptr(),
                                       consts.data_ptr(), prim.data_ptr(), J.data_ptr(), M,
                                       torch.cuda.current_stream().cuda_stream), "dynjac_launch")

    call = lambda: D.dynjac(spec, X, A, Fe)
    res = {"M": M, "prim_err": e_p, "prim_bound": b_p, "J_err": e_J, "J_bound": b_J,
           "structural_zeros_exact": zeros, "ms": cuda_time_ms(call, reps),
           "device_ms": graph_time_ms(call, reps), "kernel_ms": graph_time_ms(bare, reps),
           "host_us": host_us(call)}
    return e_p <= b_p and e_J <= b_J and zeros is not False, res


def b1_steps(root, dev, reps) -> dict:
    """One B=1 RTI step from the N=25 golden's converged point by the dynjac
    route and by the lingram route (chip_smoke.py phase 7's
    ``b1_route_ms``): ms between CUDA events."""
    import numpy as np

    from chip_smoke import b1_route_ms
    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.interop import warm_start_from_numpy

    solver, _, _, params = F.flagship(device=dev)
    g = np.load(os.path.join(root, "tests", "data", "go2_trot_n25_golden.npz"))
    Xg, Ug, _, lig = warm_start_from_numpy(g["X_conv"], g["U_conv"], g["U_conv"][:, :18],
                                           g["lam_ineq_conv"], device=dev)
    return b1_route_ms(solver, Xg, Ug, params.replace(lam_ineq=lig), reps)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--replan", type=float, default=0.0, metavar="SECONDS")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(HERE, "scripts"))
    sys.path.insert(2, HERE)
    # this checkout's chip_smoke (phases 7-8) over the timed tree's package
    cs = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    sys.modules["chip_smoke"] = importlib.util.module_from_spec(cs)
    cs.loader.exec_module(sys.modules["chip_smoke"])

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernel on a GPU")
    from time_riccati_torch import card_name

    card = card_name()
    print(card, flush=True)
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops import dynjac as D

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s ({root})", flush=True)
    result = {"card": card, "root": root, "cases": {}}
    if args.ptxas:
        from time_riccati_torch import sass_sizes

        for k, (regs, stack, st, ld) in _build.ptxas_report(_build.CSRC / "dynjac.cu").items():
            print(f"[ptxas] dynjac.cu {k}: {regs} registers, {stack} B stack, {st} B spill "
                  f"stores, {ld} B spill loads", flush=True)
        sizes = {k: v for k, v in sass_sizes(_build.library_path()).items() if "dynjac" in k}
        result["sass_instructions"] = sizes
        print(f"[sass] instructions: {sizes}", flush=True)
        if hasattr(D, "kernel_attributes"):
            result["attributes"] = D.kernel_attributes()
            print(f"[attributes] registers, local bytes, resident blocks an SM: "
                  f"{result['attributes']}", flush=True)
    ok_all = True
    for label, L in CASES.items():
        ok, res = time_case(*inputs(root, dev, L, 1 if label == "M=1" else None), args.reps)
        ok_all &= ok
        result["cases"][label] = res
        print(f"[{label}] {res['ms']:.4f} ms eager, {res['device_ms']:.4f} ms device, kernel "
              f"alone {res['kernel_ms']:.4f} ms, host {res['host_us']:.1f} us a call; prim err "
              f"{res['prim_err']:.2e} (<= {res['prim_bound']:.2e}), J err {res['J_err']:.2e} "
              f"(<= {res['J_bound']:.2e}), structural zeros exact "
              f"{res['structural_zeros_exact']}{'' if ok else ' OUTSIDE'} ({card})", flush=True)
    if args.steps:
        result["b1_step"] = s = b1_steps(root, dev, 20)
        print(f"[b1 step] dynjac route {s['dynjac_route_ms']:.4f} ms, lingram route "
              f"{s['lingram_route_ms']:.4f} ms ({card})", flush=True)
    if args.replan > 0:
        from time_riccati_torch import replan

        result["replan"] = r = replan(root, dev, args.replan)
        print(f"[replan] {r['replans']} replans after the boot: median {r['median_ms']:.3f} ms, "
              f"p95 {r['p95_ms']:.3f} ms, max {r['max_ms']:.3f} ms ({card})", flush=True)
    print(json.dumps(result))
    if not ok_all:
        sys.exit(1)


if __name__ == "__main__":
    main()
