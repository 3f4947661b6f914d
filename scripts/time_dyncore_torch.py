#!/usr/bin/env python3
"""Time the dyncore kernel (kernel 1, ``ops/dyncore.py``: merit and duals)
on one CUDA card at the shapes of its solver paths.

Cases: the golden converged trajectory of tests/data (Go2 trot) for L
problems, x0 moved by N(0, 0.01^2) (``flagship.perturbed_batch``, seed 0),
flattened by ``linearize.dyncore_inputs`` into M = L * (N+1) evaluations:
- M = 52 and 104: the closed loop's B=1 replan (2 and 4 line-search alphas);
- M = 13,312 = 2 * 256 * 26: the B=256 datagen;
- M = 26,624 = 2 * 512 * 26: the main path's B=512 chain;
- M = 51,712 = 2 * 256 * 101: the N=100 chain (its golden).
Each is checked against ``dyncore_plain`` within 1e-5 * max(1, |out|),
then timed three ways: eager calls of the wrapper between CUDA events
(``cuda_time_ms``, the measure of PERF.md's kernel table), the wrapper's
calls replayed from a CUDA graph (``graph_time_ms``: device time, the host
left out), and the bare launch (the C entry point on fixed buffers,
replayed from a graph: the kernel alone); plus the host's us a wrapper call
(perf_counter over calls that are not waited for). ``--root DIR`` times the
package of another checkout (a parent commit unpacked with ``git archive``)
on the same card, so one call can time two versions in turns. ``--chains``
also runs the B=512, N=25 and B=256, N=100 warm RTI chains
(scripts/time_lingram_torch.py's ``chains``: solves/s, device busy ms a
step, dyncore's share), chip_smoke.py phase 8's closed loop for
``--replan`` seconds (replan median and p95) and the B=256 expert datagen
for ``--intervals`` replanning intervals (rows/s). ``--ptxas`` prints the
registers, stack and spills of csrc/dyncore.cu (``nvcc -Xptxas -v``), its
SASS instruction count (``cuobjdump -sass``) and the kernel's attributes
(of the timed tree). Prints the card's name and power limit first and one
JSON line last; exits 1 if a case is outside its bound.

    python3 scripts/time_dyncore_torch.py [--root DIR] [--reps 50] [--ptxas]
                                          [--chains] [--replan 1.0] [--intervals 5]
"""
import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
# label: (horizon N, problems L); M = L * (N + 1)
SHAPES = {"M=52 (B=1 replan)": (25, 2), "M=104 (B=1 replan, 4 alphas)": (25, 4),
          "M=13312 (B=256 datagen)": (25, 512), "M=26624 (B=512 chain)": (25, 1024),
          "M=51712 (N=100 chain)": (100, 512)}
B_DATAGEN = 256


def inputs(root, dev, N, L):
    """(spec, X, A, Fe) of L perturbed copies of the horizon-N golden."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.solver.linearize import dyncore_inputs

    solver, _, _, p = F.flagship(device=dev, n_nodes=N)
    g = np.load(os.path.join(root, "tests", "data", f"go2_trot_n{N}_golden.npz"))
    t = lambda a: torch.as_tensor(a, device=dev)
    Xb, Ub, pb = F.perturbed_batch(t(g["X_conv"])[None], t(g["U_conv"])[None], p, L,
                                   seed=SEED)
    return (solver.spec, *(a.contiguous() for a in dyncore_inputs(Xb, Ub, pb)))


def host_us(fn, calls: int = 200) -> float:
    """The host's us per call of ``fn``, the device not waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def time_case(spec, X, A, Fe, reps):
    """(ok, numbers) of one shape."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops.dyncore import dyncore, dyncore_plain
    from iterative_learning_nmpc_tpu_torch.ops.layout import robot_consts
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    out, ref = dyncore(spec, X, A, Fe), dyncore_plain(spec, X, A, Fe)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    bound = 1e-5 * max(1.0, float(ref.abs().max()))
    lib, M = _build.library(), X.shape[0]
    consts, buf = robot_consts(spec.to(X.device)), torch.empty_like(out)

    def bare():
        _build.check(lib.dyncore_launch(X.data_ptr(), A.data_ptr(), Fe.data_ptr(),
                                        consts.data_ptr(), buf.data_ptr(), M,
                                        torch.cuda.current_stream().cuda_stream),
                     "dyncore_launch")

    call = lambda: dyncore(spec, X, A, Fe)
    res = {"M": M, "max_abs_err": err, "bound": bound, "ms": cuda_time_ms(call, reps),
           "device_ms": graph_time_ms(call, reps), "kernel_ms": graph_time_ms(bare, reps),
           "host_us": host_us(call)}
    return err <= bound, res


def datagen(dev, intervals: int) -> dict:
    """chip_smoke.py phase 12's expert datagen at B=256 for ``intervals``
    replanning intervals: rows/s."""
    import numpy as np
    import torch

    from chip_smoke import datagen_batch, standing_state
    from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec

    spec = go2_spec(device=dev)
    q0, _ = standing_state(spec)
    x0b, vd = datagen_batch(q0.astype(np.float32), B_DATAGEN, np.random.default_rng(SEED))
    run = make_batched_mpc_rollout(spec, n_intervals=intervals, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = run(x0b, vd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    T = rows.q.shape[1]
    return {"rows_per_s": B_DATAGEN * T / wall, "ms_per_control_step": wall / T * 1e3,
            "valid": float(rows.valid.mean())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--chains", action="store_true")
    ap.add_argument("--replan", type=float, default=1.0, metavar="SECONDS")
    ap.add_argument("--intervals", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(HERE, "scripts"))
    sys.path.insert(2, HERE)
    # this checkout's chip_smoke (phase 8's plant, phase 12's batch) over
    # the timed tree's package
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
    from iterative_learning_nmpc_tpu_torch.ops import dyncore as D

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s ({root})", flush=True)
    result = {"card": card, "root": root, "cases": {}}
    if args.ptxas:
        from time_riccati_torch import sass_sizes

        for k, (regs, stack, st, ld) in _build.ptxas_report(_build.CSRC / "dyncore.cu").items():
            print(f"[ptxas] dyncore.cu {k}: {regs} registers, {stack} B stack, {st} B spill "
                  f"stores, {ld} B spill loads", flush=True)
        sizes = {k: v for k, v in sass_sizes(_build.library_path()).items() if "dyncore" in k}
        result["sass_instructions"] = sizes
        print(f"[sass] instructions: {sizes}", flush=True)
        if hasattr(D, "kernel_attributes"):
            result["attributes"] = D.kernel_attributes()
            print(f"[attributes] registers, local bytes, resident blocks an SM: "
                  f"{result['attributes']}", flush=True)
    ok_all = True
    for label, (N, L) in SHAPES.items():
        ok, res = time_case(*inputs(root, dev, N, L), args.reps)
        ok_all &= ok
        result["cases"][label] = res
        print(f"[{label}] {res['ms']:.4f} ms eager, {res['device_ms']:.4f} ms device, kernel "
              f"alone {res['kernel_ms']:.4f} ms, host {res['host_us']:.1f} us a call; max err "
              f"{res['max_abs_err']:.2e} {'<=' if ok else 'OUTSIDE'} {res['bound']:.2e} ({card})",
              flush=True)
    if args.chains:
        from time_lingram_torch import chains
        from time_riccati_torch import replan

        result["chains"] = chains(root, dev, kernel="dyncore")
        result["replan"] = r = replan(root, dev, args.replan)
        print(f"[replan] {r['replans']} replans after the boot: median {r['median_ms']:.3f} ms, "
              f"p95 {r['p95_ms']:.3f} ms, max {r['max_ms']:.3f} ms ({card})", flush=True)
        result["datagen"] = d = datagen(dev, args.intervals)
        print(f"[datagen] B={B_DATAGEN} x {args.intervals} intervals: {d['rows_per_s']:.1f} "
              f"rows/s, {d['ms_per_control_step']:.3f} ms a control step, valid "
              f"{d['valid']:.4f} ({card})", flush=True)
    print(json.dumps(result))
    if not ok_all:
        sys.exit(1)


if __name__ == "__main__":
    main()
