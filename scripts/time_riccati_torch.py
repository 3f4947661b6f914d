#!/usr/bin/env python3
"""Time the Riccati kernels (``ops/riccati.py``; the node stage of
``csrc/riccati.cuh``) on one CUDA card.

Cases, inputs as tests/test_torch_cuda_kernels.py makes them (the golden
converged trajectory of tests/data for B problems, interior states moved by
5e-4, the lingram kernel's GN blocks):
- kernel 3 ``riccati_rollout`` at N=25 and B = 1 (the closed loop's
  replan), 256 and 512 (the main path's chain, chip_smoke.py phase 4);
- kernel 4 ``riccati_sweep_terminal`` at B=256, N=100 (the long-horizon
  chain, phase 14);
- kernel 6 ``riccati_sweep`` at B=256, N=25 (the jacfwd route, phase 15);
- kernel 5 ``forward_rollout`` over kernel 4's gains at B = 256 and 512,
  N=100 (the long-horizon chain) and B=256, N=25 (the jacfwd route's
  shape), and the split chain (kernel 4 -> 5) beside the fused kernel 3 at
  B=256, N=100;
- P2 ``probes.node_solve_block`` at B=1024, N=25 (the reference probe's
  blocks; it runs the same node stage, phase 19).
Each is checked first (kernels 3, 4 and 6: the step their gains give no
further from the float64 twin's step than twice the fp32 twin's, plus
1e-4, with kernel 3's distance to its fp32 twin printed beside it; kernel
5: rel |d(dU, dX)| / (1 + |twin|) <= 1e-3 or no further from the float64
rollout than twice the twin, plus 1e-4; the split chain bit for bit the
fused kernel's step; P2 within 1e-5 of its twin), then timed with CUDA
events, eager (wrapper calls) and by device time (calls replayed from a
CUDA graph, ``utils/profiling.graph_time_ms``). ``--root DIR`` times the package of another checkout (a
parent commit unpacked with ``git archive``, say) on the same card, so one
call can time two versions in turns. ``--chains`` also runs the warm RTI
chains (B=512, N=25 for 20 steps; B=256, N=100 for 5 steps;
scripts/time_lingram_torch.py's ``chains``) and prints their solves/s and
the Riccati kernels' share of the device's busy time. ``--replan S`` runs
chip_smoke.py phase 8's closed loop (LocomotionMPC on the device plant) for
S seconds and prints the replan latency's median and p95. ``--trace``
builds the tree's ``csrc/riccati.cu`` alone with ``-DRIC_TRACE``,
which compiles in clock64() stamps at the ends of the node stage's phases,
and prints, for kernel 3 at B = 1 and 512 (N=25) and 256 (N=100) and
kernel 4 at B=256, N=100, the median cycles of each phase of a node over
blocks and nodes, converted to us by each block's clock64 / %globaltimer
ratio, a block's median terminal Gram, sweep and (kernel 3) rollout time
by %globaltimer, and the traced kernel's time beside the shipped one's.
``--ptxas`` prints the registers, stack and spills of csrc/riccati.cu and
csrc/probes.cu (``nvcc -Xptxas -v``), the
kernels' SASS instruction counts (``cuobjdump -sass``) and their
attributes. Prints the card's name and power limit first and one JSON
line last.

    python3 scripts/time_riccati_torch.py [--root DIR] [--reps 20] [--chains]
                                          [--replan 1.0] [--trace] [--ptxas]
"""
import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
# the stage's phases: the stamps (csrc/riccati.cuh RIC_STAMP) that bound
# each, taken by one thread of each role (0: the factor warp, 32: a column
# thread, 96: a tile thread)
PHASES = {"quu": (0, 1), "factor": (1, 2), "factor warp waits at B": (2, 3),
          "B to C (forward)": (3, 4), "backward (node n+1)": (5, 6),
          "columns: P d, qu, qxp": (6, 7), "columns wait at B": (7, 8), "forward": (8, 9),
          "tiles: Qxx, Qux": (10, 11), "value update": (12, 13), "prefetch wait": (13, 14)}
STAMPS = 15


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def sweep_inputs(root, dev, N, B):
    """(args of riccati_sweep_terminal, terminal inputs, dx0) at the golden
    converged point of horizon N, B copies, interior states moved by 5e-4."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram

    solver, _, _, p = F.flagship(device=dev, n_nodes=N)
    g = np.load(os.path.join(root, "tests", "data", f"go2_trot_n{N}_golden.npz"))
    t = lambda a: torch.as_tensor(a, device=dev)
    X, U = t(g["X_conv"])[None], t(g["U_conv"])[None]
    p = p.replace(lam_ineq=t(g["lam_ineq_conv"])[None])
    gen = torch.Generator().manual_seed(SEED)
    Xb = X.repeat(B, 1, 1)
    Xb[:, 1:] += 5e-4 * torch.randn(Xb[:, 1:].shape, generator=gen).to(dev)
    Ub = U.repeat(B, 1, 1)
    pb = p.map(lambda x: x.expand((B,) + x.shape[1:]).contiguous())
    blocks = lingram(solver.spec, solver.weights, Xb, Ub, pb)
    args = (solver.spec, solver.weights, solver.dt_nodes, float(solver.opt.lm_reg),
            float(solver.cost.reg_eps_e), *blocks, solver._defects(Xb, Ub, pb))
    term = (Xb[:, -1], pb.peak[:, :, -1], pb.base_ref_e, pb.joint_ref, pb.step_height)
    return args, term, pb.x0 - Xb[:, 0]


def rel(a, b) -> float:
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def step_rel(h, gains, g64, d, dx0) -> float:
    """rel |d(dU, dX)| of the step that ``gains`` give (rolled out in float64)
    to the float64 sweep's step."""
    from iterative_learning_nmpc_tpu_torch.ops.riccati import forward_rollout_plain

    def step(g):
        return forward_rollout_plain(h, g.double(), d.double(), dx0.double())

    return max(rel(a, b) for a, b in zip(step(gains), step(g64)))


def cases(root, dev):
    """{label: (call, check)}: check() -> (ok, text)."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import probes
    from iterative_learning_nmpc_tpu_torch.ops import riccati as R

    out = {}
    for B in (1, 256, 512):
        args, term, dx0 = sweep_inputs(root, dev, 25, B)
        a3 = (*args, dx0, *term)

        def check3(args=args, term=term, dx0=dx0, a3=a3):
            spec, w, h, lm, reg = args[:5]
            blocks, d = args[5:10], args[10]
            k, p = R.riccati_rollout(*a3), R.riccati_rollout_plain(*a3)
            r = max(rel(x, y) for x, y in zip(k, p))
            P_N, p_N = R.terminal_gram(spec, w, reg, *term)
            g64 = R.riccati_sweep_plain(h, lm, *(x.double() for x in (*blocks, P_N, p_N, d)))
            s64 = R.forward_rollout_plain(h, g64, d.double(), dx0.double())
            r_k, r_p = (max(rel(x.double(), y) for x, y in zip(o, s64)) for o in (k, p))
            return r_k <= 2.0 * r_p + 1e-4, (f"step to the float64 sweep's {r_k:.2e} (twin "
                                             f"{r_p:.2e}); rel to the twin {r:.2e}")

        out[f"kernel 3 riccati_rollout B={B} N=25"] = (lambda a3=a3: R.riccati_rollout(*a3),
                                                        check3)
    for k, (N, B) in (("4", (100, 256)), ("6", (25, 256))):
        args, term, dx0 = sweep_inputs(root, dev, N, B)
        spec, w, h, lm, reg = args[:5]
        blocks, d = args[5:10], args[10]
        if k == "4":
            a = (*args, *term)
            call, plain = (lambda a=a: R.riccati_sweep_terminal(*a),
                           lambda a=a: R.riccati_sweep_terminal_plain(*a))
            label = f"kernel 4 riccati_sweep_terminal B={B} N={N}"
        else:
            a = (h, lm, *blocks, *R.terminal_gram(spec, w, reg, *term), d)
            call, plain = (lambda a=a: R.riccati_sweep(*a), lambda a=a: R.riccati_sweep_plain(*a))
            label = f"kernel 6 riccati_sweep B={B} N={N}"

        def check(call=call, plain=plain, args=args, term=term, dx0=dx0):
            spec, w, h, lm, reg = args[:5]
            blocks, d = args[5:10], args[10]
            P_N, p_N = R.terminal_gram(spec, w, reg, *term)
            g64 = R.riccati_sweep_plain(h, lm, *(x.double() for x in (*blocks, P_N, p_N, d)))
            r_k, r_p = step_rel(h, call(), g64, d, dx0), step_rel(h, plain(), g64, d, dx0)
            return (r_k <= 2.0 * r_p + 1e-4,
                    f"step to the float64 sweep's {r_k:.2e} (twin {r_p:.2e})")

        out[label] = (call, check)
    for B, N in ((256, 100), (512, 100), (256, 25)):
        args, term, dx0 = sweep_inputs(root, dev, N, B)
        a5 = (args[2], R.riccati_sweep_terminal(*args, *term), args[10], dx0)

        def check5(a5=a5):
            k, p = R.forward_rollout(*a5), R.forward_rollout_plain(*a5)
            k64 = R.forward_rollout_plain(a5[0], *(x.double() for x in a5[1:]))
            r = max(rel(x, y) for x, y in zip(k, p))
            r_k, r_p = (max(rel(x.double(), y) for x, y in zip(o, k64)) for o in (k, p))
            return (r <= 1e-3 or r_k <= 2.0 * r_p + 1e-4,
                    f"rel to the twin {r:.2e}; to the float64 rollout {r_k:.2e} (twin {r_p:.2e})")

        out[f"kernel 5 forward_rollout B={B} N={N}"] = (lambda a5=a5: R.forward_rollout(*a5),
                                                         check5)
    args, term, dx0 = sweep_inputs(root, dev, 100, 256)

    def split(args=args, term=term, dx0=dx0):
        return R.forward_rollout(args[2], R.riccati_sweep_terminal(*args, *term), args[10], dx0)

    def check_split(args=args, term=term, dx0=dx0):
        same = all(torch.equal(a, b) for a, b in zip(split(), R.riccati_rollout(*args, dx0, *term)))
        return same, f"bit-equal to the fused kernel {same}"

    out["split chain kernel 4 -> 5 B=256 N=100"] = (split, check_split)
    out["fused kernel 3 B=256 N=100"] = (lambda: R.riccati_rollout(*args, dx0, *term),
                                         lambda: (True, "timed beside the split chain"))
    blocks = probes.reference_node_blocks(1024, 25, 0, dev)

    def check_p2(blocks=blocks):
        o, r = probes.node_solve_block(*blocks), probes.node_solve_plain(*blocks)
        e = max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(o, r))
        return e <= 1e-5, f"max |d| / max |twin| {e:.2e} (<= 1e-5)"

    out["P2 node_solve_block B=1024 N=25"] = (lambda: probes.node_solve_block(*blocks), check_p2)
    torch.cuda.synchronize()
    return out


def replan(root, dev, seconds) -> dict:
    """chip_smoke.py phase 8's closed loop for ``seconds``: the replans'
    latency after the first (boot) one."""
    import numpy as np
    import torch

    from chip_smoke import PlantData, standing_state
    from iterative_learning_nmpc_tpu_torch.interop import sim_state_from_numpy
    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    spec = go2_spec(device=dev)
    q0, v0 = standing_state(spec)
    mpc = LocomotionMPC(spec, gait_name="trot", solve_async=False, phase_aligned_boot=True,
                        device=dev)
    mpc.set_command(np.array([0.3, 0.0, 0.0]))
    cp = device_sim.contact_params_for(spec, device=dev)
    st = sim_state_from_numpy(q0, v0, device=dev)
    data = PlantData()
    for i in range(int(round(seconds / mpc.sim_dt))):
        x = torch.cat([st.q, st.v]).cpu().numpy().astype(np.float64)
        data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
        data.time = i * mpc.sim_dt
        mpc.compute_torques_dof(data)
        tau = torch.as_tensor(mpc.torques_dof[-mpc.nu:], dtype=torch.float32, device=dev)
        st = device_sim.step(spec, st, tau, cp, mpc.sim_dt)
    mpc.close()
    lat = np.asarray(mpc.timings["optimize"])[1:]
    return {"replans": int(lat.size), "median_ms": float(np.median(lat)),
            "p95_ms": float(np.percentile(lat, 95)), "max_ms": float(lat.max())}


def sass_sizes(path) -> dict:
    """{kernel: SASS instructions} of a built library (cuobjdump -sass)."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return sizes


def build_traced():
    """csrc/riccati.cu alone with -DRIC_TRACE, loaded with the launch
    functions' argument types."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    src = _build.CSRC / "riccati.cu"
    flags = [*_build.NVCC_FLAGS, "-DRIC_TRACE"]
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (src, _build.CSRC / "riccati.cuh", _build.CSRC / "legdyn.cuh"):
        h.update(f.read_bytes())
    so = _build.BUILD_DIR / f"riccati_traced_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("riccati_rollout_launch", "riccati_sweep_terminal_launch",
                 "riccati_sweep_launch", "forward_rollout_launch", "riccati_attributes"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("ric_read_stamps", "ric_read_spans"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def trace(root, dev, card, reps) -> dict:
    """Per-phase cycles of a node of kernel 3 (B = 1, 512; N=25) and kernel
    4 (B=256, N=100) from the traced build; the wrappers run it in place of
    the shipped library for these calls."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.ops import riccati as R
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    lib, shipped = build_traced(), _build.library()
    out = {}
    for label, fn, N, B in (("kernel 3 B=1 N=25", "rollout", 25, 1),
                            ("kernel 3 B=512 N=25", "rollout", 25, 512),
                            ("kernel 3 B=256 N=100", "rollout", 100, 256),
                            ("kernel 4 B=256 N=100", "terminal", 100, 256)):
        args, term, dx0 = sweep_inputs(root, dev, N, B)
        call = ((lambda: R.riccati_rollout(*args, dx0, *term)) if fn == "rollout"
                else (lambda: R.riccati_sweep_terminal(*args, *term)))
        ms = cuda_time_ms(call, reps)
        _build._Lib.handle = lib
        try:
            ms_traced = cuda_time_ms(call, reps)
            call()
            torch.cuda.synchronize()
        finally:
            _build._Lib.handle = shipped
        n_st = B * N * STAMPS
        st = (ctypes.c_longlong * n_st)()
        sp = (ctypes.c_longlong * (8 * B))()
        _build.check(lib.ric_read_stamps(st, n_st), "ric_read_stamps")
        _build.check(lib.ric_read_spans(sp, 8 * B), "ric_read_spans")
        s = np.array(st, dtype=np.float64).reshape(B, N, STAMPS)
        # (block, span, (clock64, globaltimer ns)): the kernel's start, the
        # sweep's start and end, the rollout's end (kernel 3)
        spans = np.array(sp, dtype=np.float64).reshape(B, 4, 2)
        ghz = float(np.median((spans[:, 2, 0] - spans[:, 1, 0]) / (spans[:, 2, 1] - spans[:, 1, 1])))
        # nodes run n = N-1 .. 0; the node's span ends at the next node's stamp 0
        ph = {k: float(np.median(s[:, 1:, b] - s[:, 1:, a])) for k, (a, b) in PHASES.items()}
        ph["C to the next node"] = float(np.median(s[:, :-1, 0] - s[:, 1:, 4]))
        ph["node"] = float(np.median(s[:, :-1, 0] - s[:, 1:, 0]))
        us = lambda a, b: float(np.median(spans[:, b, 1] - spans[:, a, 1])) / 1e3
        sweep_us, terminal_us = us(1, 2), us(0, 1)
        rollout_us = us(2, 3) if fn == "rollout" else 0.0
        out[label] = {"ms": ms, "ms_traced": ms_traced, "ghz": ghz, "sweep_us": sweep_us,
                      "terminal_us": terminal_us, "rollout_us": rollout_us, "cycles": ph}
        print(f"[trace {label}] kernel {ms:.4f} ms, traced {ms_traced:.4f} ms; a block's "
              f"median terminal Gram {terminal_us:.2f} us, sweep {sweep_us:.2f} us, rollout "
              f"{rollout_us:.2f} us (%globaltimer); a node {ph['node']:.0f} cycles "
              f"({ph['node'] / ghz / 1e3:.3f} us at {ghz:.3f} GHz, the blocks' clock64 over "
              f"%globaltimer) ({card})", flush=True)
        print("  median cycles: " + ", ".join(f"{k} {v:.0f}" for k, v in ph.items()), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--chains", action="store_true")
    ap.add_argument("--replan", type=float, default=0.0, metavar="SECONDS")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(HERE, "scripts"))

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the kernels on a GPU")
    card = card_name()
    print(card, flush=True)
    from iterative_learning_nmpc_tpu_torch.ops import _build
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms, graph_time_ms

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s ({root})", flush=True)
    result = {"card": card, "root": root, "cases": {}}
    if args.ptxas:
        from iterative_learning_nmpc_tpu_torch.ops.riccati import kernel_attributes

        for src in ("riccati.cu", "probes.cu"):
            for k, (regs, stack, st, ld) in _build.ptxas_report(_build.CSRC / src).items():
                print(f"[ptxas] {src} {k}: {regs} registers, {stack} B stack, {st} B spill "
                      f"stores, {ld} B spill loads", flush=True)
        sizes = {k: v for k, v in sass_sizes(_build.library_path()).items()
                 if "riccati" in k or "rollout" in k or "node_solve" in k}
        print("[sass] instructions: " + ", ".join(f"{k} {v}" for k, v in sizes.items()),
              flush=True)
        result["sass_instructions"] = sizes
        result["attributes"] = kernel_attributes()
        print("[attributes] registers, local bytes, resident blocks an SM: " + "; ".join(
            f"{k} {v}" for k, v in result["attributes"].items()), flush=True)
    ok_all = True
    for label, (call, check) in cases(root, dev).items():
        ok, text = check()
        ms, dev_ms = cuda_time_ms(call, args.reps), graph_time_ms(call)
        ok_all &= ok
        result["cases"][label] = {"ms": ms, "device_ms": dev_ms, "ok": ok, "check": text}
        print(f"[{label}] {ms:.4f} ms, device {dev_ms:.4f} ms; {text} "
              f"{'ok' if ok else 'OUTSIDE'} ({card})", flush=True)
    if args.chains:
        from time_lingram_torch import chains

        result["chains"] = chains(root, dev, kernel="riccati")
    if args.replan > 0:
        result["replan"] = replan(root, dev, args.replan)
        r = result["replan"]
        print(f"[replan] {r['replans']} replans after the boot: median {r['median_ms']:.3f} ms, "
              f"p95 {r['p95_ms']:.3f} ms, max {r['max_ms']:.3f} ms ({card})", flush=True)
    if args.trace:
        result["trace"] = trace(root, dev, card, args.reps)
    print(json.dumps(result))
    if not ok_all:
        sys.exit(1)


if __name__ == "__main__":
    main()
