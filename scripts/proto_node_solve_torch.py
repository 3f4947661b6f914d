#!/usr/bin/env python3
"""Which thread mapping suits one Riccati node's factorize-and-solve on the
card? The port of scripts/proto_sublane_riccati.py (which timed two TPU
layouts of the same solve).

Three mappings of Cholesky(Quu) -> W = L^-1 [Qux | qu] -> Z = L^-T W ->
P = Qxx - W^T W (``ops/probes.py``, ``csrc/probes.cu``):

- block:  one 192-thread block per (problem, node): the node stage of
          csrc/riccati.cuh that kernels 3, 4 and 6 run (a factor warp with
          Quu in registers, column threads for the two triangular solves,
          tile threads for the value update);
- warp:   persistent warps, one (problem, node) at a time each, __syncwarp
          only: lane i owns row i of [Quu | Qux | qu] in registers and the
          rows are eliminated pivot by pivot (the order of the TPU
          prototype's ``_solve_node_sublane``), the next node's blocks
          landing in shared memory by cp.async meanwhile;
- thread: one thread per (problem, node) over the batch-innermost layout
          (d1, d2, B*N), laid out beforehand so that the timing covers the
          kernel only.

On the reference's random blocks (``default_rng(0)``, Quu = G G^T + 3 I), at
each batch of ``--b``, each mapping is checked against the plain twin
(torch.linalg) and the block mapping, then timed with CUDA events; it prints
ms, node-solves/s and the speedup over the block mapping, with the card's
name and power limit. Each mapping is also held to the JAX prototype's own
output on 37 nodes (``tests/data/node_solve_sublane_golden.npz``, from
``scripts/make_torch_node_solve_golden.py``). Last, one JSON line of the
same numbers. ``--ptxas`` also compiles csrc/probes.cu with ``nvcc -Xptxas
-v`` and prints each kernel's registers, stack and spills, and the SASS
instructions of each kernel of the built library (``cuobjdump -sass``).
``--trace`` builds csrc/probes.cu alone with ``-DNSW_TRACE`` (the warp
mapping's clock64 stamps, lane 0 of each warp at seven points of each node)
and prints, at each batch, the median cycles of each phase of a node, a
node's cycles, and the traced kernel's ms beside the shipped one's (the
stamps' cost).

    python3 scripts/proto_node_solve_torch.py [--b 256 1024 4096] [--n 25] [--reps 50] [--ptxas] [--trace]
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAPPINGS = ("block", "warp", "thread")
STAMPS = 7   # csrc/probes.cu NSW_STAMPS
PHASES = ("rows in (the wait for Quu, Qux, qu)", "elimination", "the wait for Qxx",
          "value update, P and p stored", "back substitution", "K stored")


def build_traced():
    """csrc/probes.cu alone with -DNSW_TRACE, its warp launch and stamp reader typed."""
    from iterative_learning_nmpc_tpu_torch.ops import _build

    src = _build.CSRC / "probes.cu"
    flags = [*_build.NVCC_FLAGS, "-DNSW_TRACE"]
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (src, _build.CSRC / "riccati.cuh", _build.CSRC / "legdyn.cuh"):
        h.update(f.read_bytes())
    so = _build.BUILD_DIR / f"probes_traced_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.node_solve_warp_launch.argtypes = _build.SIGNATURES["node_solve_warp_launch"]
    lib.node_solve_warp_launch.restype = ctypes.c_int
    lib.nsw_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nsw_read_stamps.restype = ctypes.c_int
    return lib


def trace(lib, blocks, reps) -> dict:
    """The traced warp kernel on these blocks: its ms and the median cycles
    of each phase of a node (lane 0's clock64, per node)."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import _build, probes
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    lead = tuple(blocks[0].shape[:-2])
    M = int(np.prod(lead))
    dev = blocks[0].device
    outs = [torch.empty((*lead, *s), device=dev) for s in ((30, 36), (30,), (36, 36), (36,))]
    ptrs = [t.data_ptr() for t in (*blocks, *outs)]

    def call():
        err = lib.node_solve_warp_launch(*ptrs, M, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "node_solve_warp_launch (traced)")

    ms = cuda_time_ms(call, reps)
    call()
    torch.cuda.synchronize()
    n = min(M, 1 << 17)
    st = np.zeros(n * STAMPS, np.int64)
    _build.check(lib.nsw_read_stamps(st.ctypes.data, n * STAMPS), "nsw_read_stamps")
    st = st.reshape(n, STAMPS)
    d = np.diff(st, axis=1)
    ref = probes.node_solve_plain(*blocks)
    rel = max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(outs, ref))
    return {"traced_ms": ms, "rel_to_plain": rel,
            "node_cycles_median": float(np.median(st[:, -1] - st[:, 0])),
            "phase_cycles_median": {p: float(np.median(d[:, i])) for i, p in enumerate(PHASES)}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, nargs="+", default=[1024])
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe runs only on a GPU")
    from iterative_learning_nmpc_tpu_torch.ops import probes
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    N = args.n
    dev = torch.device("cuda", 0)
    rel = lambda a, b: max(float((x - y).abs().max()) / float(y.abs().max())
                           for x, y in zip(a, b))

    def calls_of(blocks):
        lead = blocks[0].dim() - 2   # (*lead, d1, d2) and (*lead, d)
        laid = [probes.lay_batch_inner(a, a.dim() - lead) for a in blocks]
        return {"block": lambda: probes.node_solve_block(*blocks),
                "warp": lambda: probes.node_solve_warp(*blocks),
                "thread": lambda: probes.node_solve_thread(*laid)}

    def unlay(m, out, lead):
        return out if m != "thread" else [probes.unlay_batch_inner(o, lead) for o in out]

    golden = np.load(os.path.join(ROOT, "tests", "data", "node_solve_sublane_golden.npz"))
    g_in = [torch.as_tensor(golden[k], device=dev) for k in ("Qxx", "Quu", "Qux", "qxp", "qu")]
    g_out = [torch.as_tensor(golden[k], device=dev) for k in ("K", "kff", "P", "p")]
    g_calls = calls_of(g_in)
    ptxas = None
    if args.ptxas:
        from iterative_learning_nmpc_tpu_torch.ops import _build

        ptxas = _build.ptxas_report(_build.CSRC / "probes.cu")
        for k, (regs, stack, st, ld) in ptxas.items():
            print(f"{k}: {regs} registers, {stack} B stack, {st} B spill stores, "
                  f"{ld} B spill loads", flush=True)
        from time_riccati_torch import sass_sizes

        sass = {k: v for k, v in sass_sizes(_build.build()).items() if "node_solve" in k}
        print("SASS instructions: " + ", ".join(f"{k} {v}" for k, v in sass.items()))
    traced = build_traced() if args.trace else None
    result = {"card": card, "N": N, "reps": args.reps, "ptxas": ptxas, "batches": {},
              "trace": {},
              "rel_to_golden": {m: rel(unlay(m, c(), (len(golden["Qxx"]),)), g_out)
                                for m, c in g_calls.items()}}
    print(f"held to _solve_node_sublane's output on {len(golden['Qxx'])} nodes (rel max|d| "
          "per output): " + ", ".join(f"{m} {r:.2e}" for m, r in result["rel_to_golden"].items()))
    for B in args.b:
        blocks = probes.reference_node_blocks(B, N, 0, dev)
        calls = calls_of(blocks)
        ref = probes.node_solve_plain(*blocks)
        outs = {m: unlay(m, c(), (B, N)) for m, c in calls.items()}
        torch.cuda.synchronize()
        rows = result["batches"][B] = {}
        for m in MAPPINGS:
            ms = cuda_time_ms(calls[m], args.reps)
            rows[m] = dict(ms=ms, node_solves_per_s=B * N / ms * 1e3,
                           rel_to_plain=rel(outs[m], ref), rel_to_block=rel(outs[m], outs["block"]))
        del blocks, calls, ref, outs
        print(f"B={B} N={N} reps={args.reps} ({B * N} node solves per call)")
        for m, r in rows.items():
            r["speedup_over_block"] = rows["block"]["ms"] / r["ms"]
            print(f"{m:6s}: {r['ms']:.4f} ms ({r['node_solves_per_s'] / 1e6:.3f}M node-solves/s), "
                  f"{r['speedup_over_block']:.2f}x the block mapping; rel max|d| to the twin "
                  f"{r['rel_to_plain']:.2e}, to the block mapping {r['rel_to_block']:.2e}")
        if traced is not None:
            blocks = probes.reference_node_blocks(B, N, 0, dev)
            t = result["trace"][B] = trace(traced, blocks, args.reps)
            del blocks
            print(f"warp traced: {t['traced_ms']:.4f} ms (shipped {rows['warp']['ms']:.4f}), rel "
                  f"to the twin {t['rel_to_plain']:.2e}; a node {t['node_cycles_median']:.0f} "
                  "cycles (median over nodes): " + ", ".join(
                      f"{p} {c:.0f}" for p, c in t["phase_cycles_median"].items()), flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
