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
- warp:   one warp per (problem, node), __syncwarp only;
- thread: one thread per (problem, node) over the batch-innermost layout
          (d1, d2, B*N), laid out beforehand so that the timing covers the
          kernel only.

On the reference's random blocks (``default_rng(0)``, Quu = G G^T + 3 I), each
mapping is checked against the plain twin (torch.linalg) and the block
mapping, then timed with CUDA events; it prints ms, node-solves/s and the
speedup over the block mapping, with the card's name and power limit, and
last one JSON line of the same numbers. ``--ptxas`` also compiles
csrc/probes.cu with ``nvcc -Xptxas -v`` and prints each kernel's registers,
stack and spills.

    python3 scripts/proto_node_solve_torch.py [--b 1024] [--n 25] [--reps 50] [--ptxas]
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAPPINGS = ("block", "warp", "thread")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true")
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
    B, N = args.b, args.n
    dev = torch.device("cuda", 0)
    blocks = probes.reference_node_blocks(B, N, 0, dev)
    laid = [probes.lay_batch_inner(a, a.dim() - 2) for a in blocks]
    calls = {"block": lambda: probes.node_solve_block(*blocks),
             "warp": lambda: probes.node_solve_warp(*blocks),
             "thread": lambda: probes.node_solve_thread(*laid)}
    ref = probes.node_solve_plain(*blocks)
    outs = {}
    for m in MAPPINGS:
        out = calls[m]()
        outs[m] = out if m != "thread" else [probes.unlay_batch_inner(o, (B, N)) for o in out]
    torch.cuda.synchronize()
    rel = lambda a, b: max(float((x - y).abs().max()) / float(y.abs().max())
                           for x, y in zip(a, b))
    result = {"card": card, "B": B, "N": N, "reps": args.reps, "mappings": {}}
    for m in MAPPINGS:
        ms = cuda_time_ms(calls[m], args.reps)
        result["mappings"][m] = dict(ms=ms, node_solves_per_s=B * N / ms * 1e3,
                                     rel_to_plain=rel(outs[m], ref),
                                     rel_to_block=rel(outs[m], outs["block"]))
    t_block = result["mappings"]["block"]["ms"]
    print(f"B={B} N={N} reps={args.reps} ({B * N} node solves per call)")
    for m, r in result["mappings"].items():
        r["speedup_over_block"] = t_block / r["ms"]
        print(f"{m:6s}: {r['ms']:.4f} ms ({r['node_solves_per_s'] / 1e6:.3f}M node-solves/s), "
              f"{r['speedup_over_block']:.2f}x the block mapping; rel max|d| to the twin "
              f"{r['rel_to_plain']:.2e}, to the block mapping {r['rel_to_block']:.2e}")
    if args.ptxas:
        from iterative_learning_nmpc_tpu_torch.ops import _build

        result["ptxas"] = _build.ptxas_report(_build.CSRC / "probes.cu")
        for k, (regs, stack, st, ld) in result["ptxas"].items():
            print(f"{k}: {regs} registers, {stack} B stack, {st} B spill stores, "
                  f"{ld} B spill loads")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
