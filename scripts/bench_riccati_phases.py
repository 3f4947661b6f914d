#!/usr/bin/env python3
"""Time the Riccati node stage's phases alone on one CUDA card.

Builds ``scripts/riccati_phases.cu`` (the stage's device functions from
``iterative_learning_nmpc_tpu_torch/csrc/riccati.cuh``, each role alone on
one block, clock64() around each phase; two baselines of the factorization
that broadcast the pivot column by ``__shfl_sync``; phase 1 with every role
at work; single-warp latencies) with nvcc and this checkout's flags into
the package's ``_build/``, runs it, and prints the card's name and power
limit first, the program's lines, and one JSON line last.

    python3 scripts/bench_riccati_phases.py
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    from iterative_learning_nmpc_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = os.path.join(ROOT, "scripts", "riccati_phases.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = _build.BUILD_DIR / "riccati_phases"
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-I", str(_build.CSRC),
                    "-o", str(exe), src], check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    print(run.stdout, end="", flush=True)
    print(json.dumps({"card": card, "lines": run.stdout.splitlines()}))
    if run.returncode != 0:
        sys.exit(run.stderr or run.returncode)


if __name__ == "__main__":
    main()
