"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``iterative_learning_nmpc_tpu_torch``.
Set-up (imports, CUDA context, the kernel library, built on a checkout's
first run into the package's ``_build/``, the starts, the warm-up steps),
then ``--seconds`` of the warm RTI chain, then the check against the plain
reference. The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profiled stretch of the window. The numbers
compared, each beside its limit, end standard error and the result line.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness import bench, cell as cells, result

    cell = cells.load_cell(args.workload)
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {need} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    if not (ROOT / "iterative_learning_nmpc_tpu_torch").is_dir():
        print("no iterative_learning_nmpc_tpu_torch beside port_bench/", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = bench.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    return result.emit(res, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
