"""Multi-process launch helper: one process per card, joined in one
``torch.distributed`` process group.

Counterpart of ``iterative_learning_nmpc_tpu/parallel/launcher.py``. Once
the group is joined, every path of ``parallel.mesh`` (sharded solves, dp
training, dataset all_gather) spans the processes: NCCL between cards,
gloo on the CPU.

Usage (per process, e.g. under SLURM or torchrun-style environments):

    python -m iterative_learning_nmpc_tpu_torch.parallel.launcher \\
        --coordinator host0:29500 --num_processes 4 --process_id $RANK \\
        -- script.py [args...]

or programmatically: ``launch_distributed(main_fn)`` reads MASTER_ADDR and
MASTER_PORT (or ``coordinator``), WORLD_SIZE and RANK from the environment.
A rendezvous that fails raises: no process carries on alone.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
from typing import Callable, Optional

from .mesh import DEFAULT_TIMEOUT_S, initialize_distributed


def launch_distributed(
    main_fn: Optional[Callable] = None,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_S,
):
    """Join the process group (no-op for one process), then run main_fn
    (or return). ``device``: the rank's device, by default its card."""
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    initialize_distributed(coordinator, num_processes, process_id, device=device,
                           timeout=timeout)
    if main_fn is not None:
        return main_fn()
    return None


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--device", default=None, help="the rank's device (default: its card)")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds to wait for the other ranks")
    ap.add_argument("script", nargs=argparse.REMAINDER,
                    help="-- script.py [args...] to run after init")
    args = ap.parse_args()

    launch_distributed(coordinator=args.coordinator, num_processes=args.num_processes,
                       process_id=args.process_id, device=args.device, timeout=args.timeout)
    rest = [a for a in args.script if a != "--"]
    if rest:
        sys.argv = rest
        runpy.run_path(rest[0], run_name="__main__")


if __name__ == "__main__":
    main()
