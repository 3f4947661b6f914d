"""The check's readings: the program's on many seeds, and the control's.

    python3 port_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

Runs in one process, one seed after another, at the cell's own size. For
each ``--seeds`` seed a benchmark run (set-up, ``--seconds`` of the chain,
the check); for each ``--control-seeds`` seed the same run with the
program replaced by the control: the plain reference in float32 with TF32
matrix products, the precision below the configuration's (float32, TF32
off), through the warm-up and the first ``check.steps`` window steps, every
one of them compared. Prints one JSON line per run, then for each compared
number the largest program reading and the smallest control reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def control_step(cell, nom, device):
    """A step function with ``program.rti_step``'s contract, computed by
    ``reference.rti`` in float32 with TF32 matrix products."""
    import torch

    from port_bench.reference import inputs as ref_inputs
    from port_bench.reference.robot import load_robot
    from port_bench.reference.rti import RTI

    rob = cell.config["robot"]
    robot = load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"],
                       rob["base_height_home"], dtype=torch.float32, device=device)
    rti = RTI(robot, cell.opt, cell.config, torch.float32, device)

    def step(solver, X, U, lam_eq, lam_ineq, params):
        torch.backends.cuda.matmul.allow_tf32 = True
        p = ref_inputs.batch_params(nom, params.x0, rti.h)
        r = rti.step(X, U, lam_eq, lam_ineq, p)
        return (r["X"], r["U"], r["lam_eq"], r["lam_ineq"],
                SimpleNamespace(cost=r["cost"], qp_iters=r["qp_iters"]))

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from port_bench.harness import bench, cell as cells, program
    from port_bench.reference import inputs as ref_inputs
    from port_bench.reference.robot import load_robot

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rob = cell.config["robot"]
    nom = ref_inputs.nominal_problem(
        cell.opt, cell.config["gait"], cell.traffic["motion"],
        load_robot(str(cell.path(rob["urdf"])), rob["q_home_joints"], rob["base_height_home"]))
    rows = []
    runs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for side, seed in runs:
        kw = {}
        if side == "control":
            kw = dict(step_fn=control_step(cell, nom, device),
                      record_steps=cell.traffic["check"]["steps"])
        t0 = time.perf_counter()
        res = bench.run(cell, seed, args.seconds if side == "program" else 0.0, False,
                        device, t0, **kw)
        torch.backends.cuda.matmul.allow_tf32 = False
        row = dict(side=side, seed=seed, steps=res["steps"],
                   solves_per_s=res["attempted"] / res["window_s"],
                   step_ms_p95=float(np.percentile(res["step_ms"], 95)),
                   passes=float(np.mean(res["passes"])), failed=res["failed"],
                   wall_s=time.perf_counter() - t0, **res["numbers"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = [k for k in cell.traffic["limits"]]
    summary = {}
    for k in names:
        prog = [r[k] for r in rows if r["side"] == "program"]
        ctrl = [r[k] for r in rows if r["side"] == "control"]
        summary[k] = dict(program_max=max(prog) if prog else None,
                          control_min=min(ctrl) if ctrl else None,
                          limit=cell.traffic["limits"][k])
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
