"""The MPC CLI, the counterpart of the JAX package's ``examples/run_mpc.py``
with the same arguments and ``--device`` for its ``--cpu``.

    python -m iterative_learning_nmpc_tpu_torch.examples.run_mpc \\
        --mode close_loop --robot go2 --gait trot --vx 0.3 --sim_time 5.0

Modes:
  traj_opt   one trajectory-optimization solve, prints the solution summary
  open_loop  MPC in a loop without a plant (follows its own plan)
  close_loop the host MuJoCo plant at 1 kHz with async replanning (needs
             ``mujoco``; the controller runs on ``--device``)

Each mode ends with a line of the CUDA kernels' launches in the process.
"""
import argparse
import sys

import numpy as np

from ..device import resolve_device
from ..ops.dyncore import dyncore
from ..ops.dynjac import dynjac
from ..ops.lingram import lingram
from ..ops.policy_pd import policy_pd
from ..ops.riccati import riccati_rollout

KERNELS = (dyncore, lingram, riccati_rollout, dynjac, policy_pd)


def get_spec(robot: str, urdf: str = None, device=None):
    """The catalog's spec; ``urdf`` switches to description-file ingestion
    (``robots/urdf.py``)."""
    if robot.lower() == "go2":
        from ..robots.go2 import go2_spec

        return go2_spec(urdf_path=urdf, device=device)
    if robot.lower() == "solo12":
        from ..robots.solo12 import solo12_spec

        return solo12_spec(urdf_path=urdf, device=device)
    if urdf:
        from ..robots.urdf import parse_urdf

        return parse_urdf(urdf, name=robot, device=device)
    raise SystemExit(f"unknown robot {robot} (pass --urdf for new robots)")


def print_launches() -> None:
    print("launches: " + ", ".join(f"{k.__name__} {k.launches}" for k in KERNELS), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="close_loop",
                    choices=["traj_opt", "open_loop", "close_loop"])
    ap.add_argument("--robot", default="go2")
    ap.add_argument("--urdf", default=None,
                    help="ingest this URDF description instead of the "
                         "built-in parameter table (robots/urdf.py)")
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--vx", type=float, default=0.3)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--wz", type=float, default=0.0)
    ap.add_argument("--sim_time", type=float, default=5.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--contact_planner", default="", help="'', raibert, custom")
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args(argv)

    from ..models import transforms_np as tnp
    from ..mpc.controller import LocomotionMPC

    dev = resolve_device(args.device)
    spec = get_spec(args.robot, args.urdf, device=dev)
    mpc = LocomotionMPC(
        spec,
        gait_name=args.gait,
        contact_planner=args.contact_planner,
        interactive_goal=args.interactive,
        print_info=True,
        solve_async=(args.mode == "close_loop"),
        device=dev,
    )
    mpc.set_command(np.array([args.vx, args.vy, 0.0]), args.wz)
    q0 = spec.q_home.detach().cpu().numpy().astype(np.float64)
    try:
        if args.mode == "traj_opt":
            q_plan, v_plan, a_plan, f_plan, tau_ff = mpc.optimize(q0, np.zeros(spec.nv))
            print("plan shapes:", q_plan.shape, v_plan.shape, f_plan.shape)
            print("base z range:", q_plan[:, 2].min().round(3), q_plan[:, 2].max().round(3))
            print("|tau_ff| max:", np.abs(tau_ff).max().round(2))
            print_launches()
            return 0

        if args.mode == "open_loop":
            q_mj, v_mj = tnp.convert_to_mujoco(q0, np.zeros(spec.nv))
            traj = mpc.open_loop(q_mj, v_mj, args.sim_time)
            print("open-loop trajectory:", traj.shape)
            print("final base:", traj[-1, :7].round(3))
            mpc.print_timings()
            print_launches()
            return 0

        from ..sim.mujoco_sim import Simulator

        sim = Simulator(spec)
        res = sim.run(sim_time=args.sim_time, controller=mpc)
        print(res)
        print("final base:", sim.data.qpos[:7].round(3))
        print(f"mean vx: {sim.data.qpos[0] / max(res.sim_time, 1e-6):.3f} (cmd {args.vx})")
        mpc.print_timings()
        print_launches()
        return 1 if (res.fell or res.diverged) else 0
    finally:
        mpc.close()


if __name__ == "__main__":
    sys.exit(main())
