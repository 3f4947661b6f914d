"""The learned-policy rollout CLI in the host MuJoCo plant, the
counterpart of the JAX package's ``examples/run_policy.py`` with the same
arguments and ``--device`` for its ``--cpu``. Needs ``mujoco``; the policy
(and with ``--combined`` the MPC) runs on ``--device``.

    python -m iterative_learning_nmpc_tpu_torch.examples.run_policy \\
        --policy assets/policy_go2_trot_ondevice_dagger.pkl --vx 0.15 --sim_time 5
"""
import argparse
import sys

import numpy as np

from ..device import resolve_device
from .run_mpc import get_spec, print_launches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", required=True)
    ap.add_argument("--robot", default="go2")
    ap.add_argument("--vx", type=float, default=0.3)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--sim_time", type=float, default=5.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--combined", action="store_true",
                    help="policy + MPC safety fallback (SafeDAgger controller)")
    args = ap.parse_args(argv)

    from ..learning.rollouts import rollout_combined, rollout_policy

    dev = resolve_device(args.device)
    spec = get_spec(args.robot, device=dev)
    v_des = np.array([args.vx, args.vy, 0.0])
    if args.combined:
        out = rollout_combined(spec, args.policy, sim_time=args.sim_time, v_des=v_des,
                               device=dev)
        is_exp = np.asarray(out.recorder.data["is_expert"])
        print(out.sim)
        print(f"expert-influence ratio: {is_exp.mean():.3f}")
    else:
        out = rollout_policy(spec, args.policy, sim_time=args.sim_time, v_des=v_des,
                             device=dev)
        print(out.sim)
    print_launches()
    return 1 if out.sim.fell else 0


if __name__ == "__main__":
    sys.exit(main())
