"""Batched-expert plant collection CLI: many MuJoCo envs, one batched
replan on the card (``learning/plant_batch.BatchedPlantCollector``).

The counterpart of the JAX package's ``examples/collect_plant_batch.py``,
with the same arguments and ``--device`` for its ``--cpu``: expert-only
force-perturbed rollouts for BC datasets, or combined-controller rollouts
with is_expert labels for SafeDAgger aggregation. Writes recorder-contract
rows to ``plant_rows.npz`` and the expert rows' Database snapshot to
``database_plant.npz``.

    # 160 env-sim-s of expert demonstrations across the velocity goals:
    python -m iterative_learning_nmpc_tpu_torch.examples.collect_plant_batch --out ./plant_data

    # SafeDAgger data step with a learned policy driving:
    python -m iterative_learning_nmpc_tpu_torch.examples.collect_plant_batch \\
        --out ./plant_data --policy assets/policy_go2_trot_inplant_dagger.pkl
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./plant_data")
    ap.add_argument("--robot", default="go2", choices=("go2", "solo12"))
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--n_envs", type=int, default=16)
    ap.add_argument("--sim_time", type=float, default=10.0)
    ap.add_argument("--goals", default="0.3,0.15,0.0,-0.15",
                    help="vx goals cycled over the envs")
    ap.add_argument("--policy", default=None,
                    help="combined mode: policy drives, expert relabels")
    ap.add_argument("--joint_noise", type=float, default=0.03)
    ap.add_argument("--n_pushes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..device import resolve_device
    from ..learning.database import Database
    from ..learning.plant_batch import BatchedPlantCollector
    from .run_mpc import get_spec, print_launches

    dev = resolve_device(args.device)
    spec = get_spec(args.robot, device=dev)
    goals = [float(g) for g in args.goals.split(",")]
    E = args.n_envs
    v_des = np.zeros((E, 3))
    v_des[:, 0] = np.tile(goals, E // len(goals) + 1)[:E]

    coll = BatchedPlantCollector(spec, n_envs=E, gait_name=args.gait,
                                 policy_path=args.policy, device=dev)
    try:
        res = coll.collect(v_des, sim_time=args.sim_time, joint_noise=args.joint_noise,
                           n_pushes=args.n_pushes, seed=args.seed)
    finally:
        coll.close()
    os.makedirs(args.out, exist_ok=True)
    npz = os.path.join(args.out, "plant_rows.npz")
    np.savez(npz, state=res.state, action=res.action,
             vc_goals=res.vc_goals, cc_goals=res.cc_goals, time=res.time,
             env_id=res.env_id, is_expert=res.is_expert)

    db = Database(limit=10_000_000, goal_type="vc")
    keep = res.is_expert.astype(bool)  # expert-labeled rows only (DAgger)
    db.append(res.state[keep], res.action[keep],
              vc_goals=res.vc_goals[keep], cc_goals=res.cc_goals[keep],
              traj_id=res.env_id[keep], times=res.time[keep])
    snap = db.save_as_npz(os.path.join(args.out, "database_plant.npz"), config=vars(args))
    print(f"collected {len(res.state)} rows ({int(keep.sum())} expert) "
          f"over {res.env_sim_s:.2f} env-sim-s in {res.wall_s:.2f}s "
          f"({res.env_sim_s / res.wall_s:.3f} env-sim-s/s); "
          f"fell {int(res.fell.sum())}/{E}; "
          f"expert ratio {res.expert_ratio:.3f}; replan median "
          f"{np.median(res.replan_ms):.2f} ms at B={E}\n-> {npz}\n-> {snap}")
    print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
