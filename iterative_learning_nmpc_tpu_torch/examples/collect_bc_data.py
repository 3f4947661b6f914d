"""BC data collection CLI (force-perturbation flavor), the counterpart of the
JAX package's ``examples/collect_bc_data.py`` with the same arguments and
``--device`` for its ``--cpu`` (reference: ``Behavior_Cloning/utils/
Rollout_MPC.py`` + ``data_collection_force_perturbation.py``). Rollouts
step the host MuJoCo plant; the expert runs on ``--device`` (by default the
CUDA card). The dataset is written as ``database_<n>.npz``.

    python -m iterative_learning_nmpc_tpu_torch.examples.collect_bc_data \\
        --record_dir ./data --vx 0.3 --sim_time_nominal 2.0 --n_perturb 3
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", default="go2")
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--record_dir", default="./data")
    ap.add_argument("--vx", type=float, default=0.3)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--sim_time_nominal", type=float, default=2.0)
    ap.add_argument("--sim_time_perturbed", type=float, default=1.5)
    ap.add_argument("--n_perturb", type=int, default=10)
    ap.add_argument("--replan_grid", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--pretrain", action="store_true",
                    help="multi-goal omni-directional collection")
    ap.add_argument("--n_goals", type=int, default=5)
    ap.add_argument("--config", default=None,
                    help="YAML DataCollectionConfig/PretrainConfig file "
                         "(overrides tuning flags)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="config override (repeatable)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..learning.datagen import (DataCollection, DataCollectionConfig, PretrainConfig,
                                    PretrainDataCollection)
    from ..utils.config_io import load_config, save_config
    from .run_mpc import get_spec, print_launches

    dev = resolve_device(args.device)
    spec = get_spec(args.robot, device=dev)
    common = dict(
        record_dir=args.record_dir,
        sim_time_nominal=args.sim_time_nominal,
        sim_time_perturbed=args.sim_time_perturbed,
        v_des=(args.vx, args.vy, 0.0),
        gait_name=args.gait,
        replan_freq_steps=args.replan_grid,
        num_perturbations_per_replanning=args.n_perturb,
        seed=args.seed,
    )
    if args.config or args.overrides:
        cls = PretrainConfig if args.pretrain else DataCollectionConfig
        cfg = load_config(cls, args.config, overrides=args.overrides)
    elif args.pretrain:
        cfg = PretrainConfig(n_goals=args.n_goals, **common)
    else:
        cfg = DataCollectionConfig(**common)
    save_config(cfg, os.path.join(cfg.record_dir, "config.yaml"))
    dc = (PretrainDataCollection if args.pretrain else DataCollection)(spec, cfg, device=dev)
    out = dc.run()
    print("dataset written:", out)
    print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
