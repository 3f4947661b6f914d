"""LocoSafeDAgger outer loop CLI, the counterpart of the JAX package's
``examples/run_dagger.py`` (reference ``DAgger/example/
iter_locosafedagger.py``) with the same arguments and ``--device`` for its
``--cpu``: combined-controller rollouts in the host MuJoCo plant (the
policy and the expert on ``--device``, by default the CUDA card), each
aggregate written as ``agg_dataset.npz``, training on the same device.

    python -m iterative_learning_nmpc_tpu_torch.examples.run_dagger \\
        --policy ./policies/policy_bc_final.pkl --record_dir ./dagger \\
        --iters 4 --sim_time 10
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", required=True, help="initial (pretrained) policy")
    ap.add_argument("--dataset", default=None, help="initial dataset to aggregate onto")
    ap.add_argument("--robot", default="go2")
    ap.add_argument("--record_dir", default="./dagger")
    ap.add_argument("--sim_time", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--goals", default="0.15,0,0;0,0,0;-0.15,0,0")
    ap.add_argument("--config", default=None,
                    help="YAML SafeDaggerConfig file (overrides tuning flags)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..learning.dagger import SafeDaggerConfig, SafeDaggerPipeline
    from ..utils.config_io import load_config, save_config
    from .run_mpc import get_spec, print_launches

    dev = resolve_device(args.device)
    spec = get_spec(args.robot, device=dev)
    if args.config or args.overrides:
        cfg = load_config(SafeDaggerConfig, args.config, overrides=args.overrides)
    else:
        goals = [tuple(float(x) for x in g.split(",")) for g in args.goals.split(";")]
        cfg = SafeDaggerConfig(
            record_dir=args.record_dir,
            sim_time=args.sim_time,
            n_epochs=args.epochs,
            goals=goals,
            n_iterations_per_goal=args.iters,
        )
    save_config(cfg, os.path.join(cfg.record_dir, "config.yaml"))
    pipeline = SafeDaggerPipeline(spec, cfg, initial_policy=args.policy,
                                  initial_dataset=args.dataset, device=dev)
    final = pipeline.run()
    print("final policy:", final)
    print("expert ratios:", [round(r, 3) for r in pipeline.collector.expert_ratio_history])
    print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
