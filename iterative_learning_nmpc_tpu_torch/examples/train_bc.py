"""BC training CLI, the counterpart of the JAX package's
``examples/train_bc.py`` (reference ``Behavior_Cloning/examples/
test_train_policy.py``) with the same arguments and ``--device`` for its
``--cpu``; the dataset is read by its suffix (``.npz``, or ``.hdf5`` where
h5py is installed).

    python -m iterative_learning_nmpc_tpu_torch.examples.train_bc \\
        --dataset ./data/database_0.npz --epochs 500

YAML config workflow (the reference's hydra ``bc_config.yaml``):

    python -m iterative_learning_nmpc_tpu_torch.examples.train_bc \\
        --dataset d.npz --config cfgs/train.yaml \\
        --set learning_rate=1e-4 --set n_epochs=50
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--save_dir", default="./policies")
    ap.add_argument("--run_name", default="bc")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warm_start", default=None)
    ap.add_argument("--ood_npz", default=None, help="side OOD validation set")
    ap.add_argument("--config", default=None,
                    help="YAML TrainConfig file (overrides tuning flags)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..learning.database import Database
    from ..learning.train import BehavioralCloning, TrainConfig
    from ..utils.config_io import load_config, save_config
    from .run_mpc import print_launches

    db = Database(limit=10_000_000, goal_type="vc")
    db.load(args.dataset)
    print(f"loaded {len(db)} samples from {args.dataset}")

    # OOD rows stored by PretrainDataCollection get the x5 sampling weight
    # (reference WeightedRandomSampler, test_train_policy.py:127-134)
    ood_mask = db.ood_array()
    if ood_mask.any():
        print(f"OOD rows: {int(ood_mask.sum())}/{len(db)} (x5 sampling weight)")
    else:
        ood_mask = None

    val_db = None
    if args.ood_npz:
        val_db = Database(limit=1_000_000, goal_type="vc")
        val_db.load_from_npz(args.ood_npz)

    if args.config or args.overrides:
        cfg = load_config(TrainConfig, args.config, overrides=args.overrides)
    else:
        cfg = TrainConfig(
            n_epochs=args.epochs,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            save_dir=args.save_dir,
            run_name=args.run_name,
        )
    save_config(cfg, os.path.join(cfg.save_dir, f"config_{cfg.run_name}.yaml"))
    bc = BehavioralCloning(cfg, device=args.device)
    path = bc.run(db, ood_mask=ood_mask, val_database=val_db,
                  warm_start_path=args.warm_start)
    print("final policy:", path)
    print("last metrics:", bc.metrics[-1])
    print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
