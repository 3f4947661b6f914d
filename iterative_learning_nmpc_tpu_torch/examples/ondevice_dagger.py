"""On-device LocoSafeDAgger CLI: the reference's iterative pipeline
(``DAgger/example/iter_locosafedagger.py``) with every data step B
combined-controller rollouts on the device (``learning.dagger.
OnDeviceSafeDagger``: one rollout for every iteration, retrained weights
served through ``policy_update``). Counterpart of the JAX package's
``examples/ondevice_dagger.py``, with the same arguments and
``--device`` for its ``--cpu``; each aggregate is written as
``agg_dataset.npz``. With ``--randomize`` the per-iteration payloads,
terrain and pushes come from ``torch.Generator``s seeded as the JAX loop
seeds its keys, so they are not the JAX CLI's draws.

    python -m iterative_learning_nmpc_tpu_torch.examples.ondevice_dagger \\
        --policy ./policies/policy_bc_final.pkl --batch 64 --sim_time 4 \\
        --iters 2 --out ./dagger_torch [--randomize]
"""
import argparse
import time

from ..learning.dagger import OnDeviceSafeDagger, SafeDaggerConfig
from ..ops.dyncore import dyncore
from ..ops.lingram import lingram
from ..ops.policy_pd import policy_pd
from ..ops.riccati import riccati_rollout
from ..robots.go2 import go2_spec
from ..robots.solo12 import solo12_spec

SPECS = {"go2": go2_spec, "solo12": solo12_spec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", required=True, help="initial policy payload")
    ap.add_argument("--dataset", default=None,
                    help="optional initial dataset (.npz or .hdf5) to aggregate into")
    ap.add_argument("--robot", default="go2", choices=sorted(SPECS))
    ap.add_argument("--gait", default="trot")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sim_time", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=2, help="DAgger iterations per goal")
    ap.add_argument("--goals", default="0.15,0,0;0,0,0;-0.15,0,0",
                    help="';'-separated vx,vy,wz goals")
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--delay_steps", type=int, default=100,
                    help="policy-only hysteresis delay (control steps)")
    ap.add_argument("--mpc_min_steps", type=int, default=2500,
                    help="expert latch length once engaged")
    ap.add_argument("--out", default="./dagger_torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--randomize", action="store_true",
                    help="per-iteration payload/terrain randomization + "
                         "scheduled 50-70 N pushes on half the envs")
    args = ap.parse_args(argv)

    goals = tuple(tuple(float(x) for x in g.split(",")) for g in args.goals.split(";"))
    cfg = SafeDaggerConfig(record_dir=args.out, sim_time=args.sim_time, gait_name=args.gait,
                           n_epochs=args.epochs, goals=goals,
                           n_iterations_per_goal=args.iters, delay_steps=args.delay_steps,
                           mpc_min_steps=args.mpc_min_steps, seed=args.seed)
    spec = SPECS[args.robot](device=args.device)
    pipe = OnDeviceSafeDagger(spec, cfg, args.policy, initial_dataset=args.dataset,
                              batch=args.batch, randomize=args.randomize,
                              device=args.device)
    t0 = time.time()
    final = pipe.run()
    print(f"done in {time.time() - t0:.1f}s wall")
    print(f"expert-influence ratios: {[round(r, 3) for r in pipe.expert_ratio_history]}")
    print(f"final policy: {final}")
    print(f"final dataset: {pipe.dataset_path}")
    print("launches: " + ", ".join(f"{k.__name__} {k.launches}"
                                   for k in (dyncore, lingram, riccati_rollout, policy_pd)))


if __name__ == "__main__":
    main()
