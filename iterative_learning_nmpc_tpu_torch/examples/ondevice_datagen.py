"""On-device expert datagen CLI.

Runs B closed-loop MPC rollouts on the device (``learning.ondevice.
make_batched_mpc_rollout``: one RTI replan a 40 ms interval, the plant at
1 kHz), keeps the valid dataset rows and writes a ``Database`` npz snapshot
the BC trainer reads (npz, since the card's machines need not have h5py).
Counterpart of the JAX package's ``examples/ondevice_datagen.py``, with
the same arguments and ``--device`` for its ``--cpu``. For a ``--seed`` the
starts and commands (numpy) are the JAX CLI's; the ``--randomize``
payloads and terrain are not, since they come from ``torch.Generator``s
seeded ``seed`` and ``seed + 1`` where the JAX CLI draws from
``PRNGKey(seed)`` and ``PRNGKey(seed + 1)``.

    python -m iterative_learning_nmpc_tpu_torch.examples.ondevice_datagen \\
        --batch 256 --seconds 2.0 --out ./data/ondevice_0.npz [--randomize]
"""
import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..learning.database import Database
from ..learning.ondevice import make_batched_mpc_rollout
from ..learning.randomize import randomize_payload, randomize_terrain
from ..models.dynamics import settled_state
from ..ops.dyncore import dyncore
from ..ops.lingram import lingram
from ..ops.riccati import riccati_rollout
from ..robots.go2 import go2_spec
from ..robots.solo12 import solo12_spec

SPECS = {"go2": go2_spec, "solo12": solo12_spec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", default="go2", choices=sorted(SPECS))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--vx_max", type=float, default=0.3)
    ap.add_argument("--joint_noise", type=float, default=0.03)
    ap.add_argument("--out", default="./data/ondevice_0.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--randomize", action="store_true",
                    help="per-env payload + terrain domain randomization")
    args = ap.parse_args(argv)
    if not args.out.endswith(".npz"):
        ap.error("--out names an .npz snapshot")

    dev = resolve_device(args.device)
    spec = SPECS[args.robot](device=dev)
    x0 = settled_state(spec)
    rng = np.random.default_rng(args.seed)
    B = args.batch
    x0b = np.tile(x0[None], (B, 1))
    x0b[:, 6:18] += rng.normal(0, args.joint_noise, (B, 12)).astype(np.float32)
    vdes = np.zeros((B, 3), np.float32)
    vdes[:, 0] = rng.uniform(0.0, args.vx_max, B)

    n_intervals = int(round(args.seconds / 0.04))
    rollout = make_batched_mpc_rollout(spec, n_intervals=n_intervals, device=dev)
    ps = tr = None
    if args.randomize:
        gen = lambda s: torch.Generator().manual_seed(s)
        ps = randomize_payload(spec, gen(args.seed), B)
        tr = randomize_terrain(gen(args.seed + 1), B, device=dev)
    t0 = time.time()
    out = rollout(x0b, vdes, ps, tr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    T = out.q.shape[1]
    print(f"{B} envs x {args.seconds}s in {wall:.1f}s wall "
          f"({B * T / wall:.0f} rows/s); launches "
          + ", ".join(f"{k.__name__} {k.launches}" for k in (dyncore, lingram, riccati_rollout)))

    states = out.state44.reshape(-1, 44).cpu().numpy()
    actions = out.action.reshape(-1, 12).cpu().numpy()
    valid = out.valid.reshape(-1).cpu().numpy() > 0.5
    goals = np.repeat(vdes, T, axis=0)
    traj_ids = np.repeat(np.arange(B), T)
    times = np.tile(np.arange(T) * 1e-3, B)

    db = Database(limit=max(int(valid.sum()), 1), goal_type="vc")
    db.append(states[valid], actions[valid], vc_goals=goals[valid],
              traj_id=traj_ids[valid], times=times[valid])
    db.save_as_npz(args.out)
    print(f"wrote {len(db)} rows ({valid.mean():.1%} valid) -> {args.out}")


if __name__ == "__main__":
    main()
