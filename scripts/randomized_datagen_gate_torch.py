"""Read the port's randomized datagen against the JAX run that phase 26 of
``chip_smoke.py`` holds it to, with parts of the randomization left out:
what settles the phase's valid-share margin (``RAND_VALID_MARGIN``).

Loads ``tests/data/go2_trot_randomized_datagen_golden.npz`` (the draws and
the JAX package's per-env valid share on them,
``scripts/make_torch_randomized_datagen_golden.py``), runs
``make_batched_mpc_rollout`` on every ``--stride``-th env with each
variant and prints its valid share and falls beside the JAX run's on the
same envs:

- ``full``: payloads, terrain and pushes, as phase 26;
- ``no_payload``: terrain and pushes, every plant nominal;
- ``no_terrain``: payloads and pushes on the flat default ground.

    python3 scripts/randomized_datagen_gate_torch.py --variants no_payload no_terrain  # the card
    python scripts/randomized_datagen_gate_torch.py --device cpu --stride 4  # ~7 min
"""
import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from iterative_learning_nmpc_tpu_torch.device import resolve_device  # noqa: E402
from iterative_learning_nmpc_tpu_torch.learning.ondevice import (  # noqa: E402
    make_batched_mpc_rollout)
from iterative_learning_nmpc_tpu_torch.learning.randomize import TerrainParams  # noqa: E402
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec  # noqa: E402
from iterative_learning_nmpc_tpu_torch.sim.device_sim import ContactParams  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "data", "go2_trot_randomized_datagen_golden.npz")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--stride", type=int, default=1, help="every stride-th env of the draws")
    ap.add_argument("--variants", nargs="+", default=["full"],
                    choices=["full", "no_payload", "no_terrain"])
    args = ap.parse_args()
    dev = resolve_device(args.device)
    g = np.load(GOLDEN)
    idx = np.arange(0, g["x0"].shape[0], args.stride)
    t = lambda k: torch.as_tensor(g[k][idx], device=dev)
    spec = go2_spec(device=dev)
    payload = dataclasses.replace(spec, mass=t("mass"), com=t("com"))
    terrain = TerrainParams(t("ground_height"), ContactParams(
        *(t(k) for k in ("stiffness", "damping", "friction_mu", "vel_smoothing"))))
    plants = {"full": (payload, terrain), "no_payload": (None, terrain),
              "no_terrain": (payload, None)}
    rollout = make_batched_mpc_rollout(spec, n_intervals=int(g["n_intervals"]), device=dev)
    ref = g["valid_env"][idx]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for v in args.variants:
        t0 = time.time()
        out = rollout(g["x0"][idx], g["v_des"][idx], *plants[v],
                      force_windows=t("force_windows"))
        valid = out.valid.mean(1).cpu().numpy()
        print(f"{v} ({len(idx)} envs, stride {args.stride}, {name}): valid {valid.mean():.4f}, "
              f"JAX (all three) {ref.mean():.4f}, d {valid.mean() - ref.mean():+.4f}; fell "
              f"{int((valid < 1).sum())} (JAX {int((ref < 1).sum())}); envs whose share differs "
              f"{int((valid != ref).sum())}, by at most {np.abs(valid - ref).max():.4f}; "
              f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
