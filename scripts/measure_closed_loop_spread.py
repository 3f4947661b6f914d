#!/usr/bin/env python3
"""How far the learned-policy closed loops spread between fp32 libraries.

    python scripts/measure_closed_loop_spread.py policy   # JAX on the CPU
    python3 scripts/measure_closed_loop_spread.py safedagger   # on a GPU

``policy``: the shipped policy's B=256 rollout of ``chip_smoke.py`` phase 11
(standing pose, joint noise N(0, 0.03^2) with env 0 clean, 0.3 m/s, 1000
steps) with the JAX package's ``jax_sim`` on the CPU for noise seeds 0-4
(falls, mean progress), then the port on the CPU for seed 0: its falls
and each env's largest deviation from the JAX trajectory.

``safedagger``: the B=2, 2-interval SafeDAgger rollout of
``tests/data/go2_trot_safedagger_golden.npz`` on the CUDA card, once
through the kernels and once with the plain twins bound in their place
(solver and policy), each against the JAX golden and against each other,
per 10 rows.
"""
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
B, T, NOISE = 256, 1000, 0.03


def starts(q0, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    qb = np.tile(q0[None], (B, 1))
    qb[1:, 6:] += rng.normal(0, NOISE, (B - 1, 12)).astype(np.float32)
    return qb


def policy() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu.robots.go2 import go2_spec as jax_go2
    from iterative_learning_nmpc_tpu_torch.learning.network import load_policy
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    spec_ = importlib.util.spec_from_file_location(
        "golden", os.path.join(ROOT, "scripts", "make_torch_learning_golden.py"))
    golden = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(golden)
    js = jax_go2()
    q0, _, v_des = golden.inputs(js)
    vd = np.tile(v_des[:1], (B, 1))
    v0 = np.zeros((B, 18), np.float32)
    for seed in range(5):
        qb = starts(q0[0], seed)
        Q, _, fell = golden.policy_rollout(js, qb, v0, vd, T)
        print(f"[jax, seed {seed}] falls {int(fell.sum())} of {B}, mean progress "
              f"{(Q[:, -1, 0] - qb[:, 0]).mean():.4f} m", flush=True)
        if seed == 0:
            Q_ref = Q
    torch.set_num_threads(4)
    qb = starts(q0[0], 0)
    t0 = time.perf_counter()
    Qt, _, fell = device_sim.make_batched_policy_rollout(
        go2_spec(device="cpu"), load_policy(ARTIFACT, device="cpu"), T, device="cpu")(qb, v0, vd)
    Qt = Qt.numpy()
    dev = np.abs(Qt - Q_ref).max((1, 2))
    print(f"[port on the CPU, seed 0] falls {int(fell.sum())} of {B} (envs "
          f"{np.nonzero(fell.numpy())[0].tolist()}), mean progress "
          f"{(Qt[:, -1, 0] - qb[:, 0]).mean():.4f} m; per-env max |q - q_jax| over "
          f"{T} steps: median {np.median(dev):.4f}, max {dev.max():.4f} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


def safedagger() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this measurement runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    from iterative_learning_nmpc_tpu_torch.learning import network
    from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu_torch.ops import dyncore, lingram, policy_pd, riccati
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.solver.sqp import TrajOptSolver

    dev = torch.device("cuda", 0)
    g = np.load(os.path.join(ROOT, "tests", "data", "go2_trot_safedagger_golden.npz"))
    spec = go2_spec(device=dev)
    pol = network.load_policy(ARTIFACT, device=dev)

    def run():
        fn = make_batched_mpc_rollout(spec, n_intervals=int(g["n_intervals"]), policy=pol,
                                      delay_steps=int(g["delay_steps"]),
                                      mpc_min_steps=int(g["mpc_min_steps"]), device=dev)
        return fn(g["x0"], g["v_des"]).q.cpu().numpy()

    q_kernel = run()
    TrajOptSolver.lingram = staticmethod(lingram.lingram_plain)
    TrajOptSolver.riccati_rollout = staticmethod(riccati.riccati_rollout_plain)
    TrajOptSolver.dyncore = staticmethod(dyncore.dyncore_plain)
    network.policy_pd = policy_pd.policy_pd_plain
    q_plain = run()
    rows = lambda e: " ".join(f"{e[:, s:s + 10].max():.2e}" for s in range(0, e.shape[1], 10))
    for name, a, b in (("kernel path vs golden", q_kernel, g["q"]),
                       ("plain path vs golden", q_plain, g["q"]),
                       ("kernel vs plain path", q_kernel, q_plain)):
        print(f"[{name}] max |dq| per 10 rows: {rows(np.abs(a - b))}", flush=True)


if __name__ == "__main__":
    {"policy": policy, "safedagger": safedagger}[sys.argv[1]]()
