#!/usr/bin/env python3
"""Where the time of the port's learned-policy paths goes, on one CUDA card.

    python3 scripts/profile_torch_learning.py

With the shipped policy (assets/policy_go2_trot_ondevice_dagger.pkl) and
B=256 environments from the standing pose, traces with ``torch.profiler``
(CPU + CUDA), after an untraced warm-up:

- the batched policy rollout (``sim.device_sim.make_batched_policy_rollout``)
  over 20 control steps,
- the on-device expert datagen (``learning.ondevice.make_batched_mpc_rollout``)
  and its SafeDAgger mode: one call of 1 and one of 3 replanning intervals
  each; the difference of the two is 2 steady intervals (80 control
  steps) without the cold-start boot solve,

and prints, per control step, the wall time, the device's busy time (the
sum of the CUDA kernels' self time), its idle share, the kernel launches
and the kernels that take the most device time. The last line is one JSON object with those numbers and the card's name and
power limit. Exits non-zero without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B, T_ROLLOUT, SEED = 256, 20, 0


def totals(prof, wall_s):
    """(wall ms, busy ms, launches, {kernel: (ms, count)}) of a trace."""
    import torch

    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall_s * 1e3, sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern),
            {e.key[:60]: (e.self_device_time_total / 1e3, e.count) for e in kern})


def per_step(a, b, steps):
    """Per control step from the totals b - a (a None: b alone)."""
    wall, busy, n, kern = b
    if a is not None:
        wall, busy, n = wall - a[0], busy - a[1], n - a[2]
        kern = {k: (ms - a[3].get(k, (0.0, 0))[0], c - a[3].get(k, (0.0, 0))[1])
                for k, (ms, c) in kern.items()}
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(wall_ms=wall / steps, busy_ms=busy / steps,
                idle_share=1.0 - busy / wall if wall > 0 else None,
                launches_per_step=n / steps,
                top=[(k, ms / steps, c / steps) for k, (ms, c) in top])


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    from iterative_learning_nmpc_tpu_torch.learning.network import load_policy
    from iterative_learning_nmpc_tpu_torch.learning.ondevice import make_batched_mpc_rollout
    from iterative_learning_nmpc_tpu_torch.models import dynamics as dyn
    from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec
    from iterative_learning_nmpc_tpu_torch.sim import device_sim

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    spec = go2_spec(device=dev)
    cpu = spec.to("cpu")
    q0 = cpu.q_home.numpy().astype(np.float32).copy()
    q0[2] += -dyn.foot_positions(cpu, torch.as_tensor(q0)).numpy()[0, 2] + float(cpu.foot_radius)
    rng = np.random.default_rng(SEED)
    qb = np.tile(q0[None], (B, 1))
    qb[1:, 6:] += rng.normal(0, 0.03, (B - 1, 12)).astype(np.float32)
    x0 = np.concatenate([qb, np.zeros((B, 18), np.float32)], 1)
    v_des = np.tile(np.array([[0.3, 0.0, 0.0]], np.float32), (B, 1))
    policy = load_policy(os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl"),
                         device=dev)

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return totals(prof, wall)

    rollout = device_sim.make_batched_policy_rollout(spec, policy, T_ROLLOUT, device=dev)
    rollout(qb, x0[:, 18:], v_des)                                 # warm-up
    res = {"policy rollout": per_step(None, traced(lambda: rollout(qb, x0[:, 18:], v_des)),
                                      T_ROLLOUT)}
    for name, pol in (("expert datagen", None), ("safedagger", policy)):
        fns = [make_batched_mpc_rollout(spec, n_intervals=n, policy=pol,
                                        delay_steps=20, mpc_min_steps=60, device=dev)
               for n in (1, 3)]
        fns[0](x0, v_des)                                          # warm-up
        one = traced(lambda: fns[0](x0, v_des))
        three = traced(lambda: fns[1](x0, v_des))
        res[name] = per_step(one, three, 80)
    for name, r in res.items():
        print(f"[{name}] B={B}, per control step: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['launches_per_step']:.1f} kernel launches ({card}, profiler on)", flush=True)
        for key, ms, n in r["top"]:
            print(f"    {ms:.4f} ms  x{n:.2f}  {key}", flush=True)
    print(json.dumps({"card": card, "B": B, "per_step": res}))


if __name__ == "__main__":
    main()
