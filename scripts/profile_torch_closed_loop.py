#!/usr/bin/env python3
"""Where the time of the port's closed loop goes, on one CUDA card.

    python3 scripts/profile_torch_closed_loop.py

Builds ``LocomotionMPC`` (Go2 trot, sync mode, phase-aligned boot, 0.3 m/s)
and the device plant on the card, runs the first plan and 0.2 s of the
loop untraced, then traces with ``torch.profiler`` (CPU + CUDA):

- 10 steady RTI replans, ``optimize`` called as the loop calls it,
- 100 plant steps (``sim.device_sim.step``, two sub-steps each),

and prints, for each, the wall time per call, the device's busy time per
call (the sum of the CUDA kernels' self time), its idle share, the kernel
launches per call and the kernels that take the most device time. The last
line is one JSON object with those numbers and the card's name and power
limit. Exits non-zero without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_REPLANS, N_STEPS = 10, 100


def device_summary(prof, calls, wall_s):
    """Busy ms per call, idle share, launches per call and the top kernels
    of a trace, from its CUDA kernels' self time."""
    import torch

    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    wall_ms = wall_s * 1e3 / calls
    busy_ms = busy_us / 1e3 / calls
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms if wall_ms > 0 else None,
                launches_per_call=launches / calls,
                top=[(e.key[:60], e.self_device_time_total / 1e3 / calls, e.count / calls)
                     for e in top])


def main() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    from iterative_learning_nmpc_tpu_torch.interop import sim_state_from_numpy
    from iterative_learning_nmpc_tpu_torch.models import dynamics as dyn
    from iterative_learning_nmpc_tpu_torch.models import transforms_np as tnp
    from iterative_learning_nmpc_tpu_torch.mpc.controller import LocomotionMPC
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
    mpc = LocomotionMPC(spec, solve_async=False, device=dev)
    mpc.set_command(np.array([0.3, 0.0, 0.0]))
    cp = device_sim.contact_params_for(spec, device=dev)
    st = sim_state_from_numpy(q0, np.zeros(18), device=dev)

    class Data:
        time, qpos, qvel = 0.0, None, None

    data = Data()

    def loop(st, i0, n):
        for i in range(i0, i0 + n):
            x = torch.cat([st.q, st.v]).cpu().numpy().astype(np.float64)
            data.qpos, data.qvel = tnp.convert_to_mujoco(x[:18], x[18:])
            data.time = i * mpc.sim_dt
            mpc.compute_torques_dof(data)
            tau = torch.as_tensor(mpc.torques_dof[-mpc.nu:], dtype=torch.float32, device=dev)
            st = device_sim.step(spec, st, tau, cp, mpc.sim_dt)
        return st, x

    st, x = loop(st, 0, 200)              # first plan (boot) + 4 replans, untraced
    q, v = x[:18], x[18:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N_REPLANS):
            mpc.optimize(q, v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    replan = device_summary(prof, N_REPLANS, wall)
    tau = torch.zeros(mpc.nu, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = st
        for _ in range(N_STEPS):
            s = device_sim.step(spec, s, tau, cp, mpc.sim_dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    plant = device_summary(prof, N_STEPS, wall)
    mpc.close()
    for name, r in (("replan (RTI, B=1)", replan), ("plant step (2 sub-steps)", plant)):
        print(f"[{name}] wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms, "
              f"idle share {r['idle_share']:.3f}, {r['launches_per_call']:.1f} kernel "
              f"launches per call ({card}, profiler on)", flush=True)
        for key, ms, n in r["top"]:
            print(f"    {ms:.4f} ms  x{n:.1f}  {key}", flush=True)
    print(json.dumps({"card": card, "replan": replan, "plant_step": plant}))


if __name__ == "__main__":
    main()
