"""Time the device plant's control step eagerly and as a CUDA graph.

    python3 scripts/time_plant_graph_torch.py

For Go2 and Solo12 at B = 1 and 256 (standing starts, joint noise
N(0, 0.03^2)): 40 control steps of torque-clipped joint PD (the policy
warm start's node) eagerly and captured as one graph by
``sim.device_sim.graphed``, the replay checked bit for bit against the
eager steps; and one step (``device_sim.step`` with a base force) as a
graph, replayed with a copy of the state back to the host each step (the
closed loops of ``chip_smoke.py`` phases 22-24). Wall ms a control step
(host clock around work that ends in a synchronise), the capture's wall
(one eager pass and the recording), the card's name and power limit.
Needs a CUDA card.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iterative_learning_nmpc_tpu_torch.models import dynamics as dyn  # noqa: E402
from iterative_learning_nmpc_tpu_torch.robots.go2 import go2_spec  # noqa: E402
from iterative_learning_nmpc_tpu_torch.robots.solo12 import solo12_spec  # noqa: E402
from iterative_learning_nmpc_tpu_torch.sim import device_sim  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for spec in (go2_spec(device=dev), solo12_spec(device=dev)):
        cp = device_sim.contact_params_for(spec, device=dev)
        x0, tl = dyn.settled_state(spec), spec.torque_limit
        for B in (1, 256):
            gen = torch.Generator().manual_seed(0)
            q = torch.as_tensor(np.tile(x0[:18], (B, 1)), device=dev)
            q[:, 6:] += (0.03 * torch.randn(B, 12, generator=gen)).to(dev)
            v, t = torch.zeros(B, 18, device=dev), torch.zeros(B, device=dev)
            target = q[:, 6:] + 0.05
            f = torch.zeros(B, 3, device=dev)
            f[:, 1] = 5.0

            def node(q, v, t, target):
                st = device_sim.SimState(q, v, t)
                for _ in range(40):
                    tau = torch.clamp(20.0 * (target - st.q[:, 6:]) - 1.5 * st.v[:, 6:], -tl, tl)
                    st = device_sim.step(spec, st, tau, cp, 1e-3)
                return tuple(st)

            def one(q, v, t, tau, f):
                return tuple(device_sim.step(spec, device_sim.SimState(q, v, t), tau, cp, 1e-3,
                                             f_ext=f))

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = node(q, v, t, target)
            torch.cuda.synchronize()
            eager = (time.perf_counter() - t0) / 40 * 1e3
            t0 = time.perf_counter()
            run = device_sim.graphed(node, q, v, t, target)
            torch.cuda.synchronize()
            capture = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in zip(run(q, v, t, target), ref))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                run(q, v, t, target)
            torch.cuda.synchronize()
            replay = (time.perf_counter() - t0) / 200 * 1e3
            tau = torch.zeros(B, 12, device=dev)
            ref1 = one(q, v, t, tau, f)
            run1 = device_sim.graphed(one, q, v, t, tau, f)
            out = run1(q, v, t, tau, f)
            same1 = all(torch.equal(a, b) for a, b in zip(out, ref1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                out = run1(out[0], out[1], out[2], tau, f)
                torch.cat([out[0], out[1]], -1).cpu()
            loop = (time.perf_counter() - t0) / 100 * 1e3
            print(f"{spec.name} B={B}: eager {eager:.3f} ms a step; 40-step graph: capture "
                  f"{capture:.2f} s, replay {replay:.4f} ms a step, bit-equal {same}; one-step "
                  f"graph with the state copied back {loop:.4f} ms a step, bit-equal {same1} "
                  f"({card})", flush=True)


if __name__ == "__main__":
    main()
