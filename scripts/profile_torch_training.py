#!/usr/bin/env python3
"""Where the time of the port's behaviour-cloning step goes, on one CUDA card.

    python3 scripts/profile_torch_training.py [--batch 1024 256] [--steps 50]

Runs the trainer's step (``learning.train.train_step``: forward, L1 loss,
backward, Adam) on the ``TrainConfig`` default net (47 -> 512x3 -> 12 with
BatchNorm, fp32, TF32 off) at each batch size, on seeded inputs, after a
warm-up: the ms a step between CUDA events over ``--steps`` steps, then the
same steps traced with ``torch.profiler`` (CPU + CUDA): the device's busy
time a step (the CUDA kernels' self time, user annotations left out), its
idle share, the kernel launches a step and the kernels that take the most device time. The last
line is one JSON object with those numbers and the card's name and power
limit. Exits non-zero without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SEED = 0


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1024, 256])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    from iterative_learning_nmpc_tpu_torch.learning.network import init_network
    from iterative_learning_nmpc_tpu_torch.learning.train import TrainConfig, train_step

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for B in args.batch:
        net = init_network(cfg.input_size, cfg.output_size, cfg.num_hidden_layer,
                           cfg.hidden_dim, cfg.batch_norm, cfg.dropout_rate,
                           generator=torch.Generator().manual_seed(SEED), device=dev)
        opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        x = torch.randn(args.steps, B, cfg.input_size, device=dev, generator=gen)
        y = 0.3 * torch.randn(args.steps, B, cfg.output_size, device=dev, generator=gen)
        losses = torch.empty(args.steps, device=dev)

        def steps():
            for i in range(args.steps):
                losses[i] = train_step(net, opt, x[i], y[i])

        steps()                                    # warm-up (cuBLAS handles, allocator)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        steps()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's kernels; the optimizer's user annotation also shows on
        # the device's timeline, spanning its kernels, and is left out
        annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in annotations]
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / args.steps
        n = sum(e.count for e in kern) / args.steps
        wall_ms = wall * 1e3 / args.steps
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
        results[B] = dict(ms_per_step=ms, rows_per_s=B / ms * 1e3, traced_wall_ms=wall_ms,
                          busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                          launches_per_step=n,
                          top=[(e.key[:60], e.self_device_time_total / 1e3 / args.steps,
                                e.count / args.steps) for e in top])
        r = results[B]
        print(f"[bc step] B={B}: {ms:.4f} ms a step (CUDA events over {args.steps} steps), "
              f"{r['rows_per_s']:.1f} rows/s; traced {wall_ms:.4f} ms a step, device busy "
              f"{busy:.4f} ms (idle {r['idle_share']:.3f}), {n:.1f} kernel launches a step; "
              "top: " + ", ".join(f"{k} {t:.4f} ms x{c:.0f}" for k, t, c in r["top"])
              + f" ({card})", flush=True)
    print(json.dumps({"card": card, "bc_step": results}))


if __name__ == "__main__":
    main()
