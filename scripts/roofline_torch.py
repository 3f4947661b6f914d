#!/usr/bin/env python3
"""Roofline of the port's two heaviest solver kernels on one CUDA card: how
far is each from the least time the card could take? The port of
scripts/roofline.py.

1. Measured ceilings: the fp32 FMA rate from the ``fma_chain`` probe
   (``ops/probes.py``, 8 independent chains per thread, 4 full waves of the
   132 SMs), and the HBM rate of ``x + 1.0`` over 1 GiB (a read and a write).
2. Kernel times at B=512, N=25 with CUDA events: lingram (kernel 2) on the
   flagship batch made as chip_smoke.py phase 4 makes it (15-iteration
   converged solve, x0 perturbed by N(0, 0.01^2), seed 0), and
   ``riccati_sweep`` (kernel 6, the counterpart of the
   ``riccati_pallas_batched`` that roofline.py times) on roofline.py's
   random SPD blocks (numpy ``RandomState(0)``, the same draws).
3. Bytes: exact, over the port's unpadded interfaces (the tensors each
   kernel's wrapper hands it, and its outputs; NU = 30).
4. FLOPs: the hand counts of the minimal work, ``algo_flops_lingram`` and
   ``algo_flops_riccati`` (copied into ``ops/probes.py`` with their
   derivations; the sweep's count without its rollout term).

Prints one JSON object shaped like ROOFLINE.json, with the card's name,
power limit, ``clocks.sm`` (idle, and sampled under the FMA probe's load,
with ``power.draw``) and ``clocks.max.sm`` (nvidia-smi), the host CPU model
and the date; writes it to a file only with ``--out``.

    python3 scripts/roofline_torch.py [--out FILE]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B, N = 512, 25
NX, NU = 36, 30


def smi(q: str = "name,power.limit,clocks.sm,clocks.max.sm") -> dict:
    vals = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={q}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    return dict(zip(q.split(","), (v.strip() for v in vals.split(","))))


def cpu_model() -> dict:
    """What the host says of its CPU: lscpu's model and speed fields."""
    keys = ("Model name", "Vendor ID", "CPU family", "Model", "CPU(s)", "CPU max MHz",
            "BogoMIPS")
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {"CPU(s)": str(os.cpu_count())}
    fields = dict(l.split(":", 1) for l in out.splitlines() if ":" in l)
    return {k: fields[k].strip() for k in keys if k in fields}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ceilings(dev):
    """(fp32 TFLOP/s, HBM GB/s, fma ms, hbm ms, nvidia-smi's clocks.sm and
    power.draw sampled while ~0.3 s of fma_chain runs) on the card."""
    import torch

    from iterative_learning_nmpc_tpu_torch.ops import probes
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    n = probes.FMA_N
    a = torch.full((n,), 0.999, device=dev)
    b = torch.full((n,), 1e-6, device=dev)
    t_fma = min(cuda_time_ms(lambda: probes.fma_chain(a, b, probes.FMA_ITERS, probes.FMA_NACC),
                             10) for _ in range(3))
    tf = probes.fma_chain_flops(n, probes.FMA_ITERS, probes.FMA_NACC) / (t_fma * 1e-3) / 1e12
    for _ in range(int(300 / t_fma)):                 # queue ~0.3 s, sample while it runs
        probes.fma_chain(a, b, probes.FMA_ITERS, probes.FMA_NACC)
    loaded = smi("clocks.sm,power.draw")
    torch.cuda.synchronize()
    x = torch.ones(256 * 1024 * 1024, device=dev)      # 1 GiB of fp32
    t_bw = min(cuda_time_ms(lambda: x + 1.0, 10) for _ in range(3))
    return tf, 2.0 * x.numel() * 4 / (t_bw * 1e-3) / 1e9, t_fma, t_bw, loaded


def lingram_case(dev):
    """(fn, interface bytes) of lingram at B x N on the flagship batch."""
    import torch

    from iterative_learning_nmpc_tpu_torch import flagship as F
    from iterative_learning_nmpc_tpu_torch.ops.layout import (
        node_params, robot_consts, weight_consts)
    from iterative_learning_nmpc_tpu_torch.ops.lingram import lingram

    solver, X, U, params = F.flagship(device=dev)
    conv = solver.solve(X, U, params, 15)
    Xb, Ub, pb = F.perturbed_batch(conv.X, conv.U, params, B, seed=0)
    pb = pb.replace(lam_eq=torch.zeros_like(pb.lam_eq),
                    lam_ineq=conv.lam_ineq.expand_as(pb.lam_ineq).contiguous())
    spec, w, inc = solver.spec, solver.weights, solver.opt.torque_limit_in_qp
    fn = lambda: lingram(spec, w, Xb, Ub, pb, inc)
    ins = (Xb[:, :-1], Ub, node_params(pb, N), robot_consts(spec), weight_consts(spec, w))
    return fn, nbytes(*ins, *fn()), float(solver.dt_nodes)


def riccati_case(dev, h):
    """(fn, interface bytes) of riccati_sweep at B x N on roofline.py's
    random SPD blocks."""
    import numpy as np
    import torch

    from iterative_learning_nmpc_tpu_torch.ops.riccati import riccati_sweep

    rng = np.random.RandomState(0)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    Jq = mk(B, N, 50, NX)
    Jr = mk(B, N, 50, NU)
    JqT = np.swapaxes(Jq, -1, -2)
    Q = JqT @ Jq + 1e-3 * np.eye(NX, dtype=np.float32)
    R = np.swapaxes(Jr, -1, -2) @ Jr + np.eye(NU, dtype=np.float32)
    M = 0.1 * (JqT @ Jr)
    qx, ru = mk(B, N, NX), mk(B, N, NU)
    PT = mk(B, 60, NX)
    P_N = np.swapaxes(PT, -1, -2) @ PT + np.eye(NX, dtype=np.float32)
    p_N = mk(B, NX)
    d = 0.01 * mk(B, N, NX)
    args = [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
            for a in (Q, R, M, qx, ru, P_N, p_N, d)]
    fn = lambda: riccati_sweep(h, 1e-6, *args)
    return fn, nbytes(*args, fn())


def roof(t_ms, bytes_io, flops, tf, bw) -> dict:
    gbs = bytes_io / (t_ms * 1e-3) / 1e9
    atf = flops / (t_ms * 1e-3) / 1e12
    return {
        "time_ms": t_ms,
        "hbm_bytes": bytes_io,
        "achieved_GBps": gbs,
        "pct_hbm_peak": 100 * gbs / bw,
        "algorithmic_flops": flops,
        "achieved_algo_TFLOPs": atf,
        "pct_fp32_peak": 100 * atf / tf,
        "bw_floor_ms": bytes_io / (bw * 1e9) * 1e3,
        "fp32_floor_ms": flops / (tf * 1e12) * 1e3,
        "bound_ms": max(bytes_io / (bw * 1e9), flops / (tf * 1e12)) * 1e3,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the roofline is measured only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from iterative_learning_nmpc_tpu_torch.ops import probes
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    dev = torch.device("cuda", 0)
    card = smi()
    print(f"{card['name']}, {card['power.limit']}", flush=True)
    tf, bw, t_fma, t_bw, loaded = ceilings(dev)
    print(f"measured fp32 FMA ceiling {tf:.3f} TFLOP/s ({t_fma:.4f} ms; clocks.sm "
          f"{loaded['clocks.sm']}, power.draw {loaded['power.draw']} under it), HBM {bw:.1f} "
          f"GB/s ({t_bw:.4f} ms for 2 GiB moved)", flush=True)
    lin, lin_bytes, h = lingram_case(dev)
    ric, ric_bytes = riccati_case(dev, h)
    t_lin = min(cuda_time_ms(lin, 20) for _ in range(3))
    t_ric = min(cuda_time_ms(ric, 20) for _ in range(3))
    out = {
        "what": ("roofline of lingram (kernel 2) and riccati_sweep (kernel 6) at B=512, N=25 "
                 "against the card's measured fp32 FMA and HBM ceilings; bytes over the port's "
                 "unpadded interfaces, flops from the hand counts of the minimal work"),
        "device": card["name"],
        "power_limit": card["power.limit"],
        "clocks_sm": card["clocks.sm"],
        "clocks_max_sm": card["clocks.max.sm"],
        "clocks_sm_under_fma": loaded["clocks.sm"],
        "power_draw_under_fma": loaded["power.draw"],
        "host_cpu": cpu_model(),
        "measured_fp32_TFLOPs": tf,
        "fma_probe": {"n": probes.FMA_N, "iters": probes.FMA_ITERS, "nacc": probes.FMA_NACC,
                      "ms": t_fma},
        "measured_hbm_GBps": bw,
        "lingram": roof(t_lin, lin_bytes, probes.algo_flops_lingram(B, N), tf, bw),
        "riccati_sweep": roof(t_ric, ric_bytes, probes.algo_flops_riccati(B, N, rollout=False),
                              tf, bw),
        "date": time.strftime("%Y-%m-%d"),
    }
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
