#!/usr/bin/env python3
"""The policy-inference + PD step three ways at datagen batch sizes, on one
CUDA card: the port of scripts/bench_policy_kernel.py.

  a) policy_pd: the fused fp32 kernel (csrc/policy_pd.cu), the reference's (a);
  b) policy_pd_bf16: the fused kernel with bf16 products on the tensor cores
     (csrc/policy_pd_bf16.cu), through make_fused_policy_pd(compute_dtype=
     torch.bfloat16);
  c) the batch-major fp32 addmm chain + PD on cuBLAS (policy_pd_plain), the
     reference's (c). The reference's (b), vmap(net.apply), has no
     counterpart: the port writes the batch dimension out, which is (c).

With the shipped policy's folded weights (assets/
policy_go2_trot_ondevice_dagger.pkl) and seeded normal inputs, it times each
with CUDA events and prints us per call and max|dtau| of (a) and (b) against
(c), with the card's name and power limit, and last one JSON line.

    python3 scripts/bench_policy_kernel_torch.py [--batch 512 4096] [--reps 50]
"""
import argparse
import json
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ARTIFACT = os.path.join(ROOT, "assets", "policy_go2_trot_ondevice_dagger.pkl")
KP, KD = 20.0, 1.5


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[512, 4096])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this bench runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from iterative_learning_nmpc_tpu_torch.ops.policy_pd import (
        fold_batchnorm, make_fused_policy_pd, policy_pd_plain)
    from iterative_learning_nmpc_tpu_torch.utils.profiling import cuda_time_ms

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    with open(ARTIFACT, "rb") as f:
        layers = fold_batchnorm(pickle.load(f)["variables"])
    fp32 = make_fused_policy_pd(layers, KP, KD, device=dev)
    bf16 = make_fused_policy_pd(layers, KP, KD, compute_dtype=torch.bfloat16, device=dev)
    dense = [(torch.as_tensor(W, device=dev), torch.as_tensor(b, device=dev)) for W, b in layers]
    chain = lambda x, qj, vj: policy_pd_plain(dense, KP, KD, x, qj, vj)
    rows = []
    for B in args.batch:
        gen = torch.Generator().manual_seed(B)
        x, qj, vj = (torch.randn(B, n, generator=gen).to(dev) for n in (47, 12, 12))
        ref = chain(x, qj, vj)[1]
        row = {"B": B}
        for name, fn in (("fp32_kernel", fp32), ("bf16_kernel", bf16), ("addmm_chain", chain)):
            row[f"{name}_us"] = cuda_time_ms(lambda: fn(x, qj, vj), args.reps) * 1e3
            row[f"{name}_max_dtau"] = float((fn(x, qj, vj)[1] - ref).abs().max())
        rows.append(row)
        print(f"B={B:5d}: fp32 kernel {row['fp32_kernel_us']:8.2f} us | bf16 kernel "
              f"{row['bf16_kernel_us']:8.2f} us | addmm chain {row['addmm_chain_us']:8.2f} us "
              f"| max|dtau| vs the chain: fp32 {row['fp32_kernel_max_dtau']:.2e}, bf16 "
              f"{row['bf16_kernel_max_dtau']:.2e}", flush=True)
    print(json.dumps({"card": card, "reps": args.reps, "rows": rows}))


if __name__ == "__main__":
    main()
